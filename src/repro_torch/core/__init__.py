"""Host-side elastic-instance state and the one-device HMM and server."""
