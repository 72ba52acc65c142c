"""Logical devices, the sharded leaf and the parallel context."""
