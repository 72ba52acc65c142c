"""The port's entry points (``python -m repro_torch.launch.serve``)."""
