"""Launch layer: the training CLI (``python -m repro_torch.launch.train``)."""
