"""Entry points: the serving loop (``python -m repro_torch.launch.serve``)."""
