"""Entry points: the serving loop (``python -m repro_torch.launch.serve``)
and the elastic spot trainer (``python -m repro_torch.launch.train``)."""
