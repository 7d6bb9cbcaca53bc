from .pipeline import DataConfig, Prefetcher, ShapeDtype, batch_specs, make_batch

__all__ = ["DataConfig", "Prefetcher", "ShapeDtype", "batch_specs",
           "make_batch"]
