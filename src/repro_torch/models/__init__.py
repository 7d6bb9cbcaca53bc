"""The model zoo on PyTorch: attention / Mamba / MoE decoder stacks (the
serving path; training waits for a later slice)."""

from .transformer import (Transformer, active_params, count_params,
                          decode_step, forward, init_cache, init_params,
                          model_schema, prefill)

__all__ = ["Transformer", "active_params", "count_params", "decode_step",
           "forward", "init_cache", "init_params", "model_schema", "prefill"]
