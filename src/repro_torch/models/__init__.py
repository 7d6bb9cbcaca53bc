"""The model zoo on PyTorch: attention / Mamba decoder stacks (serving path;
MoE layers and training wait for later slices)."""

from .transformer import (Transformer, count_params, decode_step, forward,
                          init_cache, init_params, model_schema, prefill)

__all__ = ["Transformer", "count_params", "decode_step", "forward",
           "init_cache", "init_params", "model_schema", "prefill"]
