"""The model zoo on PyTorch: attention / Mamba / MoE decoder stacks, for
serving and training."""

from .transformer import (Transformer, active_params, count_params,
                          decode_step, forward, init_cache, init_params,
                          loss_fn, model_schema, prefill, reference_ranks)

__all__ = ["Transformer", "active_params", "count_params", "decode_step",
           "forward", "init_cache", "init_params", "loss_fn", "model_schema",
           "prefill", "reference_ranks"]
