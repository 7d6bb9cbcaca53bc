"""The model zoo on PyTorch: attention / Mamba / MoE decoder stacks, for
serving and training."""

from .transformer import (Transformer, abstract_cache, abstract_params,
                          active_params, cache_pspecs, count_params,
                          decode_step, forward, init_cache, init_params,
                          loss_fn, model_schema, param_pspecs, prefill,
                          reference_ranks)

__all__ = ["Transformer", "abstract_cache", "abstract_params",
           "active_params", "cache_pspecs", "count_params", "decode_step",
           "forward", "init_cache", "init_params", "loss_fn", "model_schema",
           "param_pspecs", "prefill", "reference_ranks"]
