"""Serving steps: batched prefill and one decode step.

On one device these are the model's own ``prefill`` / ``decode_step``; the
reference's sharded factories (``make_sharded_prefill`` / ``_decode``)
wait for the port of ``sharding.py``.
"""

from __future__ import annotations

from .configs.base import ModelConfig
from .models import transformer


def prefill_fn(params, batch, *, cfg: ModelConfig, max_len: int):
    return transformer.prefill(params, cfg, batch, max_len=max_len)


def decode_fn(params, caches, tokens, pos, *, cfg: ModelConfig):
    return transformer.decode_step(params, cfg, caches, tokens, pos)
