"""Deterministic, resumable, shard-aware data pipeline.

Batches are a pure function of (seed, step, shard_id, world) — resuming from
a checkpoint at step k regenerates exactly the stream a failed worker would
have seen, and elastic rescale (world change) re-partitions rows without
coordination.  The synthetic LM task mixes a Zipf unigram stream with
copy/induction spans so small models show real loss decrease in examples.

The reference's NumPy code, copied: its streams are bit-identical to
``src/repro/data/pipeline.py``'s.  ``batch_specs`` gives the shape and
dtype of every model input without allocating (the reference's
``ShapeDtypeStruct`` stand-ins), ``batch_pspecs`` their layouts on a mesh.
"""

from __future__ import annotations

import dataclasses
import queue as _queue
import threading
from typing import Any, Dict, Iterator, Tuple

import numpy as np

from ..configs.base import InputShape, ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    copy_frac: float = 0.5        # fraction of each row that is a copy span


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """Shape and dtype of one model input (no data)."""
    shape: Tuple[int, ...]
    dtype: np.dtype


def _row(rng: np.random.Generator, vocab: int, seq: int,
         copy_frac: float) -> np.ndarray:
    zipf = np.minimum(rng.zipf(1.3, size=seq + 1), vocab - 1)
    span = int(seq * copy_frac / 2)
    if span > 1:
        start = rng.integers(0, seq - 2 * span)
        zipf[start + span: start + 2 * span] = zipf[start: start + span]
    return zipf.astype(np.int32)


def make_batch(cfg: ModelConfig, dcfg: DataConfig, *, step: int,
               shard: int = 0, world: int = 1, batch: int = 8,
               seq: int = 128) -> Dict[str, Any]:
    """Batch for this worker's shard at this step (numpy, host-side)."""
    rng = np.random.default_rng(
        np.random.SeedSequence([dcfg.seed, step, shard, world]))
    v = cfg.vocab_size
    if cfg.input_mode == "audio_codes":
        k = cfg.n_codebooks
        rows = np.stack([[_row(rng, v, seq, dcfg.copy_frac)
                          for _ in range(k)] for _ in range(batch)])
        return {"codes": rows[:, :, :seq],
                "targets": rows[:, :, 1:seq + 1]}
    if cfg.input_mode == "vlm":
        p = cfg.vision_prefix
        st = seq - p
        rows = np.stack([_row(rng, v, st, dcfg.copy_frac)
                         for _ in range(batch)])
        emb = rng.normal(0, 1, size=(batch, p, cfg.d_model)).astype(np.float32)
        return {"tokens": rows[:, :st], "targets": rows[:, 1:st + 1],
                "vision_embeds": emb}
    rows = np.stack([_row(rng, v, seq, dcfg.copy_frac) for _ in range(batch)])
    return {"tokens": rows[:, :seq], "targets": rows[:, 1:seq + 1]}


def batch_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, ShapeDtype]:
    """Shape and dtype of every model input at ``shape``."""
    b, s = shape.global_batch, shape.seq_len
    i32 = np.dtype(np.int32)
    if shape.kind == "decode":
        if cfg.input_mode == "audio_codes":
            return {"codes": ShapeDtype((b, cfg.n_codebooks, 1), i32)}
        return {"tokens": ShapeDtype((b, 1), i32)}
    if cfg.input_mode == "audio_codes":
        return {"codes": ShapeDtype((b, cfg.n_codebooks, s), i32),
                "targets": ShapeDtype((b, cfg.n_codebooks, s), i32)}
    if cfg.input_mode == "vlm":
        st = s - cfg.vision_prefix
        return {"tokens": ShapeDtype((b, st), i32),
                "targets": ShapeDtype((b, st), i32),
                "vision_embeds": ShapeDtype(
                    (b, cfg.vision_prefix, cfg.d_model),
                    np.dtype(np.float32))}
    return {"tokens": ShapeDtype((b, s), i32),
            "targets": ShapeDtype((b, s), i32)}


def batch_pspecs(cfg: ModelConfig, shape: InputShape, rules) -> Dict[str, Any]:
    """PartitionSpecs for the batch dict (batch dim over data axes; the
    long-context decode keeps batch=1 replicated)."""
    from ..sharding import P
    long_ctx = shape.name == "long_500k"
    b_ax = None if long_ctx else (rules.batch if rules.batch else None)
    specs = batch_specs(cfg, shape)
    out = {}
    for k, v in specs.items():
        out[k] = P(b_ax, *([None] * (len(v.shape) - 1)))
    return out


class Prefetcher:
    """Background-thread prefetch (depth-k) over a host batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: _queue.Queue = _queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
