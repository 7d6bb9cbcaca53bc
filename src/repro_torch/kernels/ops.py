"""Dispatch for the model layer: the CUDA kernels on the card, the plain
torch versions elsewhere.

``impl`` resolution, as in the reference (``"cuda"`` where it had
``"pallas"``):
  * "auto"     — the kernel for CUDA tensors, "chunked" for CPU tensors
  * "cuda"     — the kernel; raises on CPU tensors
  * "chunked"  — the chunked torch version (bounded memory)
  * "naive"    — the O(S²) / sequential torch version (small shapes, decode)

The forward pass only: serving needs no gradient (the recompute backward
comes with training), and there is one device, so the reference's
sharding hooks are not carried over.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .flash_attention import flash_attention_cuda
from .mamba_scan import selective_scan_cuda


def _resolve(impl: str, t: torch.Tensor, what: str) -> str:
    if impl == "auto":
        return "cuda" if t.device.type == "cuda" else "chunked"
    if impl == "cuda" and t.device.type != "cuda":
        raise ValueError(f"{what}: impl='cuda' needs CUDA tensors, got "
                         f"{t.device}")
    return impl


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None, impl: str = "auto",
                    q_chunk: int = 512, kv_chunk: int = 512,
                    causal_skip: bool = False) -> torch.Tensor:
    impl = _resolve(impl, q, "flash_attention")
    if impl == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len)[0]
    if impl == "chunked":
        qc = min(q_chunk, q.shape[1])
        skip = (causal_skip and kv_len is None and q_offset == 0
                and q.shape[1] // max(qc, 1) <= 64)
        return ref.flash_fwd_chunked(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk,
                                     causal_skip=skip)[0]
    if impl == "naive":
        return ref.attention_naive(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    raise ValueError(f"unknown attention impl {impl!r}")


def selective_scan(x, dt, A, Bmat, Cmat, D, *, h0=None, impl: str = "auto",
                   chunk: int = 256):
    """Returns ``(y, h_final)``; the kernel emits ``h_final`` itself."""
    impl = _resolve(impl, x, "selective_scan")
    if impl == "cuda":
        return selective_scan_cuda(x, dt, A, Bmat, Cmat, D, h0=h0)
    if impl == "chunked":
        return ref.selective_scan_chunked(x, dt, A, Bmat, Cmat, D, h0=h0,
                                          chunk=chunk)
    if impl == "naive":
        return ref.selective_scan_ref(x, dt, A, Bmat, Cmat, D, h0=h0)
    raise ValueError(f"unknown scan impl {impl!r}")
