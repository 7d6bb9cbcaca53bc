"""The flash-attention kernel: wrapper and launch counter.

``flash_attention_cuda`` runs GQA attention forward — causal or not, with
``q_offset`` and ``kv_len`` masking — in one launch of the hand-written
CUDA kernel ``csrc/flash_attention.cu`` (one CTA per query tile and head,
an online softmax in float32 across K/V tiles; see the source for the
design).  It returns ``(o, lse)`` as :func:`ref.flash_fwd_chunked` does,
with ``lse`` laid out ``(B,Sq,KV,G)``, and takes ragged ``Sq`` and ``Skv``.

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors
it runs the plain version :func:`ref.flash_fwd_chunked`, which is also what
the kernel is held to on the card.  Nothing falls back to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.cuda_lib import library
from . import ref

#: dtype flags of the launch function
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: widest head the kernel takes (its shared-memory tiles are sized by it)
MAX_HEAD_DIM = 256


def check_cuda(name: str, tensors, dtypes) -> torch.device:
    """The device of ``tensors`` after checking that they are contiguous,
    on one CUDA device of compute capability 9.0, of the given dtypes."""
    dev = tensors[0].device
    for t, dtype in zip(tensors, dtypes):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: tensors on {t.device} and {dev}; "
                             "expected one CUDA device")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError(f"{name}: the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(dev)} is not")
    return dev


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_len: Optional[int] = None,
                         q_chunk: int = 512, kv_chunk: int = 512,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of q ``(B,Sq,H,hd)`` over k, v ``(B,Skv,KV,hd)``.

    CUDA: one launch, counted in ``flash_attention_cuda.launches``; float32
    or bfloat16 inputs, ``hd <= 256``.  CPU: :func:`ref.flash_fwd_chunked`
    with ``q_chunk`` and ``kv_chunk`` (which the kernel does not need)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.flash_fwd_chunked(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    dev = check_cuda("flash_attention", (q, k, v), (q.dtype,) * 3)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or h % kvh or hd > MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} not taken")
    kv_lim = skv if kv_len is None else max(0, min(int(kv_len), skv))
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, sq, skv, h, kvh, hd, int(q_offset), kv_lim,
            int(causal), DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return o, lse.view(b, sq, kvh, h // kvh)


#: kernel launches since the last reset (the wrapper is the only writer)
flash_attention_cuda.launches = 0
