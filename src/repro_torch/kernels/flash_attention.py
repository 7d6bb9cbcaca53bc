"""The flash-attention kernel: wrapper and launch counter.

``flash_attention_cuda`` runs GQA attention forward — causal or not, with
``q_offset`` and ``kv_len`` masking — in one launch of the hand-written
CUDA kernel ``csrc/flash_attention.cu`` (one CTA per query tile and head,
an online softmax in float32 across K/V tiles; see the source for the
design): bfloat16 inputs on the tensor cores (``wgmma`` on K/V tiles that
TMA loads), float32 inputs as IEEE FMAs.  It returns ``(o, lse)`` as
:func:`ref.flash_fwd_chunked` does, with ``lse`` laid out ``(B,Sq,KV,G)``,
and takes ragged ``Sq`` and ``Skv``.

The launch is the custom op ``repro_torch::flash_attention`` (its CUDA
implementation; its fake implementation gives the output shapes), so that
the cost model (``roofline.analyze_step``) meets the kernel as one op on
abstract ``meta`` tensors, with the cost of ``roofline.attn_cost``.

On CUDA tensors the wrapper launches the kernel or raises; on ``meta``
tensors it dispatches the op's fake implementation (no launch, no count);
on CPU tensors it runs the plain version :func:`ref.flash_fwd_chunked`,
which is also what the kernel is held to on the card.  Nothing falls back
to it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.cuda_lib import library
from . import ref

#: dtype flags of the launch function
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's path for each dtype (named in chip_smoke.py's record)
VARIANTS = {torch.float32: "ieee-fma", torch.bfloat16: "wgmma"}
#: widest head the kernel takes (its shared-memory tiles are sized by it)
MAX_HEAD_DIM = 256
#: bfloat16 heads must be a multiple of this: TMA moves rows of 16 bytes
BF16_HEAD_MULTIPLE = 8


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


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raises unless the kernel takes q ``(B,Sq,H,hd)`` and k, v
    ``(B,Skv,KV,hd)``: one dtype, float32 with ``hd <= 256`` or bfloat16
    with ``hd`` a multiple of 8 up to 256 and every tensor's data 16-byte
    aligned (the tensor-core path loads them by TMA)."""
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: unsupported dtype {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype} differ")
    b, _, h, hd = q.shape
    kvh = k.shape[2]
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd
            or h % kvh or not 0 < hd <= MAX_HEAD_DIM
            or (q.dtype == torch.bfloat16 and hd % BF16_HEAD_MULTIPLE)):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} not taken")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 inputs must start on a "
                         "16-byte boundary")


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                        device_types="cuda")
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, q_offset: int, kv_len: Optional[int]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel, counted in
    ``flash_attention_cuda.launches``: ``(o, lse)``, ``lse`` laid out
    ``(B,Sq,KV,G)``."""
    check_inputs(q, k, v)
    dev = check_cuda("flash_attention", (q, k, v), (q.dtype,) * 3)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kv_lim = skv if kv_len is None else max(0, min(int(kv_len), skv))
    o = torch.empty_like(q)
    lse = torch.empty((b, sq, kvh, h // kvh), dtype=torch.float32,
                      device=dev)
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
    return o, lse


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, q_offset, kv_len):
    # allocates what the CUDA body does (o and lse, nothing else): the cost
    # model's memory account reads these on ``meta``
    check_inputs(q, k, v)
    b, sq, h, _ = q.shape
    kvh = k.shape[2]
    return (torch.empty_like(q),
            q.new_empty((b, sq, kvh, h // kvh), dtype=torch.float32))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         kv_len: Optional[int] = None,
                         q_chunk: int = 512, kv_chunk: int = 512,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)`` of q ``(B,Sq,H,hd)`` over k, v ``(B,Skv,KV,hd)``.

    CUDA: one launch of the op ``repro_torch::flash_attention``, counted
    in ``flash_attention_cuda.launches``, of inputs that
    :func:`check_inputs` passes.  ``meta``: the op's output shapes.  CPU:
    :func:`ref.flash_fwd_chunked` with ``q_chunk`` and ``kv_chunk`` (which
    the kernel does not need)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return ref.flash_fwd_chunked(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)
    return torch.ops.repro_torch.flash_attention(
        q, k, v, bool(causal), int(q_offset),
        None if kv_len is None else int(kv_len))


#: kernel launches since the last reset (the op's CUDA implementation is
#: the only writer)
flash_attention_cuda.launches = 0
