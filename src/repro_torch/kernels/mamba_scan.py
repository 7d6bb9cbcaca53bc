"""The Mamba-1 selective-scan kernel: wrapper and launch counter.

``selective_scan_cuda`` runs ``h ← exp(dt·A)⊙h + (dt·x)⊗B``,
``y = Σ_N h·C + D·x`` over the whole sequence in one launch of the
hand-written CUDA kernel ``csrc/mamba_scan.cu`` (a group of four lanes
per batch row and channel, its states spread over their registers,
chunks of the sequence staged by ``cp.async``; see the source for the
design), and returns ``(y, h_final)`` — the final state comes out of the
same pass.  Any ``S`` works.

The launch is the custom op ``repro_torch::selective_scan`` (its CUDA
implementation; its fake implementation gives the output shapes), so that
the cost model (``roofline.analyze_step``) meets the kernel as one op on
abstract ``meta`` tensors, with the cost of ``roofline.scan_cost``.

On CUDA tensors the wrapper launches the kernel or raises; on ``meta``
tensors it dispatches the op's fake implementation; on CPU tensors it runs
the plain version :func:`ref.selective_scan_chunked`.  The kernel is held
on the card to :func:`ref.selective_scan_ref`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.cuda_lib import library
from . import ref
from .flash_attention import DTYPES, check_cuda

#: largest state width N the kernel keeps in registers
MAX_STATE = 16


@torch.library.custom_op("repro_torch::selective_scan", mutates_args=(),
                        device_types="cuda")
def _scan_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor,
             h0: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel, counted in
    ``selective_scan_cuda.launches``: ``(y, h_final)``."""
    if x.dtype not in DTYPES:
        raise TypeError(f"selective_scan: unsupported dtype {x.dtype}")
    tensors = [x, dt, Bmat, Cmat, A, D] + ([h0] if h0 is not None else [])
    dev = check_cuda("selective_scan", tensors,
                     [x.dtype] * 4 + [torch.float32] * 3)
    _check_shapes(x, dt, A, Bmat, Cmat, D, h0)
    b, s, di = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    h = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().mamba_scan_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), D.data_ptr(),
            h0.data_ptr() if h0 is not None else None, y.data_ptr(),
            h.data_ptr(), b, s, di, n, DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan: kernel launch failed with CUDA "
                           f"error {err}")
    selective_scan_cuda.launches += 1
    return y, h


@_scan_op.register_fake
def _scan_fake(x, dt, A, Bmat, Cmat, D, h0):
    # allocates what the CUDA body does (y and h_final, nothing else): the
    # cost model's memory account reads these on ``meta``
    _check_shapes(x, dt, A, Bmat, Cmat, D, h0)
    b, _, di = x.shape
    return (torch.empty_like(x),
            x.new_empty((b, di, A.shape[1]), dtype=torch.float32))


def _check_shapes(x, dt, A, Bmat, Cmat, D, h0) -> None:
    b, s, di = x.shape
    n = A.shape[1]
    if (dt.shape != x.shape or A.shape != (di, n) or D.shape != (di,)
            or Bmat.shape != (b, s, n) or Cmat.shape != (b, s, n)
            or (h0 is not None and h0.shape != (b, di, n))
            or not 0 < n <= MAX_STATE):
        raise ValueError(f"selective_scan: shapes x {tuple(x.shape)} A "
                         f"{tuple(A.shape)} B {tuple(Bmat.shape)} not taken")


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        D: torch.Tensor, h0: Optional[torch.Tensor] = None,
                        chunk: int = 256,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_final)``: x, dt ``(B,S,di)`` and Bmat, Cmat ``(B,S,N)`` of one
    dtype (float32 or bfloat16); A ``(di,N)``, D ``(di,)`` and h0
    ``(B,di,N)`` float32.  CUDA: one launch of the op
    ``repro_torch::selective_scan``, counted in
    ``selective_scan_cuda.launches``; ``N <= 16``.  ``meta``: the op's
    output shapes.  CPU: :func:`ref.selective_scan_chunked` with
    ``chunk``."""
    if x.device.type == "cpu":
        return ref.selective_scan_chunked(x, dt, A, Bmat, Cmat, D, h0=h0,
                                          chunk=chunk)
    return torch.ops.repro_torch.selective_scan(x, dt, A, Bmat, Cmat, D, h0)


#: kernel launches since the last reset (the op's CUDA implementation is
#: the only writer)
selective_scan_cuda.launches = 0
