"""The Mamba-1 selective-scan kernel: wrapper and launch counter.

``selective_scan_cuda`` runs ``h ← exp(dt·A)⊙h + (dt·x)⊗B``,
``y = Σ_N h·C + D·x`` over the whole sequence in one launch of the
hand-written CUDA kernel ``csrc/mamba_scan.cu`` (one thread per batch row
and channel, its state in registers; see the source for the design), and
returns ``(y, h_final)`` — the final state comes out of the same pass.
Any ``S`` works.

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors
it runs the plain version :func:`ref.selective_scan_chunked`.  The kernel
is held on the card to :func:`ref.selective_scan_ref`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.cuda_lib import library
from . import ref
from .flash_attention import DTYPES, check_cuda

#: largest state width N the kernel keeps in registers
MAX_STATE = 16


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                        Bmat: torch.Tensor, Cmat: torch.Tensor,
                        D: torch.Tensor, h0: Optional[torch.Tensor] = None,
                        chunk: int = 256,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, h_final)``: x, dt ``(B,S,di)`` and Bmat, Cmat ``(B,S,N)`` of one
    dtype (float32 or bfloat16); A ``(di,N)``, D ``(di,)`` and h0
    ``(B,di,N)`` float32.  CUDA: one launch, counted in
    ``selective_scan_cuda.launches``; ``N <= 16``.  CPU:
    :func:`ref.selective_scan_chunked` with ``chunk``."""
    if x.device.type == "cpu":
        return ref.selective_scan_chunked(x, dt, A, Bmat, Cmat, D, h0=h0,
                                          chunk=chunk)
    if x.dtype not in DTYPES:
        raise TypeError(f"selective_scan: unsupported dtype {x.dtype}")
    tensors = [x, dt, Bmat, Cmat, A, D] + ([h0] if h0 is not None else [])
    dev = check_cuda("selective_scan", tensors,
                     [x.dtype] * 4 + [torch.float32] * 3)
    b, s, di = x.shape
    n = A.shape[1]
    if (dt.shape != x.shape or A.shape != (di, n) or D.shape != (di,)
            or Bmat.shape != (b, s, n) or Cmat.shape != (b, s, n)
            or (h0 is not None and h0.shape != (b, di, n))
            or not 0 < n <= MAX_STATE):
        raise ValueError(f"selective_scan: shapes x {tuple(x.shape)} A "
                         f"{tuple(A.shape)} B {tuple(Bmat.shape)} not taken")
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


#: kernel launches since the last reset (the wrapper is the only writer)
selective_scan_cuda.launches = 0
