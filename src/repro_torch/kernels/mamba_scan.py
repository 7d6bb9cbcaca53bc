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

``selective_scan_bwd_cuda`` gives the scan's seven gradients ``(dx, ddt,
dA, dB, dC, dD, dh0)`` for output gradients ``dy`` and ``dh`` (either may
be None) in one call of the kernels ``scan_bwd_kernel`` (a checkpointed
forward walk, then the states recomputed a chunk at a time and walked
back) and ``scan_bwd_sums`` (the fixed-order sums across CTAs) of the same
source, bitwise repeatable (see the source), through the custom op
``repro_torch::selective_scan_bwd`` at the cost of
``roofline.scan_bwd_cost``.  It takes CUDA or ``meta`` tensors only: the
plain version, for CPU tensors and as the kernel's yardstick on the card,
is ``ops.scan_backward``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.cuda_lib import library
from . import ref
from .flash_attention import DTYPES, check_cuda

#: largest state width N the kernel keeps in registers
MAX_STATE = 16
#: the backward kernel's layout in ``csrc/mamba_scan.cu``: steps between
#: checkpoints (``kBwdK``), lanes of a CTA (``kThreads``) and of a channel
#: (``G``)
BWD_K, BWD_THREADS, BWD_LANES = 16, 256, 4


def scan_bwd_work_bytes(b: int, s: int, di: int, n: int) -> int:
    """Bytes of the scratch one backward launch takes besides its outputs,
    as the source's ``bwd_work`` carves them, each part rounded up to 256
    bytes: a float32 state every :data:`BWD_K` steps (``B x chunks x di x
    N``), the per-CTA dB / dC partials (``B x chunks x CTAs x BWD_K x 2 x
    MAX_STATE``) and the per-row dA / dD partials (``B x di x (N + 1)``).
    The launch refuses a buffer smaller than the source's count."""
    def up(nbytes):
        return -(-nbytes // 256) * 256

    chunks = -(-s // BWD_K)
    ctas = -(-di // (BWD_THREADS // BWD_LANES))
    return (up(4 * b * chunks * di * n)
            + up(4 * b * chunks * ctas * BWD_K * 2 * MAX_STATE)
            + up(4 * b * di * (n + 1)))


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


@torch.library.custom_op("repro_torch::selective_scan_bwd", mutates_args=(),
                        device_types="cuda")
def _scan_bwd_op(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bmat: torch.Tensor, Cmat: torch.Tensor, D: torch.Tensor,
                 h0: Optional[torch.Tensor], dy: Optional[torch.Tensor],
                 dh: Optional[torch.Tensor],
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """One call of the backward kernels, counted in
    ``selective_scan_bwd_cuda.launches``: ``(dx, ddt, dA, dB, dC, dD,
    dh0)``, dh0 whether or not ``h0`` was given; the scratch (checkpoints,
    partial sums) is one ``torch.empty`` of :func:`scan_bwd_work_bytes`,
    which the cost model counts beside the outputs."""
    if x.dtype not in DTYPES:
        raise TypeError(f"selective_scan_bwd: unsupported dtype {x.dtype}")
    given = [(t, dtype) for t, dtype in (
        (x, x.dtype), (dt, x.dtype), (Bmat, x.dtype), (Cmat, x.dtype),
        (dy, x.dtype), (A, torch.float32), (D, torch.float32),
        (h0, torch.float32), (dh, torch.float32)) if t is not None]
    dev = check_cuda("selective_scan_bwd", *zip(*given))
    _check_shapes(x, dt, A, Bmat, Cmat, D, h0)
    _check_grads(x, A, dy, dh)
    b, s, di = x.shape
    n = A.shape[1]
    dx, ddt = torch.empty_like(x), torch.empty_like(x)
    dB, dC = torch.empty_like(Bmat), torch.empty_like(Cmat)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    dh0 = torch.empty((b, di, n), dtype=torch.float32, device=dev)
    size = scan_bwd_work_bytes(b, s, di, n)
    work = torch.empty(size, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().mamba_scan_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
            Cmat.data_ptr(), D.data_ptr(),
            h0.data_ptr() if h0 is not None else None,
            dy.data_ptr() if dy is not None else None,
            dh.data_ptr() if dh is not None else None, dx.data_ptr(),
            ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dD.data_ptr(), dh0.data_ptr(), work.data_ptr(), size, b, s, di,
            n, DTYPES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"selective_scan_bwd: kernel launch failed with "
                           f"CUDA error {err}")
    selective_scan_bwd_cuda.launches += 1
    return dx, ddt, dA, dB, dC, dD, dh0


@_scan_bwd_op.register_fake
def _scan_bwd_fake(x, dt, A, Bmat, Cmat, D, h0, dy, dh):
    # the gradients, as the CUDA body allocates them (its scratch, made and
    # freed inside the op, is counted by the cost model from
    # scan_bwd_work_bytes: no dispatch mode sees what a fake allocates)
    _check_shapes(x, dt, A, Bmat, Cmat, D, h0)
    _check_grads(x, A, dy, dh)
    b, _, di = x.shape
    return (torch.empty_like(x), torch.empty_like(x), torch.empty_like(A),
            torch.empty_like(Bmat), torch.empty_like(Cmat),
            torch.empty_like(D),
            x.new_empty((b, di, A.shape[1]), dtype=torch.float32))


def _check_grads(x, A, dy, dh) -> None:
    b, _, di = x.shape
    if ((dy is not None and dy.shape != x.shape)
            or (dh is not None and dh.shape != (b, di, A.shape[1]))):
        raise ValueError(f"selective_scan_bwd: output gradients dy "
                         f"{None if dy is None else tuple(dy.shape)} dh "
                         f"{None if dh is None else tuple(dh.shape)} do not "
                         f"match x {tuple(x.shape)} A {tuple(A.shape)}")


def selective_scan_bwd_cuda(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, Bmat: torch.Tensor,
                            Cmat: torch.Tensor, D: torch.Tensor,
                            h0: Optional[torch.Tensor],
                            dy: Optional[torch.Tensor],
                            dh: Optional[torch.Tensor]) -> tuple:
    """``(dx, ddt, dA, dB, dC, dD, dh0)`` of :func:`selective_scan_cuda`'s
    ``(y, h_final)`` for output gradients ``dy`` (``(B,S,di)``, x's dtype)
    and ``dh`` (``(B,di,N)`` float32), either None for zero; dx, ddt, dB, dC
    in x's dtype, dA, dD and dh0 float32, dh0 None without ``h0``.  CUDA:
    one launch of the op ``repro_torch::selective_scan_bwd``, counted in
    ``selective_scan_bwd_cuda.launches``; ``N <= 16``, every tensor
    contiguous.  ``meta``: the op's output shapes."""
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"selective_scan_bwd: needs CUDA or meta tensors, "
                         f"got {x.device} (the plain version is "
                         f"ops.scan_backward)")
    *grads, dh0 = torch.ops.repro_torch.selective_scan_bwd(
        x, dt, A, Bmat, Cmat, D, h0, dy, dh)
    return (*grads, dh0 if h0 is not None else None)


#: backward kernel launches since the last reset (the op's CUDA
#: implementation is the only writer)
selective_scan_bwd_cuda.launches = 0
