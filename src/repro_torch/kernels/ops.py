"""Dispatch for the model layer: the CUDA kernels on the card, the plain
torch versions elsewhere, with gradients.

``impl`` resolution, as in the reference (``"cuda"`` where it had
``"pallas"``):
  * "auto"     — the kernel for CUDA tensors, "chunked" for CPU tensors
  * "cuda"     — the kernel; raises on CPU tensors
  * "chunked"  — the chunked torch version (bounded memory)
  * "naive"    — the O(S²) / sequential torch version (small shapes, decode)

Self-attention (``kv_len is None``, ``q_offset == 0``) and the scan at
``"cuda"`` / ``"chunked"`` go through ``torch.autograd.Function``s, the
counterparts of the reference's ``_diff_flash``:

* attention: the forward is the kernel (or ``flash_fwd_chunked``), which
  also gives the row ``lse``; the backward is
  :func:`ref.flash_bwd_chunked` from ``(q, k, v, o, lse)``;
* the scan: the forward is the kernel (or ``selective_scan_chunked``); the
  backward recomputes :func:`ref.selective_scan_chunked` under autograd,
  chunk by chunk in reverse from the chunks' boundary states, so that one
  chunk's intermediates are live at a time.

Neither backward is a kernel: in the reference both are plain ``jnp``
(``flash_bwd_chunked``, and autodiff of the chunked scan).  There is one
device, so the reference's sharding hooks are not carried over.
"""

from __future__ import annotations

from typing import List, Optional

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


class FlashAttention(torch.autograd.Function):
    """Causal or full self-attention ``o`` of q ``(B,S,H,hd)`` over k, v
    ``(B,S,KV,hd)``, differentiable in all three."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, kernel: bool, q_chunk: int,
                kv_chunk: int, causal_skip: bool):
        if kernel:
            o, lse = flash_attention_cuda(q, k, v, causal=causal)
        else:
            skip = causal_skip and q.shape[1] // max(q_chunk, 1) <= 64
            o, lse = ref.flash_fwd_chunked(q, k, v, causal=causal,
                                           q_chunk=q_chunk,
                                           kv_chunk=kv_chunk,
                                           causal_skip=skip)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.chunks = causal, (q_chunk, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ref.flash_bwd_chunked(
            q, k, v, o, lse, do, causal=ctx.causal, q_chunk=ctx.chunks[0],
            kv_chunk=ctx.chunks[1])
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None, impl: str = "auto",
                    q_chunk: int = 512, kv_chunk: int = 512,
                    causal_skip: bool = False) -> torch.Tensor:
    impl = _resolve(impl, q, "flash_attention")
    if kv_len is None and q_offset == 0 and impl in ("cuda", "chunked"):
        return FlashAttention.apply(q, k, v, causal, impl == "cuda",
                                    q_chunk, kv_chunk, causal_skip)
    if impl == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal,
                                    q_offset=q_offset, kv_len=kv_len)[0]
    if impl == "chunked":
        return ref.flash_fwd_chunked(q, k, v, causal=causal,
                                     q_offset=q_offset, kv_len=kv_len,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)[0]
    if impl == "naive":
        return ref.attention_naive(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_len=kv_len)
    raise ValueError(f"unknown attention impl {impl!r}")


class SelectiveScan(torch.autograd.Function):
    """``(y, h_final)`` of the Mamba-1 scan, differentiable in x, dt, A,
    Bmat, Cmat, D and h0."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, D, h0, kernel: bool, chunk: int):
        if kernel:
            y, h = selective_scan_cuda(x, dt, A, Bmat, Cmat, D, h0=h0)
        else:
            y, h = ref.selective_scan_chunked(x, dt, A, Bmat, Cmat, D, h0=h0,
                                              chunk=chunk)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bmat, Cmat, D, h0)
        ctx.chunk = chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bmat, Cmat, D, h0 = ctx.saved_tensors
        return (*scan_backward(x, dt, A, Bmat, Cmat, D, h0, dy, dh,
                               ctx.chunk), None, None)


def scan_backward(x, dt, A, Bmat, Cmat, D, h0, dy, dh, chunk: int):
    """Gradients ``(dx, ddt, dA, dB, dC, dD, dh0)`` of
    :func:`ref.selective_scan_chunked` for output gradients ``dy`` and
    ``dh`` (either may be None): the chunks' boundary states from one pass
    without autograd, then each chunk recomputed under autograd in reverse,
    carrying the state's gradient to the chunk before."""
    b, s, di = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    starts = list(range(0, s, chunk))
    with torch.no_grad():
        bounds: List[Optional[torch.Tensor]] = [h0]
        h = h0
        for c0 in starts[:-1]:
            cut = slice(c0, c0 + chunk)
            _, h = ref.selective_scan_chunked(x[:, cut], dt[:, cut], A,
                                              Bmat[:, cut], Cmat[:, cut], D,
                                              h0=h, chunk=chunk)
            bounds.append(h)
    grads = {name: [] for name in ("x", "dt", "B", "C")}
    dA = torch.zeros_like(A)
    dD = torch.zeros_like(D)
    for c0, h_in in zip(reversed(starts), reversed(bounds)):
        cut = slice(c0, c0 + chunk)
        with torch.enable_grad():
            ins = [t[:, cut].detach().requires_grad_()
                   for t in (x, dt, Bmat, Cmat)]
            A_, D_ = A.detach().requires_grad_(), D.detach().requires_grad_()
            h_ = None if h_in is None else h_in.detach().requires_grad_()
            y_c, h_out = ref.selective_scan_chunked(ins[0], ins[1], A_,
                                                    ins[2], ins[3], D_,
                                                    h0=h_, chunk=chunk)
            outs, outs_g = [], []
            if dy is not None:
                outs.append(y_c)
                outs_g.append(dy[:, cut])
            if dh is not None:
                outs.append(h_out)
                outs_g.append(dh)
            wrt = ins + [A_, D_] + ([h_] if h_ is not None else [])
            got = torch.autograd.grad(outs, wrt, outs_g, allow_unused=True)
        got = [torch.zeros_like(w) if g is None else g
               for g, w in zip(got, wrt)]
        for name, g in zip(("x", "dt", "B", "C"), got[:4]):
            grads[name].append(g)
        dA = dA + got[4]
        dD = dD + got[5]
        dh = got[6] if h_ is not None else None
    cat = {name: torch.cat(gs[::-1], dim=1) for name, gs in grads.items()}
    dh0 = None if h0 is None else dh
    return cat["x"], cat["dt"], dA, cat["B"], cat["C"], dD, dh0


def selective_scan(x, dt, A, Bmat, Cmat, D, *, h0=None, impl: str = "auto",
                   chunk: int = 256):
    """Returns ``(y, h_final)``; the kernel emits ``h_final`` itself."""
    impl = _resolve(impl, x, "selective_scan")
    if impl in ("cuda", "chunked"):
        return SelectiveScan.apply(x, dt, A, Bmat, Cmat, D, h0,
                                   impl == "cuda", chunk)
    if impl == "naive":
        return ref.selective_scan_ref(x, dt, A, Bmat, Cmat, D, h0=h0)
    raise ValueError(f"unknown scan impl {impl!r}")
