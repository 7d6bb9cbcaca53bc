"""The pool-scoring kernel: wrapper and plain version.

``score`` computes the fused plane's speculative ``e_total`` of each
decision's counts — ``(sp / sc) * (req / sq)`` over ``sp = Σ c·perf``,
``sc = Σ c·price``, ``sq = Σ c·pods`` over the items the pool uses, or 0
when the pool falls short of the demand (NaN where a used price is NaN, as
the host's ``e_total``) — in one launch of the hand-written CUDA kernel
``csrc/score.cu`` (one CTA per decision).  The sums run in a fixed order
(a strided partial sum per thread of 256, then a pairwise fold) that
:func:`score_plain` repeats op for op, so the two are bitwise equal.  That order is not the
host's ``counts @ perf``: the score only steers the golden bracket on the
card, and the host rescores every pool exactly.

The CTA's work is ``score_block`` of ``csrc/score.cuh``, which the golden
rows of ``csrc/fused_rows.cu`` also run in their own tail
(:func:`~repro_torch.core.fused_rows.fused_rows` with ``score_req``): the
fused plane's golden loop launches no ``score`` of its own.

On a CUDA tensor the wrapper launches the kernel or raises; on a CPU tensor
it runs :func:`score_plain`.
"""

from __future__ import annotations

import torch

from .cuda_lib import library

#: threads of the kernel's CTA: the width of the partial-sum stage
THREADS = 256


def _check(name, t, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise TypeError(f"score: {name} must be {dtype} of shape {shape}, "
                        f"got {t.dtype} {tuple(t.shape)}")
    if t.device != dev or not t.is_contiguous():
        raise ValueError(f"score: {name} must be contiguous on {dev}")


def score(counts: torch.Tensor, perf: torch.Tensor, price: torch.Tensor,
          pods: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """Speculative ``e_total`` per decision, ``(D,)`` float64: ``counts``
    ``(D, N)`` int64; ``perf``, ``price``, ``pods`` ``(N,)`` float64;
    ``req`` ``(D,)`` float64.  CUDA: one launch, counted in
    ``score.launches``.  CPU: :func:`score_plain`."""
    dev = counts.device
    if dev.type == "cpu":
        return score_plain(counts, perf, price, pods, req)
    if dev.type != "cuda":
        raise ValueError(f"score: tensors on {dev}; expected CUDA or CPU")
    D, N = counts.shape
    _check("counts", counts, torch.int64, (D, N), dev)
    for name, t in (("perf", perf), ("price", price), ("pods", pods)):
        _check(name, t, torch.float64, (N,), dev)
    _check("req", req, torch.float64, (D,), dev)
    out = torch.empty(D, dtype=torch.float64, device=dev)
    if D == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().score_launch(
            counts.data_ptr(), perf.data_ptr(), price.data_ptr(),
            pods.data_ptr(), req.data_ptr(), out.data_ptr(), D, N, stream)
    if err != 0:
        raise RuntimeError(f"score: kernel launch failed with CUDA error "
                           f"{err}")
    score.launches += 1
    return out


#: kernel launches since the last reset (the wrapper is the only writer)
score.launches = 0


def _fixed_order_sum(prod: torch.Tensor) -> torch.Tensor:
    """The kernel's sum over the last axis of ``(D, N)``: column ``k`` goes
    to partial ``k % THREADS`` (left to right, zero-padded), then the
    partials fold pairwise ``p[t] += p[t + s]``, ``s = THREADS/2 .. 1``."""
    D, N = prod.shape
    steps = -(-N // THREADS)
    padded = torch.zeros((D, steps * THREADS), dtype=prod.dtype,
                         device=prod.device)
    padded[:, :N] = prod
    padded = padded.view(D, steps, THREADS)
    part = torch.zeros((D, THREADS), dtype=prod.dtype, device=prod.device)
    for k in range(steps):
        part = part + padded[:, k]
    s = THREADS // 2
    while s >= 1:
        part = part[:, :s] + part[:, s:2 * s]
        s //= 2
    return part[:, 0]


def score_plain(counts: torch.Tensor, perf: torch.Tensor, price: torch.Tensor,
                pods: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """The kernel's function in torch ops on the inputs' device, in the
    kernel's summation order (each product its own op: rounded before its
    add)."""
    c = counts.to(torch.float64)
    used = c != 0.0                  # the host sums only the chosen items

    def term(x):
        return torch.where(used, c * x, torch.zeros_like(c))

    sp = _fixed_order_sum(term(perf))
    sc = _fixed_order_sum(term(price))
    sq = _fixed_order_sum(term(pods))
    ok = (sq >= req) & ~(sc <= 0.0) & (sq > 0.0)
    e = (sp / sc) * (req / sq)
    return torch.where(ok, e, torch.zeros_like(e))
