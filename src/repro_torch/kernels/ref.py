"""Plain torch versions of the two sequence kernels (and the CPU path).

* :func:`attention_naive` — O(S²)-memory reference, small shapes only.
* :func:`flash_fwd_chunked` — chunked online-softmax attention returning
  ``(o, lse)``; the CPU path of the model and what the CUDA flash kernel
  is held to on the card.  :func:`flash_attention_ref` drops the ``lse``.
* :func:`selective_scan_ref` — sequential Mamba-1 selective scan.
* :func:`selective_scan_chunked` — chunked associative-scan formulation
  (the CPU path of the model), returning ``(y, h_final)``.

Each follows the reference's order of operations and its ``-inf`` guards
(``safe_m``, the ``isfinite`` masks, ``max(l, 1e-37)``), so the CPU tests
can hold them to the JAX package at its own tolerances.  The chunked
versions assert chunk divisibility as the reference does; only the CUDA
kernels take ragged shapes.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

NEG_INF = float("-inf")


def _gqa_fold(q: torch.Tensor, k: torch.Tensor) -> int:
    """(B,Sq,H,hd),(B,Skv,KV,hd) -> group count G with H = KV*G."""
    h, kv = q.shape[2], k.shape[2]
    if h % kv:
        raise ValueError(f"query heads {h} not a multiple of kv heads {kv}")
    return h // kv


def _mask(sq: int, skv: int, q_start: int, t_start: int, causal: bool,
          kv_len: Optional[int], device) -> torch.Tensor:
    qpos = q_start + torch.arange(sq, device=device)[:, None]
    tpos = t_start + torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= tpos <= qpos
    if kv_len is not None:
        mask &= tpos < kv_len
    return mask


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None) -> torch.Tensor:
    """Reference attention.  q:(B,Sq,H,hd) k,v:(B,Skv,KV,hd) -> (B,Sq,H,hd).

    ``q_offset``: absolute position of q[0] (decode: cache length so far).
    ``kv_len``: number of valid cache positions (rest masked).
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = _gqa_fold(q, k)
    qg = q.reshape(b, sq, kv, g, hd)
    # a host scalar: a device copy of it would synchronise the stream
    scores = torch.einsum("bqkgh,btkh->bkgqt", qg, k) / torch.sqrt(
        torch.tensor(hd, dtype=q.dtype))
    scores = scores.float()
    mask = _mask(sq, skv, q_offset, 0, causal, kv_len, q.device)
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqt,btkh->bqkgh", probs.to(v.dtype), v)
    return out.reshape(b, sq, h, hd)


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0, kv_len=None,
                        q_chunk: int = 512, kv_chunk: int = 512
                        ) -> torch.Tensor:
    o, _ = flash_fwd_chunked(q, k, v, causal=causal, q_offset=q_offset,
                             kv_len=kv_len, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    return o


def flash_fwd_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      kv_len: Optional[int] = None,
                      q_chunk: int = 512, kv_chunk: int = 512,
                      causal_skip: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax chunked attention; O(q_chunk·kv_chunk) live memory.
    Returns ``(o, lse)`` with ``lse:(B,Sq,KV,G)`` the row logsumexp
    (``-inf`` where a row has no valid key; its output is 0).

    ``causal_skip``: q block ``i`` scans only kv blocks ``0..i`` (causal
    self-attention with ``q_offset == 0``, no ``kv_len``, equal chunks);
    the skipped blocks are wholly masked, so the result is the same."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = _gqa_fold(q, k)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    assert sq % q_chunk == 0 and skv % kv_chunk == 0, (sq, q_chunk, skv,
                                                       kv_chunk)
    nq, nk = sq // q_chunk, skv // kv_chunk
    skip = (causal_skip and causal and kv_len is None and q_offset == 0
            and q_chunk == kv_chunk)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    qg = q.reshape(b, sq, kv, g, hd)
    outs: List[torch.Tensor] = []
    lses: List[torch.Tensor] = []
    for iq in range(nq):
        q_blk = qg[:, iq * q_chunk:(iq + 1) * q_chunk]
        m = torch.full((b, q_chunk, kv, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, q_chunk, kv, g), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((b, q_chunk, kv, g, hd), dtype=torch.float32,
                          device=q.device)
        for ik in range(iq + 1 if skip else nk):
            k_blk = k[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            v_blk = v[:, ik * kv_chunk:(ik + 1) * kv_chunk]
            s = torch.einsum("bqkgh,btkh->bqkgt", q_blk, k_blk).float() \
                * scale
            mask = _mask(q_chunk, kv_chunk, q_offset + iq * q_chunk,
                         ik * kv_chunk, causal, kv_len, q.device)
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # rows with no valid key yet keep m=-inf; guard the exp
            safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - safe_m[..., None])
            p = torch.where(torch.isfinite(s), p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bqkgt,btkh->bqkgh", p.to(v_blk.dtype), v_blk)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-37)).to(q.dtype))
        lses.append(torch.where(torch.isfinite(m),
                                m + torch.log(torch.clamp(l, min=1e-37)),
                                NEG_INF))
    out = torch.cat(outs, dim=1).reshape(b, sq, h, hd)
    return out, torch.cat(lses, dim=1)


# ---------------------------------------------------------------------------
# Mamba-1 selective scan
# ---------------------------------------------------------------------------

def _h_init(x: torch.Tensor, n: int, h0: Optional[torch.Tensor]
            ) -> torch.Tensor:
    if h0 is not None:
        return h0.float()
    return torch.zeros((x.shape[0], x.shape[2], n), dtype=torch.float32,
                       device=x.device)


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bmat: torch.Tensor, Cmat: torch.Tensor,
                       D: torch.Tensor, h0: Optional[torch.Tensor] = None,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential oracle.  x,dt:(B,S,di)  A:(di,N)  Bmat,Cmat:(B,S,N)  D:(di,)

    h_t = exp(dt_t·A)·h_{t-1} + (dt_t·x_t)·B_t ;  y_t = (h_t·C_t).sum + D·x_t
    Returns (y:(B,S,di), h_final:(B,di,N)).
    """
    h = _h_init(x, A.shape[1], h0)
    Af, Df = A.float(), D.float()
    ys = []
    for t in range(x.shape[1]):
        xt, dtt, bt, ct = x[:, t], dt[:, t], Bmat[:, t], Cmat[:, t]
        decay = torch.exp(dtt.float()[..., None] * Af[None])
        h = decay * h + (dtt * xt).float()[..., None] * bt.float()[:, None, :]
        ys.append((h * ct.float()[:, None, :]).sum(dim=-1) + Df * xt.float())
    y = torch.stack(ys, dim=1) if ys else torch.zeros_like(x, dtype=torch.float32)
    return y.to(x.dtype), h


Elems = List[torch.Tensor]


def associative_scan(combine: Callable[[Elems, Elems], Elems], elems: Elems
                     ) -> Elems:
    """Inclusive scan of ``elems`` along dim 1 with the recursion of
    ``jax.lax.associative_scan``: pairs combine, the odd positions scan
    recursively, the even ones combine with them; so every element is
    built by the same sequence of combines as in the reference."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = combine([e[:, 0:-1:2] for e in elems],
                      [e[:, 1::2] for e in elems])
    odd = associative_scan(combine, reduced)
    if n % 2 == 0:
        even = combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    out = []
    for ev, od in zip(even, odd):
        t = ev.new_empty((ev.shape[0], n) + tuple(ev.shape[2:]))
        t[:, 0::2] = ev
        t[:, 1::2] = od
        out.append(t)
    return out


def _combine(e1: Elems, e2: Elems) -> Elems:
    """Composition of ``h' = a·h + b``: (a2,b2)∘(a1,b1) = (a1·a2, a2·b1 + b2)."""
    a1, b1 = e1
    a2, b2 = e2
    return [a1 * a2, a2 * b1 + b2]


def selective_scan_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                           Bmat: torch.Tensor, Cmat: torch.Tensor,
                           D: torch.Tensor, h0: Optional[torch.Tensor] = None,
                           chunk: int = 256,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked associative-scan formulation (bounded memory, parallel
    in-chunk); returns ``(y, h_final)``."""
    b, s, di = x.shape
    chunk = min(chunk, s)
    assert s % chunk == 0, (s, chunk)
    h = _h_init(x, A.shape[1], h0)
    Af, Df = A.float(), D.float()
    ys = []
    for c0 in range(0, s, chunk):
        xc = x[:, c0:c0 + chunk].float()
        dtf = dt[:, c0:c0 + chunk].float()
        bc = Bmat[:, c0:c0 + chunk].float()
        cc = Cmat[:, c0:c0 + chunk].float()
        decay = torch.exp(dtf[..., None] * Af[None, None])         # (B,c,di,N)
        inc = (dtf * xc)[..., None] * bc[:, :, None, :]            # (B,c,di,N)
        a_cum, b_cum = associative_scan(_combine, [decay, inc])
        hs = a_cum * h[:, None] + b_cum
        ys.append((hs * cc[:, :, None, :]).sum(dim=-1) + Df * xc)
        h = hs[:, -1]
    return torch.cat(ys, dim=1).to(x.dtype), h
