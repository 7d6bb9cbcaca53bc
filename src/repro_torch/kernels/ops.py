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
  backward is the kernel's backward (``selective_scan_bwd_cuda``) after the
  kernel, and :func:`scan_backward` after the chunked version: it
  recomputes :func:`ref.selective_scan_chunked` under autograd, chunk by
  chunk in reverse from the chunks' boundary states, so that one chunk's
  intermediates are live at a time.

In the reference both backwards are plain ``jnp`` (``flash_bwd_chunked``,
and autodiff of the chunked scan); the attention's stays plain here, the
scan's is a kernel beyond the port.

On an active mesh (``sharding.mesh_context``) the reference's sharding
hooks apply: self-attention's q, k, v are first laid out for the mesh's
attention mode (:func:`_constrain_qkv`: "ulysses" shards the batch over
every mesh axis, "cp" the q sequence over the model axis), its output
laid back (:func:`_constrain_out`), and the chunk of q is clamped to one
sequence shard under "cp".  A DTensor cannot hand its data to a kernel, so
on DTensors each function runs through ``local_map`` on a layout where it
is device-local (:func:`_local_layout`): a mesh dim that splits the batch,
or the heads (attention; both head counts divisible) / the channels (the
scan), keeps that split, and any other split is gathered first — so no
sharding is dropped, and the kernel (or plain version) sees one device's
tensors.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from .. import sharding
from . import ref
from .flash_attention import flash_attention_cuda
from .mamba_scan import selective_scan_bwd_cuda, selective_scan_cuda


def _resolve(impl: str, t: torch.Tensor, what: str) -> str:
    """``"auto"``: the kernel for CUDA tensors and for ``meta`` tensors (so
    that the cost model counts the op the card runs), the chunked version
    for CPU tensors."""
    if impl == "auto":
        return "cuda" if t.device.type in ("cuda", "meta") else "chunked"
    if impl == "cuda" and t.device.type not in ("cuda", "meta"):
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


def _local_layout(x, split_dims, each):
    """Placements, on ``x``'s mesh, under which a function of ``x`` and its
    companions is device-local: per mesh dim, ``each[d]`` (one placement
    per argument) where ``x`` is ``Shard(d)`` for ``d`` in ``split_dims``
    and every argument's split divides, else ``Replicate()`` for all."""
    mesh = x.device_mesh
    n_args = len(next(iter(each.values()))[0])
    layout = [[] for _ in range(n_args)]
    for m, p in enumerate(x.placements):
        choice = None
        if isinstance(p, Shard) and p.dim in split_dims:
            pl, sizes = each[p.dim]
            if all(s % mesh.size(m) == 0 for s in sizes):
                choice = pl
        for i in range(n_args):
            layout[i].append(choice[i] if choice else Replicate())
    return layout


def _constrain_qkv(q, k, v):
    """Apply the active attention parallelism mode (sharding.flash_mode)."""
    mode = sharding.flash_mode(q.shape[0], q.shape[1])
    if mode == "ulysses":
        spec = sharding.ulysses_spec(4)
        return (sharding.constrain(q, spec), sharding.constrain(k, spec),
                sharding.constrain(v, spec), mode)
    if mode == "cp":
        return (sharding.constrain(q, sharding.cp_q_spec(4)),
                sharding.constrain(k, sharding.cp_kv_spec(4)),
                sharding.constrain(v, sharding.cp_kv_spec(4)), mode)
    return q, k, v, mode


def _constrain_out(o, mode):
    if mode == "ulysses":
        return sharding.constrain(o, sharding.ulysses_spec(4))
    if mode == "cp":
        return sharding.constrain(o, sharding.cp_q_spec(4))
    return o


def _cp_chunk(q, q_chunk: int) -> int:
    """Context parallelism needs q chunks no larger than one seq shard."""
    if sharding.flash_mode(q.shape[0], q.shape[1]) == "cp":
        ctx = sharding.active()
        msize = sharding.mesh_sizes(ctx[0])[ctx[1].model]
        return min(q_chunk, max(q.shape[1] // msize, 1))
    return q_chunk


def _attention_local_map(q, k, v, **kw):
    """:func:`flash_attention` of DTensors, device-local through
    ``local_map`` (batch or head splits kept, any other gathered)."""
    b, h, kvh = q.shape[0], q.shape[2], k.shape[2]
    q_pl, k_pl, v_pl = _local_layout(q, (0, 2), {
        0: ((Shard(0),) * 3, (b,)),
        2: ((Shard(2),) * 3, (h, kvh))})
    fn = local_map(lambda a, c, d: flash_attention(a, c, d, **kw),
                   out_placements=q_pl, in_placements=(q_pl, k_pl, v_pl),
                   redistribute_inputs=True)
    return fn(q, k, v)


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                    kv_len: Optional[int] = None, impl: str = "auto",
                    q_chunk: int = 512, kv_chunk: int = 512,
                    causal_skip: bool = False) -> torch.Tensor:
    self_attn = kv_len is None and q_offset == 0
    if self_attn:
        q, k, v, mode = _constrain_qkv(q, k, v)
        q_chunk = _cp_chunk(q, q_chunk)
    if isinstance(q, DTensor):
        o = _attention_local_map(
            q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len,
            impl=impl, q_chunk=q_chunk, kv_chunk=kv_chunk,
            causal_skip=causal_skip)
        return _constrain_out(o, mode) if self_attn else o
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
        ctx.kernel, ctx.chunk = kernel, chunk
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bmat, Cmat, D, h0 = ctx.saved_tensors
        if ctx.kernel:
            grads = selective_scan_bwd_cuda(
                x, dt, A, Bmat, Cmat, D, h0,
                None if dy is None else dy.contiguous(),
                None if dh is None else dh.contiguous())
        else:
            grads = scan_backward(x, dt, A, Bmat, Cmat, D, h0, dy, dh,
                                  ctx.chunk)
        return (*grads, None, None)


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


def _scan_local_map(x, dt, A, Bmat, Cmat, D, h0, **kw):
    """:func:`selective_scan` of DTensors, device-local through
    ``local_map`` (batch or channel splits kept, any other gathered)."""
    b, di = x.shape[0], x.shape[2]
    r = Replicate()
    pls = _local_layout(x, (0, 2), {
        0: ((Shard(0), Shard(0), r, Shard(0), Shard(0), r, Shard(0)), (b,)),
        2: ((Shard(2), Shard(2), Shard(0), r, r, Shard(0), Shard(1)),
            (di,))})
    args = [x, dt, A, Bmat, Cmat, D, h0]
    keep = [i for i, a in enumerate(args) if a is not None]

    def local(*ts):
        full = [None] * len(args)
        for i, t in zip(keep, ts):
            full[i] = t
        return selective_scan(*full[:6], h0=full[6], **kw)

    fn = local_map(local, out_placements=(pls[0], pls[6]),
                   in_placements=tuple(pls[i] for i in keep),
                   redistribute_inputs=True)
    return fn(*[args[i] for i in keep])


def selective_scan(x, dt, A, Bmat, Cmat, D, *, h0=None, impl: str = "auto",
                   chunk: int = 256):
    """Returns ``(y, h_final)``; the kernel emits ``h_final`` itself."""
    if isinstance(x, DTensor):
        return _scan_local_map(x, dt, A, Bmat, Cmat, D, h0, impl=impl,
                               chunk=chunk)
    impl = _resolve(impl, x, "selective_scan")
    if impl in ("cuda", "chunked"):
        return SelectiveScan.apply(x, dt, A, Bmat, Cmat, D, h0,
                                   impl == "cuda", chunk)
    if impl == "naive":
        return ref.selective_scan_ref(x, dt, A, Bmat, Cmat, D, h0=h0)
    raise ValueError(f"unknown scan impl {impl!r}")
