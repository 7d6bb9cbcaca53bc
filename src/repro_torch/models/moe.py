"""Token-choice MoE with capacity-grouped expert matmuls.

Dispatch is sort-based (no (T,E,C) one-hot): within each *group* (one
batch row) tokens are ranked per expert by a stable sort and dropped
beyond capacity C = ceil(S·k/E·cf) — the dropping formulation of the
reference's ``moe_apply`` (its path without ``shard_map``).  Expert
buffers are laid out (B, E, C, d) with one pad row per group for the
dropped choices; the SwiGLU experts run as batched products over E.

Two places where PyTorch and JAX disagree by default are pinned to the
reference's rule:

* **Top-k ties.** ``jax.lax.top_k`` puts the lower expert index first
  among equal probabilities; ``torch.topk`` promises no order.  The top k
  here come from a stable descending sort, which keeps index order among
  ties on either device.
* **The combine.** The reference scatter-adds a token's k choices; here
  they are summed in choice order, one add at a time (no atomics, so the
  sum is the same from run to run on the card).

Aux: the Switch load-balance loss ``E·Σ_e me_e·ce_e`` (the model averages
it over its MoE layers).

On an active mesh the expert buffers are constrained to
``sharding.moe_group_spec()`` (groups on the data axes, experts on the
model axis), and with ``rules.ep_shard_map`` (experts divisible by the
model axis) the experts run through :func:`_moe_local_map`, the
counterpart of the reference's ``_moe_shard_map``: every device takes its
data shard's rows against its model shard's experts, and one all-reduce
over the model axis a layer combines the partial outputs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import sharding
from ..configs.base import ModelConfig
from .layers import ParamDef, Params


def moe_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    wscale = 0.02 / (2 * cfg.n_layers) ** 0.5
    s = {
        "router": ParamDef((d, e), ("embed", None)),
        "wg": ParamDef((e, d, fe), ("experts", "expert_in", "expert_ff")),
        "wu": ParamDef((e, d, fe), ("experts", "expert_in", "expert_ff")),
        "wd": ParamDef((e, fe, d), ("experts", "expert_ff", "expert_in"),
                       ("normal", wscale)),
    }
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        s["shared_wg"] = ParamDef((d, fs), ("embed", "ff"))
        s["shared_wu"] = ParamDef((d, fs), ("embed", "ff"))
        s["shared_wd"] = ParamDef((fs, d), ("ff", "embed"), ("normal", wscale))
    return s


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Expert slots per group: the reference's expression, float floor
    division included."""
    c = -(-tokens_per_group * cfg.n_experts_active * cfg.capacity_factor
          // cfg.n_experts)            # ceil
    return max(int(c), 1)


def route(x: torch.Tensor, router: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities ``(B, S, E)`` float32 and the top ``k`` of each
    token: renormalised gates ``(B, S, k)`` and expert ids ``(B, S, k)``
    int64, ties to the lower id."""
    logits = (x @ router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, idx


def switch_aux(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``E · Σ_e mean_prob_e · fraction_e`` (float32 scalar)."""
    e = probs.shape[-1]
    me = probs.mean(dim=(0, 1))
    flat = idx.reshape(-1)
    # counts of whole numbers: exact in any order of the adds (and shaped
    # by ``e`` alone, unlike bincount, so abstract tensors count it too)
    ce = torch.zeros(e, dtype=torch.float32, device=idx.device).index_add(
        0, flat, torch.ones(flat.shape, dtype=torch.float32,
                            device=idx.device)) / idx.numel()
    return e * torch.sum(me * ce)


def dispatch(idx: torch.Tensor, n_experts: int, cap: int, first: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per group, the slot of each (token, choice) in the flattened
    ``(E·C + 1)``-row buffer, all ``(B, S·k)`` int64: ``order`` (the
    choices in stable expert order) with ``slot`` (each one's slot in that
    order), and ``inv`` (each choice's slot in choice order).  A choice
    ranked at or past ``cap`` in its expert is dropped to ``E·C``, the pad
    row.  Only experts ``first .. first + n_experts`` have slots (one
    device's share under expert parallelism); a choice of another expert
    goes to the pad row too, and ranks stay those of the whole group."""
    b, s, k = idx.shape
    flat_e = idx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    local = torch.gather(flat_e, 1, order) - first
    experts = torch.arange(n_experts, device=idx.device).expand(b, -1)
    starts = torch.searchsorted(local, experts.contiguous(), side="left")
    ours = (local >= 0) & (local < n_experts)
    rank = (torch.arange(s * k, device=idx.device)
            - torch.gather(starts, 1, local.clamp(0, n_experts - 1)))
    slot = torch.where(ours & (rank < cap), local * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    inv = torch.empty_like(slot).scatter_(1, order, slot)
    return order, slot, inv


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(B, S, d)`` -> ``(out, aux)``; the B rows are the dispatch
    groups.  ``p`` holds the schema's leaves by name."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    c = capacity(cfg, s)
    dt = x.dtype

    probs, gates, idx = route(x, p["router"], k)
    aux = switch_aux(probs, idx)

    ctx = sharding.active()
    if (ctx is not None and ctx[1].ep_shard_map and cfg.expert_parallel
            and ctx[1].model is not None and _is_dtensor(x)
            and e % sharding.mesh_sizes(ctx[0])[ctx[1].model] == 0):
        y = _moe_local_map(p, x, idx, gates, cfg, c)
        return _shared(p, x, y, cfg), aux

    # ---- dispatch (per group), experts, combine (per group) ----
    bufs, inv = _by_groups(_route, x, (x, idx), 2, cap=c, k=k, n=e)
    bufs = sharding.constrain(bufs, sharding.moe_group_spec())   # (B,E,C,d)
    out_buf = _experts(bufs, p["wg"], p["wu"], p["wd"])
    out_buf = sharding.constrain(out_buf, sharding.moe_group_spec())
    y = _by_groups(_combine, x, (out_buf, inv, gates), 1, k=k)
    return _shared(p, x, y, cfg), aux


def _by_groups(fn, x, args, n_out: int, **kw):
    """``fn(*args, **kw)``, whose work is per batch row (a dispatch group):
    on DTensors through ``local_map``, the rows split over the batch axes
    where they divide and everything else gathered, so that sorts and
    scatters run on one device's tensors; on plain tensors as it is."""
    from torch.distributed.tensor.experimental import local_map

    if not _is_dtensor(x):
        return fn(*args, **kw)
    rows = _row_placements(x)
    out = (rows,) * n_out if n_out > 1 else rows
    return local_map(lambda *a: fn(*a, **kw), out_placements=out,
                     in_placements=(rows,) * len(args),
                     redistribute_inputs=True)(*args)


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _row_placements(x):
    """Per mesh dim of ``x``: ``Shard(0)`` on the active rules' batch axes
    when the batch divides over them, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    rules = sharding.rules_or_default()
    mesh = x.device_mesh
    batch_ax = tuple(rules.batch) if rules.batch else ()
    sizes = sharding.mesh_sizes(mesh)
    n = 1
    for a in batch_ax:
        n *= sizes[a]
    split = bool(batch_ax) and x.shape[0] % n == 0
    return [Shard(0) if split and name in batch_ax else Replicate()
            for name in mesh.mesh_dim_names]


def _fill(x, order, slot, n_slots: int, k: int):
    """Each kept choice's token into its slot: ``(B, n_slots, d)`` (the
    dropped ones went to the pad row ``n_slots``, cut off here)."""
    b, _, d = x.shape
    rows = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, n_slots + 1, d))
    buf[rows, slot] = x[rows, order // k]
    return buf[:, :-1]


def _route(x, idx, *, cap: int, k: int, n: int, first: int = 0):
    """The buffers ``(B, n, C, d)`` of experts ``first .. first + n`` and
    each choice's slot ``inv`` (see :func:`dispatch`)."""
    b, _, d = x.shape
    order, slot, inv = dispatch(idx, n, cap, first)
    return _fill(x, order, slot, n * cap, k).reshape(b, n, cap, d), inv


def _experts(bufs, wg, wu, wd):
    """SwiGLU per expert over ``(B, E, C, d)`` buffers."""
    dt = bufs.dtype
    gate = F.silu(torch.einsum("gecd,edf->gecf", bufs, wg.to(dt)))
    up = torch.einsum("gecd,edf->gecf", bufs, wu.to(dt))
    return torch.einsum("gecf,efd->gecd", gate * up, wd.to(dt))


def _combine(out_buf, inv, gates, *, k: int):
    """Each token's k choices, weighted, summed in choice order."""
    b, _, _, d = out_buf.shape
    s = inv.shape[1] // k
    rows = torch.arange(b, device=out_buf.device)[:, None]
    flat = torch.cat([out_buf.reshape(b, -1, d),
                      out_buf.new_zeros((b, 1, d))], dim=1)
    picked = flat[rows, inv] * gates.reshape(b, s * k, 1).to(out_buf.dtype)
    picked = picked.reshape(b, s, k, d)
    y = picked[:, :, 0]
    for j in range(1, k):
        y = y + picked[:, :, j]
    return y


def _shared(p, x, y, cfg: ModelConfig):
    """``y`` plus the shared experts' SwiGLU of ``x``, if any."""
    if cfg.n_shared_experts:
        dt = x.dtype
        sg = F.silu(x @ p["shared_wg"].to(dt))
        su = x @ p["shared_wu"].to(dt)
        y = y + (sg * su) @ p["shared_wd"].to(dt)
    return y


def _moe_local(x, idx, gates, wg, wu, wd, first: int, cap: int, k: int):
    """The routed experts ``first .. first + E_local`` of ``x`` ``(B,S,d)``
    (the weights' leading dim is ``E_local``): each kept choice routed to
    one of them, weighted, summed over a token's choices in choice order;
    zeros for the others."""
    bufs, inv = _route(x, idx, cap=cap, k=k, n=wg.shape[0], first=first)
    return _combine(_experts(bufs, wg, wu, wd), inv, gates, k=k)


def _moe_local_map(p, x, idx, gates, cfg: ModelConfig, cap: int):
    """Explicit expert parallelism, the counterpart of the reference's
    ``_moe_shard_map``: through ``local_map``, every (data, model) device
    takes its data shard's rows (all of them where the batch does not
    divide) against its model shard's experts, and the partial outputs
    leave as ``Partial`` over the model axis, reduced by one all-reduce.
    Token-drop semantics are the plain path's: each expert lives on one
    shard, and its ranking within a group is shard-local already."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rules = sharding.rules_or_default()
    k = cfg.n_experts_active
    mesh = x.device_mesh
    m_dim = list(mesh.mesh_dim_names).index(rules.model)
    e_local = cfg.n_experts // mesh.size(m_dim)
    rows = _row_placements(x)
    experts = [Shard(0) if i == m_dim else Replicate()
               for i in range(mesh.ndim)]
    out = [Partial() if i == m_dim else rows[i] for i in range(mesh.ndim)]

    def local(xl, idxl, gl, wg, wu, wd):
        first = sharding.local_rank(mesh, m_dim) * e_local
        return _moe_local(xl, idxl, gl, wg, wu, wd, first, cap, k)

    fn = local_map(local, out_placements=out,
                   in_placements=(tuple(rows),) * 3 + (tuple(experts),) * 3,
                   redistribute_inputs=True)
    y = fn(x, idx, gates, p["wg"], p["wu"], p["wd"])
    return y.redistribute(mesh, rows)


class MoE(Params):
    """The MoE FFN: the router, the experts' ``wg``/``wu``/``wd`` and the
    optional ``shared_*`` experts, applied by :func:`moe_apply`."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(moe_schema(cfg), device, dtype)

    def forward(self, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(dict(self.named_parameters()), x, cfg)
