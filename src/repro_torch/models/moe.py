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
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

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
    ce = torch.bincount(idx.reshape(-1), minlength=e).float() / idx.numel()
    return e * torch.sum(me * ce)


def dispatch(idx: torch.Tensor, n_experts: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per group, the slot of each (token, choice) in the flattened
    ``(E·C + 1)``-row buffer, all ``(B, S·k)`` int64: ``order`` (the
    choices in stable expert order) with ``slot`` (each one's slot in that
    order), and ``inv`` (each choice's slot in choice order).  A choice
    ranked at or past ``cap`` in its expert is dropped to ``E·C``, the pad
    row."""
    b, s, k = idx.shape
    flat_e = idx.reshape(b, s * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    experts = torch.arange(n_experts, device=idx.device).expand(b, -1)
    starts = torch.searchsorted(sorted_e, experts.contiguous(), side="left")
    rank = (torch.arange(s * k, device=idx.device)
            - torch.gather(starts, 1, sorted_e))
    slot = torch.where(rank < cap, sorted_e * cap + rank,
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
    order, slot, inv = dispatch(idx, e, c)

    # ---- dispatch: each kept choice's token into its slot ----
    rows = torch.arange(b, device=x.device)[:, None]
    buf = x.new_zeros((b, e * c + 1, d))
    buf[rows, slot] = x[rows, order // k]
    bufs = buf[:, :-1].reshape(b, e, c, d)

    # ---- experts: SwiGLU per expert ----
    gate = F.silu(torch.einsum("gecd,edf->gecf", bufs, p["wg"].to(dt)))
    up = torch.einsum("gecd,edf->gecf", bufs, p["wu"].to(dt))
    out_buf = torch.einsum("gecf,efd->gecd", gate * up, p["wd"].to(dt))

    # ---- combine: each token's k choices, weighted, in choice order ----
    flat = torch.cat([out_buf.reshape(b, e * c, d),
                      out_buf.new_zeros((b, 1, d))], dim=1)
    picked = flat[rows, inv] * gates.reshape(b, s * k, 1).to(dt)
    picked = picked.reshape(b, s, k, d)
    y = picked[:, :, 0]
    for j in range(1, k):
        y = y + picked[:, :, j]

    if cfg.n_shared_experts:
        sg = F.silu(x @ p["shared_wg"].to(dt))
        su = x @ p["shared_wu"].to(dt)
        y = y + (sg * su) @ p["shared_wd"].to(dt)
    return y, aux


class MoE(Params):
    """The MoE FFN: the router, the experts' ``wg``/``wu``/``wd`` and the
    optional ``shared_*`` experts, applied by :func:`moe_apply`."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(moe_schema(cfg), device, dtype)

    def forward(self, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return moe_apply(dict(self.named_parameters()), x, cfg)
