"""AdamW + warmup-cosine schedule + global-norm clipping, on tensors.

The reference's update (``src/repro/optim.py``), step for step: moments
are float32 tensors on the parameters' device, bias corrections taken from
the step count, decoupled weight decay on matrices only.  A "tree" here is
a mapping from names to tensors (or a module, whose named parameters are
its leaves); ``torch.optim.AdamW`` is not used, as its bias correction and
its decay rule differ.

Weight decay follows the rank of each leaf *in the reference's tree*
(``ranks``): the reference stacks its scanned body layers over periods,
so a body layer's norm scale is 2-D there and decayed, while the port
unrolls its layers and holds it 1-D (``transformer.reference_ranks``).

The schedule and the corrections are computed in float32, the reference's
regime while ``jax_enable_x64`` is off (with x64 on, its learning rate is
float64 and differs in the last bits).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

Tree = Union[Mapping[str, torch.Tensor], nn.Module]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def leaves(tree: Tree) -> Dict[str, torch.Tensor]:
    """The named leaves of ``tree``: a module's parameters, or the mapping
    itself."""
    if isinstance(tree, nn.Module):
        return dict(tree.named_parameters())
    return dict(tree)


def schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an int or an integer tensor), float32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * (s + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(s < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params: Tree) -> Dict[str, Any]:
    named = leaves(params)
    device = next(iter(named.values())).device if named else None
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in named.items()}
    return {"m": zeros,
            "v": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Tree) -> torch.Tensor:
    total = 0
    for g in leaves(tree).values():
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Dict[str, Any],
                 cfg: OptConfig, ranks: Optional[Mapping[str, int]] = None,
                 ) -> Tuple[Tree, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  The parameters and the moments are updated in place
    (``params`` is returned); the new state holds the same moment tensors
    and ``step + 1``.  ``ranks`` gives each leaf's rank as the decay rule
    reads it (default: the tensor's own ``ndim``)."""
    named = leaves(params)
    named_g = leaves(grads)
    step = state["step"]
    lr = schedule(step, cfg)
    gn = global_norm(named_g)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    s1 = step.to(torch.float32) + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=s1.device), s1)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=s1.device), s1)
    for name, p in named.items():
        m, v = state["m"][name], state["v"][name]
        g = named_g[name].float() * scale
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        rank = p.ndim if ranks is None else ranks[name]
        if rank >= 2:                          # decoupled wd, matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    new_state = {"m": state["m"], "v": state["v"], "step": step + 1}
    return params, new_state, {"lr": lr, "grad_norm": gn}
