"""The plain reference: a decoder stack, its loss and AdamW, in plain torch.

It imports nothing of the program.  Parameters are a dict from the
dotted names below to float32 tensors, the names the port's module tree
uses (``embed.tok``, ``layers.<i>.mixer_norm.scale``,
``layers.<i>.mixer.<leaf>``, ``layers.<i>.ffn_norm.scale``,
``layers.<i>.ffn.<leaf>``, ``final_norm.scale``, ``unembed.w``), so the
benchmark can hand one set of weights to both sides by name.  The layer
kinds are modules of this package named by the configuration file's
``reference.block`` (``["attn", "mlp"]``, ``["mamba", "none"]``): each
gives its leaves (``schema``), the leaves used as weights of products
(``MATMUL``) and its ``forward``.
"""

from __future__ import annotations

import functools
import importlib
import math
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils import checkpoint

Params = Dict[str, torch.Tensor]


def kind(name: str):
    """The module of a layer kind (``attn``, ``mlp``, ``mamba``)."""
    return importlib.import_module(f"{__package__}.{name}")


def blocks(cfg) -> List[Tuple[str, str]]:
    """``(mixer, ffn)`` of each layer; ffn ``"none"`` for a layer without
    one."""
    ref = cfg["reference"]
    if "blocks" in ref:
        return [tuple(b) for b in ref["blocks"]]
    return [tuple(ref["block"])] * cfg["num_hidden_layers"]


def schema(cfg) -> List[Tuple[str, Tuple[int, ...], tuple]]:
    """``(name, shape, init)`` of every leaf, in the port's order."""
    d, v = cfg["hidden_size"], cfg["vocab_size"]
    n_layers = cfg["num_hidden_layers"]
    out = [("embed.tok", (v, d), ("normal", 0.02))]
    for i, (mixer, ffn) in enumerate(blocks(cfg)):
        parts = [("mixer", mixer)] + ([("ffn", ffn)] if ffn != "none" else [])
        for part, name in parts:
            out.append((f"layers.{i}.{part}_norm.scale", (d,), ("ones",)))
            out += [(f"layers.{i}.{part}.{leaf}", shape, init)
                    for leaf, shape, init in kind(name).schema(cfg, n_layers)]
    out.append(("final_norm.scale", (d,), ("ones",)))
    if not cfg.get("tie_word_embeddings", False):
        out.append(("unembed.w", (d, v), ("normal", 0.02)))
    return out


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def _layer(x, parts, cfg, prec, q_block):
    eps = cfg["reference"]["norm_eps"]
    for name, norm, leaves in parts:
        x = x + kind(name).forward(leaves, rms_norm(x, norm, eps), cfg, prec,
                                   q_block)
    return x


def forward(p: Params, cfg, tokens: torch.Tensor, prec, *,
            remat: bool = False, q_block=None, logits_at=None):
    """Logits ``(B, S, V)`` of ``tokens`` ``(B, S)``, or of the positions
    ``logits_at`` (an index or slice of the sequence) alone.  ``remat``
    recomputes each layer in the backward pass."""
    x = p["embed.tok"][tokens]
    for i, (mixer, ffn) in enumerate(blocks(cfg)):
        parts = []
        for part, name in [("mixer", mixer), ("ffn", ffn)]:
            if name == "none":
                continue
            pre = f"layers.{i}.{part}."
            leaves = {k[len(pre):]: t for k, t in p.items()
                      if k.startswith(pre)}
            parts.append((name, p[f"layers.{i}.{part}_norm.scale"], leaves))
        layer = functools.partial(_layer, parts=parts, cfg=cfg, prec=prec,
                                  q_block=q_block)
        x = (checkpoint.checkpoint(layer, x, use_reentrant=False) if remat
             else layer(x))
    x = rms_norm(x, p["final_norm.scale"], cfg["reference"]["norm_eps"])
    if logits_at is not None:
        x = x[:, logits_at]
    w = (p["embed.tok"].T if cfg.get("tie_word_embeddings", False)
         else p["unembed.w"])
    return prec.mm(x, w)


def loss(p: Params, cfg, tokens, targets, prec, z_weight: float,
         remat: bool = True):
    """``(total, cross-entropy)``: the mean cross-entropy of ``targets``
    plus ``z_weight`` x the mean squared log-partition (the z-loss)."""
    logits = forward(p, cfg, tokens, prec, remat=remat)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, targets[..., None])[..., 0]
    ce = (lse - picked).mean()
    return ce + z_weight * (lse * lse).mean(), ce


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def lr_at(step: int, opt) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine from ``lr`` down
    to ``min_lr_ratio`` x ``lr`` at ``total_steps``."""
    if step < opt["warmup_steps"]:
        return opt["lr"] * (step + 1) / max(opt["warmup_steps"], 1)
    t = min(max((step - opt["warmup_steps"])
                / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    ratio = opt["min_lr_ratio"]
    cosine = 0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * (ratio + (1 - ratio) * cosine)


def decays(name: str, p: torch.Tensor) -> bool:
    """Weight decay on every leaf of a layer and on the matrices outside
    them (the port's rule: its layers are stacked, one axis more, in the
    tree it was written for)."""
    return name.startswith("layers.") or p.ndim >= 2


@torch.no_grad()
def adamw(p: Params, grads: Params, m: Params, v: Params, step: int,
          opt) -> Dict[str, float]:
    """One AdamW step in place, the gradients clipped to a global norm of
    ``clip_norm``; returns each leaf's clipped gradient norm."""
    gn = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
    scale = min(opt["clip_norm"] / max(gn, 1e-9), 1.0)
    b1, b2 = opt["b1"], opt["b2"]
    c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    lr = lr_at(step, opt)
    norms = {}
    for name, t in p.items():
        g = grads[name] * scale
        norms[name] = float(torch.linalg.vector_norm(g))
        m[name].mul_(b1).add_(g, alpha=1 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        delta = (m[name] / c1) / (torch.sqrt(v[name] / c2) + opt["eps"])
        if decays(name, t):
            delta += opt["weight_decay"] * t
        t.sub_(lr * delta)
    return norms


def train(p: Params, cfg, batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          opt, prec, z_weight: float):
    """Steps of AdamW on ``batches`` from the parameters ``p`` (updated in
    place): ``(losses, the first step's clipped gradient norm a leaf)``."""
    names = list(p)
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    losses, first = [], None
    for step, (tokens, targets) in enumerate(batches):
        leaves = [p[k].requires_grad_() for k in names]
        with torch.enable_grad():
            total, ce = loss(p, cfg, tokens, targets, prec, z_weight)
            grads = dict(zip(names, torch.autograd.grad(total, leaves)))
        for t in leaves:
            t.requires_grad_(False)
        losses.append(float(ce.detach()))
        norms = adamw(p, grads, m, v, step, opt)
        first = first or norms
        del grads, total
    return losses, first
