"""Heterogeneous decoder stacks: schema → parameters, forward, loss,
prefill, decode.

The reference scans a repeating period of stacked layers; here the
``cfg.n_layers`` layers are unrolled into an ``nn.ModuleList`` (layer
``prefix_layers + p·scan_period + j`` is the reference's ``body[j]`` at
period ``p``).  Three modes share one code path, as in the reference:

  * train   — causal forward with autograd (the caller's grad mode), each
    layer under ``cfg.remat_policy`` (:func:`_remat`), no caches
  * prefill — the same forward under ``no_grad``, emitting decode caches
    grown to ``max_len``
  * decode  — one token against the caches under ``no_grad`` (KV written
    in place at ``pos``; the SSM state replaced)

Parameters are a :class:`Transformer` module (built by :func:`init_params`
or ``convert.params_from_reference``), its leaves created frozen
(``requires_grad=False``): the train step turns them on.  Caches are a
list with one dict per layer.  Under an active mesh
(``sharding.mesh_context``) the same code runs on DTensors:
:func:`param_pspecs` / :func:`cache_pspecs` give the layouts,
:func:`distribute_params` lays the parameters out, and the reference's
constraints (embedding, block output, logits) redistribute activations;
:func:`abstract_params` / :func:`abstract_cache` are the ``meta`` stand-ins
the cost model counts.  :func:`loss_fn` is the reference's causal
LM loss; :func:`reference_ranks` gives each leaf the rank it has in the
reference's stacked tree, which AdamW's decay rule reads.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from .. import resolve_device, sharding, spans
from ..configs.base import LayerSpec, ModelConfig
from . import layers, mamba, moe
from .layers import ParamDef

Caches = List[Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def _layer_schema(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    s: Dict[str, Any] = {"mixer_norm": layers.norm_schema(cfg)}
    s["mixer"] = (layers.attn_schema(cfg) if spec.mixer == "attn"
                  else mamba.mamba_schema(cfg))
    if spec.ffn != "none":
        s["ffn_norm"] = layers.norm_schema(cfg)
        s["ffn"] = (layers.mlp_schema(cfg) if spec.ffn == "mlp"
                    else moe.moe_schema(cfg))
    return s


def model_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dicts of :class:`ParamDef` keyed as the module tree of
    :class:`Transformer` (``layers`` holds one entry per layer)."""
    d, v = cfg.d_model, cfg.vocab_size
    s: Dict[str, Any] = {}
    if cfg.input_mode == "audio_codes":
        s["embed"] = {"tok": ParamDef((cfg.n_codebooks, v, d),
                                      (None, "vocab", "embed"))}
    else:
        s["embed"] = {"tok": ParamDef((v, d), ("vocab", "embed"))}
    s["layers"] = {str(i): _layer_schema(cfg, spec)
                   for i, spec in enumerate(cfg.layout)}
    s["final_norm"] = layers.norm_schema(cfg)
    if not cfg.tie_embeddings:
        out_v = v * cfg.n_codebooks if cfg.input_mode == "audio_codes" else v
        s["unembed"] = {"w": ParamDef((d, out_v), ("embed", "vocab"))}
    return s


def flat_schema(tree: Dict[str, Any], prefix: str = ""
                ) -> List[Tuple[str, ParamDef]]:
    """``(dotted path, ParamDef)`` of every leaf, in insertion order."""
    out: List[Tuple[str, ParamDef]] = []
    for name, sub in tree.items():
        path = f"{prefix}{name}"
        if isinstance(sub, ParamDef):
            out.append((path, sub))
        else:
            out.extend(flat_schema(sub, path + "."))
    return out


def reference_ranks(cfg: ModelConfig) -> Dict[str, int]:
    """The rank of each leaf (by dotted path) in the reference's tree: a
    body layer's leaves are stacked over periods there (one more axis), a
    prefix layer's and the top-level leaves are as they are here."""
    out = {}
    for path, pd in flat_schema(model_schema(cfg)):
        parts = path.split(".")
        stacked = parts[0] == "layers" and int(parts[1]) >= cfg.prefix_layers
        out[path] = len(pd.shape) + int(stacked)
    return out


def count_params(cfg: ModelConfig) -> int:
    return int(sum(int(np.prod(pd.shape))
                   for _, pd in flat_schema(model_schema(cfg))))


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (MoE: top-k + shared experts only):
    an expert leaf (one whose axes hold ``"experts"``) counts at k/E."""
    if cfg.n_experts == 0:
        return count_params(cfg)
    frac = cfg.n_experts_active / cfg.n_experts
    total = 0
    for _, pd in flat_schema(model_schema(cfg)):
        n = int(np.prod(pd.shape))
        total += int(n * frac) if "experts" in pd.axes else n
    return total


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: pre-normed mixer (attention or Mamba), then the FFN."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device, dtype):
        super().__init__()
        self.mixer_norm = layers.Norm(cfg, device, dtype)
        self.mixer = (layers.Attention(cfg, device, dtype)
                      if spec.mixer == "attn"
                      else mamba.Mamba(cfg, device, dtype))
        self.ffn_kind = spec.ffn
        if spec.ffn != "none":
            self.ffn_norm = layers.Norm(cfg, device, dtype)
            self.ffn = (layers.MLP(cfg, device, dtype) if spec.ffn == "mlp"
                        else moe.MoE(cfg, device, dtype))
        else:
            self.ffn = None

    def forward(self, x, cfg: ModelConfig, *, cache=None, pos=None,
                make_cache=False):
        """``(x, new_cache, aux)``: ``aux`` is the MoE load-balance loss of
        this layer, or None for a layer without MoE."""
        with spans.span("mixer"):
            h = self.mixer_norm(x)
            mix, new_cache = self.mixer(h, cfg, cache=cache, pos=pos,
                                        make_cache=make_cache)
            x = x + mix
        aux = None
        if self.ffn_kind == "mlp":
            with spans.span("ffn"):
                x = x + self.ffn(self.ffn_norm(x))
        elif self.ffn_kind == "moe":
            with spans.span("ffn"):
                y, aux = self.ffn(self.ffn_norm(x), cfg)
                x = x + y
        return x, new_cache, aux


class Transformer(nn.Module):
    """The model's parameters as modules, uninitialised; ``cfg`` is the
    config it was built for (its layout decides the reference tree a
    checkpoint holds)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        schema = model_schema(cfg)
        self.embed = layers.Params(schema["embed"], device, dtype)
        self.layers = nn.ModuleList(Block(cfg, spec, device, dtype)
                                    for spec in cfg.layout)
        self.final_norm = layers.Norm(cfg, device, dtype)
        self.unembed = (None if cfg.tie_embeddings else
                        layers.Params(schema["unembed"], device, dtype))


def _init_leaf(p: torch.Tensor, pd: ParamDef, gen: torch.Generator):
    kind = pd.init[0]
    if kind == "zeros":
        p.zero_()
    elif kind == "ones":
        p.fill_(1.0)
    elif kind == "normal":
        p.normal_(0.0, pd.init[1], generator=gen)
    elif kind == "a_log":       # mamba: A_log = log(1..N) per state column
        n = pd.shape[-1]
        base = torch.log(torch.arange(1, n + 1, dtype=torch.float32,
                                      device=p.device))
        p.copy_(base.expand(pd.shape))
    elif kind == "dt_bias":     # softplus^-1 of dt0 ~ 0.01
        p.fill_(-4.6)
    else:
        raise ValueError(kind)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` (``None``: the card) with every
    leaf drawn as the reference's init kinds say, from ``generator`` (on
    the same device) in schema order, filled in place."""
    dev = resolve_device(device)
    with torch.no_grad():
        model = Transformer(cfg, dev)
        for path, pd in flat_schema(model_schema(cfg)):
            _init_leaf(model.get_parameter(path), pd, generator)
    return model


def abstract_params(cfg: ModelConfig) -> Transformer:
    """A :class:`Transformer` on ``meta``: every leaf's shape and dtype,
    nothing allocated (the reference's ``ShapeDtypeStruct`` tree)."""
    return Transformer(cfg, torch.device("meta"))


def param_pspecs(cfg: ModelConfig, rules: sharding.MeshRules
                 ) -> Dict[str, sharding.P]:
    """The spec of every parameter, by dotted path.  The reference stacks
    its body layers over periods, so its stacked leaves' specs start with
    the ``"layers"`` entry (``None``); the port's unrolled leaves have the
    same specs without it."""
    return {path: sharding.logical_to_pspec(pd.axes, rules,
                                            cfg.expert_parallel)
            for path, pd in flat_schema(model_schema(cfg))}


def distribute_params(params: Transformer, pspecs: Dict[str, sharding.P],
                      mesh) -> Transformer:
    """Turn each parameter of ``params`` into a DTensor on ``mesh`` under
    its spec, in place (a parameter that is one already is redistributed
    when its placements differ); returns ``params``."""
    for path, spec in pspecs.items():
        mod_path, _, name = path.rpartition(".")
        mod = params.get_submodule(mod_path)
        p = getattr(mod, name)
        d = sharding.distribute(p.detach(), spec, mesh)
        if d.placements != getattr(p, "placements", None):
            mod.register_parameter(name, nn.Parameter(
                d, requires_grad=p.requires_grad))
    return params


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _layer_cache_def(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_len: int):
    if spec.mixer == "attn":
        return layers.attn_cache_def(cfg, batch, max_len)
    return mamba.mamba_state_def(cfg, batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Caches:
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    return [{name: torch.zeros(pd.shape, dtype=dt, device=dev)
             for name, pd in _layer_cache_def(cfg, spec, batch,
                                              max_len).items()}
            for spec in cfg.layout]


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Caches:
    """:func:`init_cache` on ``meta``."""
    return init_cache(cfg, batch, max_len, device="meta")


def cache_pspecs(cfg: ModelConfig, rules: sharding.MeshRules,
                 long_context: bool = False) -> List[Dict[str, sharding.P]]:
    """Specs matching :func:`init_cache`'s structure (one dict a layer);
    the reference's unstacked."""
    out = []
    for spec in cfg.layout:
        if spec.mixer == "attn":                   # (B, T, KV, hd)
            kv = _kv_spec(cfg, rules, long_context)
            out.append({"k": kv, "v": kv})
        else:
            b = _batch(rules, long_context)
            out.append({"h": sharding.P(b, rules.model, None),  # (B,di,N)
                        "conv": sharding.P(b, None, rules.model)})
    return out


def _batch(rules: sharding.MeshRules, long_context: bool):
    if long_context:
        return None          # batch=1: replicate batch, shard sequence
    return rules.batch if rules.batch else None


def _kv_spec(cfg: ModelConfig, rules: sharding.MeshRules,
             long_context: bool) -> sharding.P:
    msize = 1
    ctx = sharding.active()
    if ctx is not None and rules.model is not None:
        msize = sharding.mesh_sizes(ctx[0])[rules.model]
    h_ax = d_ax = None
    if msize > 1:
        if cfg.n_kv_heads % msize == 0:
            h_ax = rules.model
        elif cfg.resolved_head_dim % msize == 0:
            d_ax = rules.model
    if long_context and rules.seq:
        return sharding.P(None, rules.seq, h_ax, d_ax)
    return sharding.P(_batch(rules, long_context), None, h_ax, d_ax)


def _pad_caches(caches: Caches, cfg: ModelConfig, max_len: int) -> Caches:
    """Grow each attention layer's prefill K/V (B,S,kv,hd) to
    (B,max_len,kv,hd); the SSM state has no length."""
    out = []
    for spec, c in zip(cfg.layout, caches):
        if spec.mixer == "attn" and c["k"].shape[1] < max_len:
            grown = {}
            for name, t in c.items():
                g = t.new_zeros((t.shape[0], max_len) + tuple(t.shape[2:]))
                g[:, :t.shape[1]] = t
                grown[name] = g
            c = grown
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_inputs(params: Transformer, cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    dt = getattr(torch, cfg.dtype)
    emb = params.embed.tok
    if cfg.input_mode == "audio_codes":
        codes = batch["codes"]                         # (B, K, S)
        x = _lookup(codes[:, 0], emb[0])
        for k in range(1, cfg.n_codebooks):
            x = x + _lookup(codes[:, k], emb[k])
    elif cfg.input_mode == "vlm" and "vision_embeds" in batch:
        tok = _lookup(batch["tokens"], emb)
        x = torch.cat([batch["vision_embeds"].to(tok.dtype), tok], dim=1)
    else:
        x = _lookup(batch["tokens"], emb)
    return sharding.constrain(x.to(dt), sharding.act_spec_btd(x.shape[1]))


def _vocab_split(t, dim: int):
    """The mesh dims that split dim ``dim`` of a DTensor ``t`` ([] for a
    plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return []
    return [m for m, p in enumerate(t.placements)
            if isinstance(p, Shard) and p.dim == dim]


def _lookup(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, table)``.  On a DTensor table whose vocab (rows)
    is split over one mesh dim, each device looks up the rows it holds
    (zeros for the others) and the lookups leave as ``Partial`` sums (one
    all-reduce), the table's other splits gathered first (FSDP): the
    vocab-parallel embedding, which also needs no data-dependent check on
    abstract tensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    split = _vocab_split(table, 0)
    if not split:
        return F.embedding(ids, table)
    mesh = table.device_mesh
    if len(split) > 1 or table.shape[0] % mesh.size(split[0]):
        return F.embedding(ids, table.redistribute(
            mesh, [Replicate()] * mesh.ndim))
    m = split[0]
    ids_pl = (list(ids.placements) if isinstance(ids, DTensor)
              else [Replicate()] * mesh.ndim)
    i_pl = [Replicate() if i == m else p for i, p in enumerate(ids_pl)]
    t_pl = [Shard(0) if i == m else Replicate() for i in range(mesh.ndim)]
    out_pl = [Partial() if i == m else p for i, p in enumerate(i_pl)]
    v_local = table.shape[0] // mesh.size(m)

    def local(i, tab):
        j = i - sharding.local_rank(mesh, m) * v_local
        out = F.embedding(j.clamp(0, v_local - 1), tab)
        ok = ((j >= 0) & (j < v_local))[..., None]
        return torch.where(ok, out, torch.zeros_like(out))

    y = local_map(local, out_placements=out_pl, in_placements=(i_pl, t_pl),
                  redistribute_inputs=True)(ids, table)
    return y.redistribute(mesh, i_pl)


#: matmuls without batch dimensions: the ops whose outputs the ``"dots"``
#: policy saves (the counterpart of ``dots_with_no_batch_dims_saveable``)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn: Callable, cfg: ModelConfig) -> Callable:
    """``fn`` (one layer) under ``cfg.remat_policy``: ``"none"`` as it is;
    ``"full"`` recomputed in the backward (non-reentrant checkpoint);
    ``"dots"`` recomputed except the outputs of 2-D matmuls, which are
    saved (selective activation checkpointing).  Under either policy the
    layer's forward, its kernel launch with it, runs again in the backward
    pass."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(cfg.remat_policy)


def _remat_cfg(cfg: ModelConfig, x) -> ModelConfig:
    """``cfg``, with ``"dots"`` as ``"full"`` for a DTensor ``x``: selective
    checkpointing replays the forward's op stream, which DTensor's cached
    shape propagation changes between the forward and the recompute, so on
    a mesh the whole layer is recomputed (same values, more FLOPs)."""
    from torch.distributed.tensor import DTensor
    if cfg.remat_policy == "dots" and isinstance(x, DTensor):
        return dataclasses.replace(cfg, remat_policy="full")
    return cfg


def remat_passes(cfg: ModelConfig) -> int:
    """How many times a train step runs each layer's forward (and launches
    its sequence kernel): once, and once more in the backward under a
    remat policy."""
    return 1 if cfg.remat_policy == "none" else 2


def forward(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, mode: str = "train",
            caches: Optional[Caches] = None, pos: Optional[int] = None,
            max_len: Optional[int] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Caches]]:
    """Returns ``(logits, moe_aux_mean, caches_out or None)``: the aux is
    summed over the MoE layers in layer order, in float32, and divided by
    their count (0 without MoE layers).  Train mode keeps the caller's
    grad mode; prefill and decode run without autograd."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    make_cache = mode == "prefill"
    n_moe = max(1, sum(1 for spec in cfg.layout if spec.ffn == "moe"))
    remat = mode == "train" and torch.is_grad_enabled()
    with spans.span("forward"), torch.set_grad_enabled(remat):
        x = _embed_inputs(params, cfg, batch)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches: Optional[Caches] = (
            [] if make_cache or caches is not None else None)
        for i, layer in enumerate(params.layers):
            c = caches[i] if caches is not None else None
            if remat:
                x, nc, aux = _remat(functools.partial(layer, cfg=cfg),
                                    _remat_cfg(cfg, x))(x)
            else:
                x, nc, aux = layer(x, cfg, cache=c, pos=pos,
                                   make_cache=make_cache)
            x = sharding.constrain(x, sharding.act_spec_btd(x.shape[1]))
            if aux is not None:
                aux_total = aux_total + aux
            if new_caches is not None:
                new_caches.append(nc)

        with spans.span("head"):
            x = params.final_norm(x)
            dt = x.dtype
            if cfg.tie_embeddings:
                logits = x @ params.embed.tok.to(dt).T
            else:
                logits = x @ params.unembed.w.to(dt)
            if cfg.input_mode == "audio_codes":
                b, s, _ = logits.shape
                logits = sharding.reshape(logits, b, s, cfg.n_codebooks,
                                          cfg.vocab_size)
            logits = sharding.constrain(
                logits, sharding.logits_spec()
                if cfg.input_mode != "audio_codes"
                else sharding.P(sharding.batch_axes(), None, None,
                                sharding.rules_or_default().model))
        if make_cache and max_len is not None:
            new_caches = _pad_caches(new_caches, cfg, max_len)
    return logits, aux_total / n_moe, new_caches


# ---------------------------------------------------------------------------
# Losses and steps
# ---------------------------------------------------------------------------

def loss_fn(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], z_loss_weight: float = 1e-4
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(total, metrics)``: mean cross-entropy over the targets that are
    not masked (``< 0``), plus the z-loss and ``router_aux_weight`` × the
    MoE aux, as the reference's ``loss_fn``."""
    logits, aux, _ = forward(params, cfg, batch, mode="train")
    with spans.span("loss"):
        logits = logits.float()
        targets = batch["targets"].long()
        if cfg.input_mode == "audio_codes":
            targets = torch.movedim(targets, 1, 2)     # (B,K,S) -> (B,S,K)
        if cfg.input_mode == "vlm":
            pad = -torch.ones(targets.shape[:1] + (cfg.vision_prefix,),
                              dtype=targets.dtype, device=targets.device)
            targets = torch.cat([pad, targets], dim=1)
        mask = (targets >= 0).float()
        safe_t = torch.clamp(targets, min=0)
        lse = torch.logsumexp(logits, dim=-1)
        true_logit = _pick(logits, safe_t)
        ce = (lse - true_logit) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = ce.sum() / denom
        zl = z_loss_weight * ((lse * mask) ** 2).sum() / denom
        total = loss + zl + cfg.router_aux_weight * aux
    metrics = {"loss": loss, "z_loss": zl, "moe_aux": aux, "tokens": denom}
    return total, metrics


def _pick(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``logits[..., targets]``.  On a DTensor whose vocab (last) dim is
    split over one mesh dim, each device picks from its own slice and the
    picks leave as ``Partial`` sums (one all-reduce of ``targets``' size),
    the vocab-parallel cross-entropy's gather."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    split = _vocab_split(logits, logits.ndim - 1)
    if not split:
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    mesh = logits.device_mesh
    if len(split) > 1 or logits.shape[-1] % mesh.size(split[0]):
        full = [Replicate() if m in split else p
                for m, p in enumerate(logits.placements)]
        return _pick(logits.redistribute(mesh, full), targets)
    m = split[0]
    t_pl = [Replicate() if i == m else p
            for i, p in enumerate(logits.placements)]
    out_pl = [Partial() if i == m else p for i, p in enumerate(t_pl)]
    v_local = logits.shape[-1] // mesh.size(m)

    def local(lg, t):
        t = t - sharding.local_rank(mesh, m) * v_local
        ok = (t >= 0) & (t < v_local)
        got = torch.gather(lg, -1, t.clamp(0, v_local - 1)[..., None])[..., 0]
        return torch.where(ok, got, torch.zeros_like(got))

    picked = local_map(local, out_placements=out_pl,
                       in_placements=(logits.placements, t_pl),
                       redistribute_inputs=True)(logits, targets)
    return picked.redistribute(mesh, t_pl)


def prefill(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], max_len: int):
    """Causal forward that also returns decode caches sized to max_len."""
    with spans.span("prefill"):
        logits, _, caches = forward(params, cfg, batch, mode="prefill",
                                    max_len=max_len, pos=0)
    return logits, caches


def decode_step(params: Transformer, cfg: ModelConfig, caches: Caches,
                tokens: Dict[str, torch.Tensor], pos: int):
    """One new token against the caches.  pos = current cache length."""
    with spans.span("decode_step"):
        logits, _, caches = forward(params, cfg, tokens, mode="decode",
                                    caches=caches, pos=pos)
    return logits, caches
