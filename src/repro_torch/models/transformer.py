"""Heterogeneous decoder stacks: schema → parameters, forward, prefill, decode.

The reference scans a repeating period of stacked layers; here the
``cfg.n_layers`` layers are unrolled into an ``nn.ModuleList`` (layer
``prefix_layers + p·scan_period + j`` is the reference's ``body[j]`` at
period ``p``).  Three modes share one code path, as in the reference:

  * train   — causal forward, no caches
  * prefill — the same forward, emitting decode caches grown to ``max_len``
  * decode  — one token against the caches (KV written in place at
    ``pos``; the SSM state replaced)

Parameters are a :class:`Transformer` module (built by :func:`init_params`
or ``convert.params_from_reference``); caches are a list with one dict per
layer.  Inference only: parameters do not require grad.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
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


def count_params(cfg: ModelConfig) -> int:
    return int(sum(int(np.prod(pd.shape))
                   for _, pd in flat_schema(model_schema(cfg))))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """One layer: pre-normed mixer (attention or Mamba), then the FFN."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device, dtype):
        super().__init__()
        if spec.ffn == "moe":
            raise NotImplementedError(moe.NOT_PORTED)
        self.mixer_norm = layers.Norm(cfg, device, dtype)
        self.mixer = (layers.Attention(cfg, device, dtype)
                      if spec.mixer == "attn"
                      else mamba.Mamba(cfg, device, dtype))
        if spec.ffn == "mlp":
            self.ffn_norm = layers.Norm(cfg, device, dtype)
            self.ffn = layers.MLP(cfg, device, dtype)
        else:
            self.ffn = None

    def forward(self, x, cfg: ModelConfig, *, cache=None, pos=None,
                make_cache=False):
        h = self.mixer_norm(x)
        mix, new_cache = self.mixer(h, cfg, cache=cache, pos=pos,
                                    make_cache=make_cache)
        x = x + mix
        if self.ffn is not None:
            x = x + self.ffn(self.ffn_norm(x))
        return x, new_cache


class Transformer(nn.Module):
    """The model's parameters as modules, uninitialised."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
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
        x = emb[0][codes[:, 0]]
        for k in range(1, cfg.n_codebooks):
            x = x + emb[k][codes[:, k]]
    elif cfg.input_mode == "vlm" and "vision_embeds" in batch:
        tok = emb[batch["tokens"]]
        x = torch.cat([batch["vision_embeds"].to(tok.dtype), tok], dim=1)
    else:
        x = emb[batch["tokens"]]
    return x.to(dt)


def forward(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], *, mode: str = "train",
            caches: Optional[Caches] = None, pos: Optional[int] = None,
            max_len: Optional[int] = None,
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Caches]]:
    """Returns ``(logits, moe_aux_mean, caches_out or None)``; the aux is 0
    (no MoE layer runs in the port)."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    make_cache = mode == "prefill"
    with torch.no_grad():
        x = _embed_inputs(params, cfg, batch)
        new_caches: Optional[Caches] = (
            [] if make_cache or caches is not None else None)
        for i, layer in enumerate(params.layers):
            c = caches[i] if caches is not None else None
            x, nc = layer(x, cfg, cache=c, pos=pos, make_cache=make_cache)
            if new_caches is not None:
                new_caches.append(nc)

        x = params.final_norm(x)
        dt = x.dtype
        if cfg.tie_embeddings:
            logits = x @ params.embed.tok.to(dt).T
        else:
            logits = x @ params.unembed.w.to(dt)
        if cfg.input_mode == "audio_codes":
            b, s, _ = logits.shape
            logits = logits.reshape(b, s, cfg.n_codebooks, cfg.vocab_size)
        if make_cache and max_len is not None:
            new_caches = _pad_caches(new_caches, cfg, max_len)
    aux = torch.zeros((), dtype=torch.float32, device=logits.device)
    return logits, aux, new_caches


def prefill(params: Transformer, cfg: ModelConfig,
            batch: Dict[str, torch.Tensor], max_len: int):
    """Causal forward that also returns decode caches sized to max_len."""
    logits, _, caches = forward(params, cfg, batch, mode="prefill",
                                max_len=max_len, pos=0)
    return logits, caches


def decode_step(params: Transformer, cfg: ModelConfig, caches: Caches,
                tokens: Dict[str, torch.Tensor], pos: int):
    """One new token against the caches.  pos = current cache length."""
    logits, _, caches = forward(params, cfg, tokens, mode="decode",
                                caches=caches, pos=pos)
    return logits, caches
