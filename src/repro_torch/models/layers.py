"""Shared layers: norms, rotary embeddings, GQA attention, SwiGLU MLP.

Each layer is an ``nn.Module`` whose parameters are the leaves of its
``*_schema(cfg)`` under the reference's names (``wq``, ``scale``, ...),
so a state-dict path such as ``layers.3.mixer.wq`` names the same tensor
as the reference's ``body/0/mixer/wq[3]``.  Parameters keep
``cfg.param_dtype`` and are cast to the activation dtype at each matmul,
as the reference does (``x @ p["w"].astype(dt)``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: Tuple = ("normal", 0.02)


class Params(nn.Module):
    """A module holding one schema's leaves as (frozen) parameters, left
    uninitialised: ``transformer.init_params`` or
    ``convert.params_from_reference`` fills them."""

    def __init__(self, schema: Dict[str, ParamDef], device, dtype):
        super().__init__()
        for name, pd in schema.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(pd.shape, dtype=dtype, device=device),
                requires_grad=False))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = {"scale": ParamDef((cfg.d_model,), (None,), ("ones",))}
    if cfg.norm == "layernorm":
        d["bias"] = ParamDef((cfg.d_model,), (None,), ("zeros",))
    return d


class Norm(Params):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(norm_schema(cfg), device, dtype)
        self.kind = cfg.norm

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                                  + eps)
            return (xf * self.scale.float()).to(x.dtype)
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mu) * torch.rsqrt(var + eps)
        return (xf * self.scale + self.bias).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (partial rotary supported — stablelm)
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         pct: float) -> torch.Tensor:
    """x: (B,S,H,hd); positions: (S,) absolute positions.  The rotation is
    taken in float32 (a bf16 ``x`` promotes) and cast back."""
    hd = x.shape[-1]
    rot = int(hd * pct)
    rot -= rot % 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]             # (S, half)
    cos = torch.cos(ang)[None, :, None, :]
    sin = torch.sin(ang)[None, :, None, :]
    x1, x2 = xr[..., :half], xr[..., half:]
    xr = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([xr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def attn_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    wscale = 0.02 / (2 * cfg.n_layers) ** 0.5
    s = {
        "wq": ParamDef((d, qd), ("embed", "q")),
        "wk": ParamDef((d, kvd), ("embed", "kv")),
        "wv": ParamDef((d, kvd), ("embed", "kv")),
        "wo": ParamDef((qd, d), ("q", "embed"), ("normal", wscale)),
    }
    if cfg.qkv_bias:
        s["bq"] = ParamDef((qd,), ("q",), ("zeros",))
        s["bk"] = ParamDef((kvd,), ("kv",), ("zeros",))
        s["bv"] = ParamDef((kvd,), ("kv",), ("zeros",))
    return s


class Attention(Params):
    """Pre-normed input -> attention output under ``cfg``, the config of
    the call, in three modes: train / no-cache (causal self-attention),
    prefill (``make_cache=True``: returns the K/V of the prompt) and decode
    (``cache`` given: ``x`` holds the new token(s), ``pos`` is the current
    cache length).  Prefill attends through ``ops.flash_attention`` at
    ``cfg.attention_impl`` — the kernel on the card.  Decode writes K/V
    into the cache in place at ``pos`` and attends over it through the
    ``"naive"`` version for a single token, as the reference does."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(attn_schema(cfg), device, dtype)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                pos: Optional[int] = None, make_cache: bool = False):
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        dt = x.dtype

        q = (x @ self.wq.to(dt)).reshape(b, s, h, hd)
        k = (x @ self.wk.to(dt)).reshape(b, s, kv, hd)
        v = (x @ self.wv.to(dt)).reshape(b, s, kv, hd)
        if cfg.qkv_bias:
            q = q + self.bq.to(dt).reshape(h, hd)
            k = k + self.bk.to(dt).reshape(kv, hd)
            v = v + self.bv.to(dt).reshape(kv, hd)

        offset = 0 if pos is None else int(pos)
        positions = offset + torch.arange(s, device=x.device)
        q = rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_pct)

        new_cache = None
        if cache is not None:       # decode: write into the cache, attend
            cache["k"][:, offset:offset + s] = k.to(cache["k"].dtype)
            cache["v"][:, offset:offset + s] = v.to(cache["v"].dtype)
            new_cache = cache
            out = ops.flash_attention(
                q, cache["k"].to(dt), cache["v"].to(dt), causal=True,
                q_offset=offset, kv_len=offset + s,
                impl="naive" if s == 1 else cfg.attention_impl,
                q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv)
        else:                       # train / prefill: causal self-attention
            out = ops.flash_attention(
                q, k, v, causal=True, impl=cfg.attention_impl,
                q_chunk=cfg.attn_chunk_q, kv_chunk=cfg.attn_chunk_kv,
                causal_skip=cfg.attn_causal_skip)
            if make_cache:
                new_cache = {"k": k, "v": v}

        out = out.reshape(b, s, h * hd)
        return out @ self.wo.to(dt), new_cache


def attn_cache_def(cfg: ModelConfig, batch: int, max_len: int):
    hd = cfg.resolved_head_dim
    shape = (batch, max_len, cfg.n_kv_heads, hd)
    axes = ("batch", "seq", "kv_heads", "head_dim")
    return {"k": ParamDef(shape, axes, ("zeros",)),
            "v": ParamDef(shape, axes, ("zeros",))}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, cfg.d_ff
    wscale = 0.02 / (2 * cfg.n_layers) ** 0.5
    return {
        "wg": ParamDef((d, f), ("embed", "ff")),
        "wu": ParamDef((d, f), ("embed", "ff")),
        "wd": ParamDef((f, d), ("ff", "embed"), ("normal", wscale)),
    }


class MLP(Params):
    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(mlp_schema(cfg), device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        gate = F.silu(x @ self.wg.to(dt))
        up = x @ self.wu.to(dt)
        return (gate * up) @ self.wd.to(dt)
