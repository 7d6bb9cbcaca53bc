"""Mamba-1 block: causal depthwise conv + selective scan (+ decode state).

The parallel (train/prefill) path runs the selective scan through
``kernels.ops.selective_scan`` — the CUDA kernel on the card, the chunked
associative scan on the CPU — which also hands back the final state for the
cache.  Decode is a single recurrence step on the (h, conv) state in plain
torch, as in the reference, which runs it outside any kernel.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .. import sharding
from ..configs.base import ModelConfig
from ..kernels import ops
from .layers import ParamDef, Params


def mamba_schema(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm_state
    rank, kc = cfg.dt_rank, cfg.ssm_conv
    wscale = 0.02 / (2 * cfg.n_layers) ** 0.5
    return {
        "in_proj": ParamDef((d, 2 * di), ("embed", "inner")),
        "conv_w": ParamDef((kc, di), (None, "inner"), ("normal", 0.1)),
        "conv_b": ParamDef((di,), ("inner",), ("zeros",)),
        "x_proj": ParamDef((di, rank + 2 * n), ("inner", None)),
        "dt_w": ParamDef((rank, di), (None, "inner")),
        "dt_b": ParamDef((di,), ("inner",), ("dt_bias",)),
        "a_log": ParamDef((di, n), ("inner", None), ("a_log",)),
        "d_skip": ParamDef((di,), ("inner",), ("ones",)),
        "out_proj": ParamDef((di, d), ("inner", "embed"), ("normal", wscale)),
    }


def _conv(xp: torch.Tensor, conv_w: torch.Tensor, s: int) -> torch.Tensor:
    """Causal depthwise conv of the padded ``xp`` (B,s+kc-1,di): the taps
    summed in index order in the activation dtype, as the reference's
    ``sum(...)`` rounds them, into one buffer (an in-place add rounds as
    the out-of-place one)."""
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, conv_w.shape[0]):
        out += xp[:, i:i + s] * conv_w[i]
    return out


class Mamba(Params):
    """x: (B,S,d) under ``cfg`` (the config of the call: its
    ``attention_impl`` picks the scan kernel or a plain version).
    state: {"h": (B,di,N) f32, "conv": (B,kc-1,di)}."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__(mamba_schema(cfg), device, dtype)

    def _split_xz(self, x):
        xz = x @ self.in_proj.to(x.dtype)                      # (B,S,2*di)
        return torch.chunk(xz, 2, dim=-1)

    def _ssm_params(self, xh, cfg: ModelConfig):
        dt_ = xh.dtype
        n, rank = cfg.ssm_state, cfg.dt_rank
        bcdt = xh @ self.x_proj.to(dt_)                        # (B,S,rank+2N)
        dt_raw, bmat, cmat = torch.split(bcdt, [rank, n, n], dim=-1)
        # softplus in the activation dtype, as the reference takes it
        dt = F.softplus(dt_raw @ self.dt_w.to(dt_) + self.dt_b.to(dt_))
        A = -torch.exp(self.a_log.float())
        return dt, A, bmat.contiguous(), cmat.contiguous()

    def forward(self, x: torch.Tensor, cfg: ModelConfig, *,
                cache: Optional[Dict[str, torch.Tensor]] = None,
                pos: Optional[int] = None, make_cache: bool = False):
        if cache is not None and x.shape[1] == 1:
            return self._decode(x, cfg, cache)
        b, s, _ = x.shape
        dt_ = x.dtype
        kc = cfg.ssm_conv
        xh, z = self._split_xz(x)
        xh = sharding.constrain(xh, sharding.mamba_conv_state_spec())
        pad = torch.zeros((b, kc - 1, cfg.d_inner), dtype=dt_,
                          device=x.device)
        xp = torch.cat([pad, xh], dim=1)                       # (B,S+kc-1,di)
        conv_tail = (xp[:, xp.shape[1] - (kc - 1):].clone() if make_cache
                     else None)
        xc = F.silu(_conv(xp, self.conv_w.to(dt_), s) + self.conv_b.to(dt_))
        # each (B,S,di) temporary goes once read (8.6 GB at B 1 x S 524,288
        # of falcon-mamba-7b): the block peaks under six of them, not nine
        del xp
        dt, A, bmat, cmat = self._ssm_params(xc, cfg)
        y, h = ops.selective_scan(xc, dt, A, bmat, cmat, self.d_skip.float(),
                                  impl=cfg.attention_impl,
                                  chunk=cfg.mamba_chunk)
        del xc, dt
        y = (y * F.silu(z)).to(dt_)
        out = y @ self.out_proj.to(dt_)

        new_state = None
        if make_cache:
            new_state = {"h": h.float(), "conv": conv_tail}
        return out, new_state

    def _decode(self, x, cfg, state):
        """Single-token recurrence step."""
        dt_ = x.dtype
        xh, z = self._split_xz(x)                              # (B,1,di) each
        conv_in = torch.cat([state["conv"].to(dt_), xh], dim=1)
        xc = F.silu(_conv(conv_in, self.conv_w.to(dt_), 1)
                    + self.conv_b.to(dt_))                     # (B,1,di)

        dt, A, bmat, cmat = self._ssm_params(xc, cfg)
        dtf = dt[:, 0].float()                                 # (B,di)
        xf = xc[:, 0].float()
        h = state["h"].float()                                 # (B,di,N)
        decay = torch.exp(dtf[..., None] * A[None])
        h = decay * h + (dtf * xf)[..., None] * bmat[:, 0].float()[:, None, :]
        y = (h * cmat[:, 0].float()[:, None, :]).sum(dim=-1) \
            + self.d_skip.float() * xf                         # (B,di)
        y = (y[:, None, :] * F.silu(z).float()).to(dt_)
        out = y @ self.out_proj.to(dt_)
        return out, {"h": h, "conv": conv_in[:, 1:]}


def mamba_state_def(cfg: ModelConfig, batch: int):
    di, n, kc = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return {"h": ParamDef((batch, di, n), ("batch", "inner", "state"),
                          ("zeros",)),
            "conv": ParamDef((batch, kc - 1, di), ("batch", "convk", "inner"),
                             ("zeros",))}
