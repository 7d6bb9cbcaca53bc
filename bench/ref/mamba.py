"""Mamba-1 mixer in plain torch, as the port runs it.

Keys of the configuration read here: ``hidden_size``, ``expand``,
``state_size``, ``conv_kernel`` and ``time_step_rank``.  The equations:
``x, z = split(u Win)``; ``xc = silu(causal depthwise conv(x) + b)``;
``dt_raw, B, C = split(xc Wx)``; ``dt = softplus(dt_raw Wdt + b_dt)``;
``A = -exp(A_log)``; ``h_t = exp(dt_t A) h_(t-1) + dt_t x_t B_t``;
``y_t = h_t . C_t + D x_t``; ``out = (y * silu(z)) Wout``.  Falcon Mamba
publishes RMS norms on B, C and dt, which the port does not apply; the
configuration file records that departure, and this file follows the
port's equations.

The scan runs step by step.  Under autograd it is cut into chunks of
``SCAN_CHUNK`` steps, each recomputed in the backward pass
(``torch.utils.checkpoint``), so that one chunk's states are held at a
time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

#: leaves used as the weights of matrix products
MATMUL = ("in_proj", "x_proj", "dt_w", "out_proj")
#: steps of the scan recomputed together in the backward pass
SCAN_CHUNK = 256


def _dims(cfg):
    d = cfg["hidden_size"]
    return (d, cfg["expand"] * d, cfg["state_size"], cfg["conv_kernel"],
            cfg["time_step_rank"])


def schema(cfg, n_layers):
    d, di, n, kc, rank = _dims(cfg)
    out_std = 0.02 / math.sqrt(2 * n_layers)
    return [("in_proj", (d, 2 * di), ("normal", 0.02)),
            ("conv_w", (kc, di), ("normal", 0.1)),
            ("conv_b", (di,), ("zeros",)),
            ("x_proj", (di, rank + 2 * n), ("normal", 0.02)),
            ("dt_w", (rank, di), ("normal", 0.02)),
            ("dt_b", (di,), ("const", -4.6)),
            ("a_log", (di, n), ("a_log",)),
            ("d_skip", (di,), ("ones",)),
            ("out_proj", (di, d), ("normal", out_std))]


def scan_steps(x, dt, bm, cm, h, A, D):
    """``(y, h_last)`` of the recurrence over the steps of ``x`` ``(B,L,di)``
    from the state ``h`` ``(B,di,N)``."""
    # unbound once: one autograd node hands every step its slice (a slice
    # taken step by step would build a full-size gradient at each step)
    decays = torch.exp(dt[..., None] * A).unbind(1)       # (B,di,N) a step
    incs = ((dt * x)[..., None] * bm[:, :, None, :]).unbind(1)
    hs = []
    for a, b in zip(decays, incs):
        h = torch.addcmul(b, a, h)
        hs.append(h)
    y = (torch.stack(hs, dim=1) * cm[:, :, None, :]).sum(-1) + D * x
    return y, h


def scan(x, dt, bm, cm, A, D):
    b, _, di = x.shape
    h = x.new_zeros((b, di, A.shape[1]))
    ys = []
    for chunk in zip(*(t.split(SCAN_CHUNK, dim=1) for t in (x, dt, bm, cm))):
        args = (*chunk, h, A, D)
        if torch.is_grad_enabled():
            y, h = checkpoint.checkpoint(scan_steps, *args,
                                         use_reentrant=False)
        else:
            y, h = scan_steps(*args)
        ys.append(y)
    return torch.cat(ys, dim=1)


def forward(p, u, cfg, prec, q_block=None):
    _, di, n, kc, rank = _dims(cfg)
    s = u.shape[1]
    x, z = torch.chunk(prec.mm(u, p["in_proj"]), 2, dim=-1)
    xp = F.pad(x, (0, 0, kc - 1, 0))
    conv = sum(xp[:, i:i + s] * p["conv_w"][i] for i in range(kc))
    xc = F.silu(conv + p["conv_b"])
    dt_raw, bm, cm = torch.split(prec.mm(xc, p["x_proj"]), [rank, n, n],
                                 dim=-1)
    dt = F.softplus(prec.mm(dt_raw, p["dt_w"]) + p["dt_b"])
    y = scan(xc, dt, bm, cm, -torch.exp(p["a_log"]), p["d_skip"])
    return prec.mm(y * F.silu(z), p["out_proj"])
