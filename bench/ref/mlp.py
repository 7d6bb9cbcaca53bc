"""SwiGLU feed-forward in plain torch: ``(silu(x Wg) * x Wu) Wd``.

Keys of the configuration read here: ``hidden_size``,
``intermediate_size``.
"""

from __future__ import annotations

import math

import torch.nn.functional as F

#: leaves used as the weights of matrix products
MATMUL = ("wg", "wu", "wd")


def schema(cfg, n_layers):
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    out_std = 0.02 / math.sqrt(2 * n_layers)
    return [("wg", (d, f), ("normal", 0.02)),
            ("wu", (d, f), ("normal", 0.02)),
            ("wd", (f, d), ("normal", out_std))]


def forward(p, x, cfg, prec, q_block=None):
    return prec.mm(F.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wu"]),
                   p["wd"])
