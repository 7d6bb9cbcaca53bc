"""Grouped-query self-attention with rotary positions, in plain torch.

Keys of the configuration read here: ``hidden_size``,
``num_attention_heads``, ``num_key_value_heads``, ``head_dim`` (default
``hidden_size // num_attention_heads``) and ``rope_theta``.  Rotary
embeddings rotate the two halves of each head (the ``rotate_half`` form)
by ``theta ** (-i / (hd / 2))``; query head ``j`` reads key-value head
``j // (heads / kv_heads)``; scores are scaled by ``hd ** -0.5`` and
masked causally.  Queries are taken ``q_block`` rows at a time, each
block against the keys up to its last row, so a 32k-long row fits.
"""

from __future__ import annotations

import math

import torch

#: leaves used as the weights of matrix products
MATMUL = ("wq", "wk", "wv", "wo")


def _dims(cfg):
    d = cfg["hidden_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return d, h, kv, cfg.get("head_dim") or d // h


def schema(cfg, n_layers):
    d, h, kv, hd = _dims(cfg)
    out_std = 0.02 / math.sqrt(2 * n_layers)
    return [("wq", (d, h * hd), ("normal", 0.02)),
            ("wk", (d, kv * hd), ("normal", 0.02)),
            ("wv", (d, kv * hd), ("normal", 0.02)),
            ("wo", (h * hd, d), ("normal", out_std))]


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, hd), positions 0..S-1."""
    s, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def forward(p, x, cfg, prec, q_block=None):
    b, s, _ = x.shape
    d, h, kv, hd = _dims(cfg)
    q = rope(prec.mm(x, p["wq"]).view(b, s, h, hd), cfg["rope_theta"])
    k = rope(prec.mm(x, p["wk"]).view(b, s, kv, hd), cfg["rope_theta"])
    v = prec.mm(x, p["wv"]).view(b, s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=2).transpose(1, 2)    # (B,H,S,hd)
    v = v.repeat_interleave(h // kv, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    q_block = q_block or s
    outs = []
    for q0 in range(0, s, q_block):
        q1 = min(s, q0 + q_block)
        scores = prec.mm(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) \
            / math.sqrt(hd)
        rows = torch.arange(q0, q1, device=x.device)[:, None]
        cols = torch.arange(q1, device=x.device)[None, :]
        scores = scores.masked_fill(cols > rows, float("-inf"))
        outs.append(prec.mm(torch.softmax(scores, dim=-1), v[:, :, :q1]))
    out = torch.cat(outs, dim=2).transpose(1, 2).reshape(b, s, h * hd)
    return prec.mm(out, p["wo"])
