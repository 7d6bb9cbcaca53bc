"""The yardstick: the H100's published peaks and the frozen operation and
byte counts that rooflines and ``mfu`` divide by.

Every count is a function of the shapes alone (the configuration file and
the traffic file), never of the program, so a kernel's roofline reads the
same work whatever implements it.  The kernel counts are copies of the
port's ``roofline.attn_cost`` / ``roofline.scan_cost`` as they stood when
the benchmark was defined; the model counts are 2·N·T for inference and
6·N·T for training, N the weights of matrix products (the embedding table
is a lookup and is not counted), plus the attention products.
"""

from __future__ import annotations

import math

from .ref import model as ref_model

#: NVIDIA H100 SXM5 data sheet, dense BF16 tensor-core rate (FLOP/s)
BF16_FLOPS = 989e12
#: same data sheet, HBM3 bandwidth (bytes/s)
HBM_BYTES_PER_S = 3.35e12
#: same data sheet, FP32 rate outside the tensor cores (FLOP/s)
FP32_FLOPS = 67e12
#: exponentials a second on the special-function units: 132 SMs x 16
#: results a clock an SM (CUDA C++ Programming Guide, arithmetic
#: instruction throughput, compute capability 9.0) x the 1.98 GHz boost
#: clock
SFU_EXPS_PER_S = 132 * 16 * 1.98e9


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def causal_pairs(sq: int, skv: int, q_offset: int = 0) -> int:
    """(query, key) pairs a causal mask keeps: query ``i`` sees keys
    ``0..q_offset + i`` of the ``skv`` there are."""
    lin = min(max(skv - q_offset, 0), sq)
    return lin * q_offset + lin * (lin + 1) // 2 + (sq - lin) * skv


def attn_flops(b, sq, skv, h, hd, q_offset=0) -> float:
    """4 hd FLOPs (S = Q K^T and P V) per kept pair, a head."""
    return 4.0 * hd * causal_pairs(sq, skv, q_offset) * b * h


def attn_bytes(b, sq, skv, h, kv, hd, elem) -> float:
    """q, k, v read and o and a float32 lse a row and head written once."""
    return float(elem * (2 * b * sq * h * hd + 2 * b * skv * kv * hd)
                 + 4 * b * sq * h)


def attn_least_s(b, sq, skv, h, kv, hd, elem) -> float:
    """The least time of one causal attention launch on the card."""
    return max(attn_flops(b, sq, skv, h, hd) / BF16_FLOPS,
               attn_bytes(b, sq, skv, h, kv, hd, elem) / HBM_BYTES_PER_S)


def scan_least_s(b, s, di, n, elem) -> float:
    """The least time of one selective-scan launch: x, dt, B, C, A, D read
    and y and the final state written once; one exponential a (b, t, d,
    n) on the special-function units; 6 float32 operations a (b, t, d, n)
    and 3 a (b, t, d) outside the tensor cores."""
    nbytes = elem * (3 * b * s * di + 2 * b * s * n) + 4 * (di * n + di) \
        + 4 * b * di * n
    return max(nbytes / HBM_BYTES_PER_S, b * s * di * n / SFU_EXPS_PER_S,
               (6 * b * s * di * n + 3 * b * s * di) / FP32_FLOPS)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def unembed_weights(cfg) -> int:
    return cfg["hidden_size"] * cfg["vocab_size"]


def matmul_weights(cfg) -> int:
    """Weights of matrix products a token passes through: every layer's
    (its kind's ``MATMUL`` leaves) and the unembedding."""
    total = unembed_weights(cfg)
    for name, shape, _ in ref_model.schema(cfg):
        parts = name.split(".")
        if parts[0] != "layers" or len(parts) != 4:
            continue
        i, part, leaf = int(parts[1]), parts[2], parts[3]
        if part not in ("mixer", "ffn"):
            continue
        mixer, ffn = ref_model.blocks(cfg)[i]
        if leaf in ref_model.kind(mixer if part == "mixer" else ffn).MATMUL:
            total += math.prod(shape)
    return total


def attention(cfg):
    """``(attention layers, heads, kv heads, head size)``."""
    n = sum(mixer == "attn" for mixer, _ in ref_model.blocks(cfg))
    if not n:
        return 0, 0, 0, 0
    h = cfg["num_attention_heads"]
    return (n, h, cfg["num_key_value_heads"],
            cfg.get("head_dim") or cfg["hidden_size"] // h)


def train_step_flops(cfg, b: int, s: int) -> float:
    """6 N T, and the attention products three times over (forward, and
    twice that in the backward; the recompute of the scores not
    counted)."""
    n_attn, h, _, hd = attention(cfg)
    return 6.0 * matmul_weights(cfg) * b * s \
        + 3.0 * n_attn * attn_flops(b, s, s, h, hd)


def prefill_least_s(cfg, b: int, s: int, elem: int = 2) -> float:
    """One prefill of ``b`` prompts of ``s`` tokens that serves the next
    token: 2 N T, the unembedding at the last position only, and the
    causal attention; or the bf16 weights read once, if longer."""
    n_attn, h, _, hd = attention(cfg)
    flops = 2.0 * (matmul_weights(cfg) - unembed_weights(cfg)) * b * s \
        + 2.0 * unembed_weights(cfg) * b + n_attn * attn_flops(b, s, s, h, hd)
    return max(flops / BF16_FLOPS,
               elem * matmul_weights(cfg) / HBM_BYTES_PER_S)


def decode_step_least_s(cfg, b: int, pos: int, elem: int = 2) -> float:
    """One decode step of ``b`` rows at position ``pos``: 2 N and the
    attention over keys ``0..pos`` a row; or the weights and those keys
    and values read once (and the new ones written), if longer."""
    n_attn, h, kv, hd = attention(cfg)
    flops = 2.0 * matmul_weights(cfg) * b \
        + n_attn * attn_flops(b, 1, pos + 1, h, hd, q_offset=pos)
    nbytes = elem * matmul_weights(cfg) \
        + n_attn * elem * 2 * b * (pos + 1) * kv * hd
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
