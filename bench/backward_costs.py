"""The frozen least time of the scan's backward, beside ``costs.py``'s
counts of the forward kernels (a module of its own: the benchmark's
existing files stay as they were defined).

The count is a copy of the port's ``roofline.scan_bwd_cost`` as it stood
when this metric was defined, and like every count here a function of the
shapes alone: the work of the gradient, never what an implementation
recomputes, so that no kernel can read over 100% of it.
"""

from __future__ import annotations

from .costs import FP32_FLOPS, HBM_BYTES_PER_S, SFU_EXPS_PER_S


def scan_bwd_least_s(b, s, di, n, elem) -> float:
    """The least time of one launch of the selective scan's backward: x,
    dt, dy, B, C, A, D read and dx, ddt, dB, dC, dA, dD written once; one
    exponential a (b, t, d, n) on the special-function units; and outside
    the tensor cores, a (b, t, d, n), 15 float32 operations (dt·A; the
    carry exp·g_{t+1}, C·dy and their add; Σ_n B·g, 2; z = carry·h_{t-1};
    Σ_n A·z, 2; dA's dt·z and sum, 2; dB's u·g and dC's h·dy with their
    sums over channels, 4) and, a (b, t, d), 7 (dx = dt·du + D·dy, 3;
    ddt = x·du + Σ_n A·z, 2; dD's x·dy and sum, 2)."""
    nbytes = elem * (5 * b * s * di + 4 * b * s * n) + 8 * (di * n + di)
    return max(nbytes / HBM_BYTES_PER_S, b * s * di * n / SFU_EXPS_PER_S,
               (15 * b * s * di * n + 7 * b * s * di) / FP32_FLOPS)
