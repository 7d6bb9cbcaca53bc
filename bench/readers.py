"""What the metric readers under ``bench/metrics/`` share.

Each reader is ``read(run) -> float | None`` over a
:class:`bench.harness.Run`; it returns None where the run holds nothing
for it (another kind of traffic, no trace, no launch of its kernel).
"""

from __future__ import annotations

import math
import re
import statistics

from . import costs


def rate(run, kind):
    """Tokens of every whole unit of the window over the window's time."""
    if run.kind != kind:
        return None
    return run.window.rate()


def percentile(values, q):
    """The ``q``-th percentile, linear between the nearest ranks."""
    xs = sorted(values)
    at = (len(xs) - 1) * q / 100
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def tpot_p95_ms(run):
    if run.kind != "decode" or not run.window.gaps_s:
        return None
    return percentile(run.window.gaps_s, 95) * 1e3


def ttft_p50_ms(run):
    if run.kind != "prefill":
        return None
    return statistics.median(u["wall_s"] for u in run.window.units) * 1e3


def mfu(run, kind):
    """The whole window's share of the bf16 peak: the frozen least time of
    each unit (training: its model FLOPs at the peak) over the window's
    time, in %."""
    if run.kind != kind:
        return None
    cfg, tr, w = run.cell.config, run.cell.traffic, run.window
    if kind == "train":
        least = costs.train_step_flops(cfg, tr["batch"], tr["seq"]) \
            / costs.BF16_FLOPS * len(w.units)
    elif kind == "prefill":
        least = costs.prefill_least_s(cfg, tr["batch"], tr["prompt"]) \
            * len(w.units)
    else:
        least = sum(costs.decode_step_least_s(cfg, tr["batch"], u["pos"])
                    for u in w.units)
    return 100.0 * least / w.seconds


def device_idle(run, kind):
    t = run.trace
    if run.kind != kind or t is None or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def peak_mem_gb(run, kind):
    if run.kind != kind or not run.window.peak_bytes:
        return None
    return run.window.peak_bytes / 1e9


def node_ms(run, kind, node):
    """Device ms a unit under the autograd node ``node``."""
    t = run.trace
    if run.kind != kind or t is None:
        return None
    total = t.nodes.get(node) or t.nodes.get(
        f"autograd::engine::evaluate_function: {node}")
    if not total:
        return None
    return total / t.units * 1e3


def kernel_roofline(run, kind, pattern, least_s):
    """Each launch's frozen least time over the device time of the kernels
    whose name matches ``pattern``, in %."""
    t = run.trace
    if run.kind != kind or t is None:
        return None
    n, seconds = t.kernel_seconds(re.compile(pattern).search)
    if not n or seconds <= 0:
        return None
    return 100.0 * n * least_s / seconds


def attention_shape(run, seq_key):
    """The launch shape of the cell's causal self-attention."""
    cfg, tr = run.cell.config, run.cell.traffic
    n_attn, h, kv, hd = costs.attention(cfg)
    return tr["batch"], tr[seq_key], tr[seq_key], h, kv, hd

