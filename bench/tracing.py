"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over the
first units of the window, reduced to what the per-layer readers take.

The traced window is a ``record_function`` marker around those units,
closed after the device is synchronised, so every kernel they launched
lies inside it.  The reduction keeps each kernel's name, start and length;
the device time under each autograd node (``...Backward``), which the
profiler attributes through the ops that launched the kernels; the busy
seconds (the union of kernel intervals) and the breakdown the result line
carries.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

MARKER = "bench.traced_window"


@dataclasses.dataclass
class Trace:
    units: int
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float, float]]     # (name, start s, length s)
    nodes: Dict[str, float]                     # autograd node -> device s
    breakdown: Dict[str, list]

    def kernel_seconds(self, match) -> Tuple[int, float]:
        """``(launches, device seconds)`` of the kernels whose name
        ``match(name)`` accepts."""
        hits = [length for name, _, length in self.kernels if match(name)]
        return len(hits), sum(hits)


def _device_total(evt) -> float:
    """An event's device time with its children's, in microseconds."""
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _union(intervals, lo, hi) -> Tuple[float, List[Tuple[float, float]]]:
    """Covered length of ``intervals`` clipped to ``[lo, hi]``, and the gaps
    between them inside it."""
    busy, gaps, at = 0.0, [], lo
    for start, end in sorted(intervals):
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        if start > at:
            gaps.append((at, start))
        if end > at:
            busy += end - max(start, at)
            at = end
    if hi > at:
        gaps.append((at, hi))
    return busy, gaps


def summarize(prof, units: int) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    marks = [e for e in events if e.name == MARKER]
    if not marks:
        raise RuntimeError("trace: the traced window's marker is missing")
    lo = min(e.time_range.start for e in marks)
    hi = max(e.time_range.end for e in marks)
    kernels, host, nodes = [], [], defaultdict(float)
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name != MARKER:
            kernels.append((e.name, e.time_range.start, e.time_range.end))
        elif e.device_type != DeviceType.CUDA and e.name != MARKER:
            host.append((e.time_range.start, e.time_range.end, e.name))
            if "Backward" in e.name:
                nodes[e.name] += _device_total(e) / 1e6
    busy, gaps = _union([(s, t) for _, s, t in kernels], lo, hi)

    by_name = defaultdict(float)
    for name, start, end in kernels:
        by_name[name] += (end - start) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    def doing(t):
        """The innermost host event running at ``t``."""
        inside = [(end - start, name) for start, end, name in host
                  if start <= t <= end]
        return "host:" + (min(inside)[1] if inside else "nothing")

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = [[doing((a + b) / 2), (b - a) / 1e6] for a, b in longest]
    return Trace(units=units, window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                 kernels=[(n, s / 1e6, (t - s) / 1e6) for n, s, t in kernels],
                 nodes=dict(nodes),
                 breakdown={"device_ops": [[n[:64], s] for n, s in ops],
                            "idle_gaps": idle})
