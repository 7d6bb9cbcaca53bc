"""Shared benchmark fixtures: catalog, the paper's 20 scenarios, where a
driver's device legs run, and the masks that make two runs' records and
lines comparable."""

from __future__ import annotations

import fnmatch
import re
import subprocess
from typing import List, Tuple

from ..core import Request, generate_catalog, get_backend
from ..examples import masked_walls

#: the record fields that hold a wall, a ratio of walls or another
#: measurement of the host (``fnmatch`` patterns): every driver's
#: ``us_per_call``; fig6b's, fig7's and the benches' ``wall_s``; fig12's
#: ``recovery_s_ours``; bench_risk's ``decision_overhead_us``;
#: bench_solver's cycle walls, speedups and ``tracemalloc`` peaks;
#: bench_backend's walls a contender, first calls, compiles and speedups;
#: bench_scale's walls a backend and its 1M-vs-5k ratio; bench_fleet's
#: rates and speedups; elastic_training's rates and recovery walls
WALL_FIELDS = (
    "us_per_call", "wall_s", "recovery_s_ours", "decision_overhead_us",
    "*_wall_s", "*_ms_per_decision", "*_first_call_s", "*_compile_s",
    "cycle_us_*", "*speedup*", "solve_peak_bytes_*",
    "fused_vs_batched_numpy*", "fused_vs_per_dispatch_*",
    "fused_steady_faster_than_numpy", "pr1_meets_target",
    "scale_ratio_1m_vs_5k", "meets_2x_target", "wall_5k_s", "wall_1m_s",
    "*_ms_per_replica", "*_replicas_per_s", "hetero_meets_target",
    "steps_per_s", "mean_recovery_s")
#: the benches' record of the host they ran on
PLATFORM_FIELDS = ("python", "numpy", "machine")
#: per driver, the fields it derives from walls under a name that another
#: driver's record holds an exact value in: bench_fleet's ``meets_target``
#: is a speedup's verdict, bench_chaos's and bench_region's a cost ratio's
OWN_WALL_FIELDS = {"bench_fleet": ("meets_target",)}
#: per driver, what its line prints from a wall beyond ``us_per_call``
#: and the ``{:.2f}s`` walls: bench_solver's cycle walls, speedup and
#: ``tracemalloc`` peaks; bench_backend's walls and speedups (``n/a`` and
#: ``None`` where a leg did not run); bench_scale's ratio, verdict and
#: 1M wall; bench_fleet's speedups and their verdict; elastic_training's
#: step rate and recovery and provisioning walls
LINE_WALLS = {
    "bench_solver": (r"\d+us\(vs\d+us,\d+(\.\d+)?x,mem\d+Kvs\d+K\)",),
    "bench_backend": (r"(?<=:)(\d+(\.\d+)?|None|n/a)(?=[sx])",),
    "bench_scale": (r"(?<=ratio_1m_vs_5k:)\d+(\.\d+)?",
                    r"(?<=meets_2x:)(True|False)",
                    r"(?<=1m_best:)\d+(\.\d+)?(e-?\d+)?"),
    "bench_fleet": (r"(?<=storm:)\d+(\.\d+)?(?=x)",
                    r"(?<=crunch:)\d+(\.\d+)?(?=x)",
                    r"(?<=hetero:)\d+(\.\d+)?(?=x)",
                    r"(?<=x:)(met|MISSED)$"),
    "elastic_training": (r"(?<=steps_per_s=)\d+\.\d+",
                         r"(?<=recovery=)\d+\.\d+",
                         r"(?<=provision=)\d+\.\d+"),
}

#: §5.1: Cartesian {10,50,100,400,1000} × {(1,2),(2,2),(1,4)} + 5 irregular
SCENARIOS: List[Tuple[int, float, float]] = (
    [(p, c, m) for p in (10, 50, 100, 400, 1000)
     for c, m in ((1, 2), (2, 2), (1, 4))]
    + [(17, 7, 7), (75, 3, 5), (115, 4, 2), (287, 1, 6), (439, 1, 9)]
)


def catalog(seed: int = 0, max_offerings: int = 2000):
    return generate_catalog(seed=seed, max_offerings=max_offerings)


def requests() -> List[Request]:
    return [Request(pods=p, cpu_per_pod=c, mem_per_pod=m)
            for p, c, m in SCENARIOS]


def default_device() -> str:
    """Where a driver's device work runs when the caller names no device:
    the process default backend's device — ``"cpu"`` under ``torch:cpu``
    / ``torch:fused:cpu`` — else ``"cuda"`` (``numpy`` included, so a
    host without a card names the CPU or the device work raises)."""
    dev = getattr(get_backend(), "device", None)
    return "cpu" if dev is not None and dev.type == "cpu" else "cuda"


def device_specs(device=None) -> Tuple[str, str]:
    """The per-dispatch and fused backend specs of a driver's device legs:
    ``("torch", "torch:fused")`` on the card, ``("torch:cpu",
    "torch:fused:cpu")`` for ``device="cpu"``; ``None`` is
    :func:`default_device`."""
    device = str(device or default_device())
    if device == "cpu":
        return "torch:cpu", "torch:fused:cpu"
    if device == "cuda":
        return "torch", "torch:fused"
    raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")


def device_line(backend) -> str:
    """Where ``backend`` solves: the card's ``nvidia-smi`` name and power
    limit for a device backend, else ``"cpu"``."""
    device = getattr(backend, "device", None)
    if device is None or device.type == "cpu":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout.strip()


def masked_csv(text: str) -> str:
    """The runner's ``name,us_per_call,derived`` lines with every field
    that prints a wall masked: each line's ``us_per_call``, the ``{:.2f}s``
    walls (:func:`repro_torch.examples.masked_walls`), fig12's
    ``recovery_ours=0.06s`` (``_`` follows it, so ``\\b`` finds no edge
    there), bench_risk's ``overhead=1.379x`` (a ratio of two walls) and
    each driver's :data:`LINE_WALLS`: what two runs of one driver print
    alike."""
    lines = []
    for line in text.split("\n"):
        fields = line.split(",", 2)
        if len(fields) == 3 and fields[0] != "name":
            fields[1] = "<us>"
            for pattern in LINE_WALLS.get(fields[0], ()):
                fields[2] = re.sub(pattern, "<w>", fields[2])
        lines.append(",".join(fields))
    text = masked_walls("\n".join(lines))
    text = re.sub(r"recovery_ours=\d+\.\d\ds", "recovery_ours=<s>", text)
    return re.sub(r"overhead=\d+(\.\d+)?x", "overhead=<x>", text)


def without(record, fields=WALL_FIELDS):
    """``record`` with each dict key matching a pattern of ``fields``
    (``fnmatch``; a name without wildcards matches itself) dropped at any
    depth, and inside a driver's record (a dict with its ``benchmark``
    name) that driver's :data:`OWN_WALL_FIELDS` too (tuples become
    lists): what two runs of one driver return alike."""
    if isinstance(record, dict):
        name = record.get("benchmark")
        if isinstance(name, str):
            fields = tuple(fields) + OWN_WALL_FIELDS.get(name, ())
        return {k: without(v, fields) for k, v in record.items()
                if not any(fnmatch.fnmatchcase(k, f) for f in fields)}
    if isinstance(record, (list, tuple)):
        return [without(v, fields) for v in record]
    return record
