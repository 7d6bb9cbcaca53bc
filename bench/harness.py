"""One run of one benchmark cell: set-up, the measured window, the check
against the plain reference, the metrics and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the workload's configuration file, its traffic mix
(``bench/traffic/<traffic>.json``, whose ``kind`` names the driver module
``bench.drivers.<kind>``), its limits (``bench/limits/<workload>.json``)
and each metric's reader (``bench/metrics/<metric>.py``, a ``read(run)``
that returns a number, or None where it finds nothing to read).  A cell,
a traffic mix or a metric is added by adding files and entries.

A driver is a class ``Driver(cell, seed, device)`` whose constructor is
the set-up (weights from the seed, warm-up of the cell's own shapes), with
``synchronous``, ``unit(i)`` (one step or request of the window; returns
``{"tokens": n, ...}``), ``free()`` (drops the program's state) and
``check(control)`` (the numbers compared with the reference; with
``control``, also the control's).
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from . import tracing
from .ref.precision import strict_float32

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def derive(seed: int, *parts) -> int:
    """A 63-bit seed for one stream of the run (``"weights"``, ``("batch",
    i)``, ...), the same for the same ``seed`` and parts."""
    digest = hashlib.blake2b(repr((int(seed),) + parts).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: Path

    def metrics(self, traced: bool) -> List[dict]:
        return self.per_layer if traced else self.end_to_end


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    spec = read_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = read_json(root / configs[w["config"]]["file"])
    traffic = read_json(root / "bench" / "traffic" / f"{w['traffic']}.json")
    limits = read_json(root / "bench" / "limits" / f"{workload}.json")
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in reported)]
    return Cell(workload, w["chips"], config, traffic, limits, e2e,
                per_layer, root)


# ---------------------------------------------------------------------------
# The program, as the configuration file asks for it
# ---------------------------------------------------------------------------

def program_config(config: dict):
    """The port's ``ModelConfig`` for a configuration file: its registered
    architecture (``port.arch``, ``port.smoke``), cut to
    ``num_hidden_layers`` and with ``port.overrides``; each of
    ``port.fields`` must read as the file says."""
    from repro_torch.configs import get_config

    port = config["port"]
    pc = get_config(port["arch"], smoke=port.get("smoke", False))
    n = config["num_hidden_layers"]
    pc = dataclasses.replace(pc, n_layers=n, layout=pc.layout[:n],
                             **port.get("overrides", {})).validate()
    wrong = {k: (getattr(pc, k), v) for k, v in port["fields"].items()
             if getattr(pc, k) != v}
    if wrong:
        raise ValueError(f"{config['name']}: the port's config differs from "
                         f"the file (got, want): {wrong}")
    return pc


def program_params(config: dict, pc, seed: int, device):
    """The port's parameter module for ``pc``, filled with the benchmark's
    weights for ``seed`` (:mod:`bench.weights`), leaf by leaf by name."""
    from repro_torch.models.transformer import Transformer

    from . import weights
    from .ref import model as ref_model

    schema = ref_model.schema(config)
    params = Transformer(pc, device)
    named = dict(params.named_parameters())
    want = {name: tuple(shape) for name, shape, _ in schema}
    got = {name: tuple(t.shape) for name, t in named.items()}
    if want != got:
        only_port = sorted(set(got.items()) - set(want.items()))[:8]
        only_ref = sorted(set(want.items()) - set(got.items()))[:8]
        raise ValueError(f"{config['name']}: the port's leaves differ from "
                         f"the reference's: only the port {only_port}, only "
                         f"the reference {only_ref}")
    with torch.no_grad():
        for name, t in weights.make(schema, derive(seed, "weights"), device):
            named[name].copy_(t)
    return params


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Window:
    seconds: float                 # start to the end of the last unit
    units: List[dict]              # each unit's info; "wall_s" if synchronous
    gaps_s: List[float]            # device time between consecutive units
    peak_bytes: int                # allocator peak inside the window

    @property
    def tokens(self) -> int:
        return sum(u["tokens"] for u in self.units)

    def rate(self) -> float:
        return self.tokens / self.seconds


def _stamp(cuda: bool):
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def traced_units(driver, n: int, device):
    """The next ``n`` units under ``torch.profiler``, inside the marker of
    :mod:`bench.tracing`, the device synchronised before it closes; returns
    the finished profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync(device)
    with profile(activities=acts) as prof:
        with record_function(tracing.MARKER):
            for i in range(n):
                driver.unit(i)
            sync(device)
    return prof


def measure(driver, seconds: float, device, first: int = 0) -> Window:
    """Units back to back, numbered from ``first``, until the first that
    ends ``seconds`` after the start (for an asynchronous driver: is
    enqueued then); the device is synchronised at the close."""
    cuda = torch.device(device).type == "cuda"
    sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    gc.collect()
    gc.disable()
    try:
        units, marks = [], [_stamp(cuda)]
        t0 = last = time.perf_counter()
        while True:
            info = driver.unit(first + len(units))
            marks.append(_stamp(cuda))
            now = time.perf_counter()
            if driver.synchronous:
                info["wall_s"] = now - last
                last = now
            units.append(info)
            if now - t0 >= seconds:
                break
        sync(device)
        t_end = time.perf_counter()
    finally:
        gc.enable()
    if cuda:
        gaps = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated(device)
    else:
        gaps = [b - a for a, b in zip(marks, marks[1:])]
        peak = 0
    return Window(t_end - t0, units, gaps, peak)


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window: Window
    trace: Optional[tracing.Trace]

    @property
    def kind(self) -> str:
        return self.cell.traffic["kind"]


def reader(cell: Cell, name: str):
    path = cell.root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def judge(numbers: Dict[str, float], limits: dict):
    """``(correct, checks)``: every number with a limit present, finite and
    at most its limit."""
    checks = {}
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        checks[name] = {"value": value, "limit": lim["limit"]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    return correct, checks


def driver_class(cell: Cell):
    return importlib.import_module(
        f"{__package__}.drivers.{cell.traffic['kind']}").Driver


def release(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, control: bool = False):
    """One run: ``(result, numbers, control numbers)``.  ``t_start`` is
    when the process began (set-up counts from it)."""
    driver = driver_class(cell)(cell, seed, device)
    sync(device)
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if torch.device(device).type == "cuda" else 0)
    t_window = time.perf_counter()
    summary, first = None, 0
    if traced:
        # the traced units come before the window and are not timed in it
        first = cell.traffic["trace_units"]
        summary = tracing.summarize(traced_units(driver, first, device),
                                    first)
    window = measure(driver, seconds, device, first)
    the_run = Run(cell, t_window - t_start, window, summary)
    metrics = {}
    for m in cell.metrics(traced):
        value = reader(cell, m["name"])(the_run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    peak = max(setup_peak, window.peak_bytes)
    driver.free()
    release(device)
    t_check = time.perf_counter()
    strict_float32()
    numbers, control_numbers = driver.check(control)
    print(f"bench: {cell.name} set-up {the_run.setup_s:.1f} s, window "
          f"{window.seconds:.1f} s, check {time.perf_counter() - t_check:.1f}"
          f" s", file=sys.stderr)
    del driver
    release(device)
    correct, checks = judge(numbers, cell.limits)
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(window.units),
              "failed": 0, "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown
    result["checks"] = checks
    return result, numbers, control_numbers


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one benchmark cell once "
                                 "and print its result as the last line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, numbers, _ = run(cell, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             t_start)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the run loaded {loaded}", file=sys.stderr)
        return 4
    for name, value in numbers.items():
        if name not in result["checks"]:
            print(f"bench: reading {name} {value!r} (not compared)",
                  file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"bench: check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0
