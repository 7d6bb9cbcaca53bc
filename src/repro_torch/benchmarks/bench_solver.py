"""Solver microbenchmark: full guarded-GSS provisioning cycles, engine vs
the seed history-matrix solver, across market sizes and demands.

Returns (and with ``--json`` writes) a performance record:

  * ``cycle_us_engine``      — batched prescan + compiled-market GSS
                               (compilation included, as in `provision()`)
  * ``cycle_us_engine_warm`` — compiled market reused (§4.1 re-optimization)
  * ``cycle_us_reference``   — seed solver driven per-α (the pre-engine path)
  * single-solve peak allocations (tracemalloc) at a residual-heavy α, plus
    the analytic size of the seed's O(bundles × residual) history matrix.

The engine solves on the process-default backend
(``KUBEPACS_SOLVER_BACKEND``, the card's ``torch`` unless set), handed
explicitly to every engine call; the seed solver is NumPy.  ``tracemalloc``
sees host allocations only, so a device backend's peak leaves out what
it holds on the card.

Usage:
  python -m repro_torch.benchmarks.bench_solver [--smoke] [--json PATH]
                                                [--repeat N]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
import tracemalloc
from typing import List, Optional

import numpy as np

from ..core import (Request, compile_market, e_total, get_backend,
                    preprocess, solve_ilp, solve_ilp_reference)
from ..core.gss import bracketed_gss
from . import common

#: (n_items, req_pods) — the 250/5000 case is the acceptance configuration
#: (≥200 candidate items, ≥5k requested pods, prescan 9, tolerance 0.01).
CASES = [(100, 1000), (250, 5000), (500, 10000)]
SMOKE_CASES = [(100, 1000)]
PRESCAN = 9
TOLERANCE = 0.01


def _items_for(n_items: int, req_pods: int):
    cat = common.catalog(seed=0, max_offerings=2000)
    req = Request(pods=req_pods, cpu_per_pod=2, mem_per_pod=2)
    items = preprocess(cat, req)[:n_items]
    return items


def _residual_heavy_alpha(items, req_pods: int, backend) -> float:
    """A low α whose residual covering DP dominates (worst-case memory)."""
    for alpha in (0.02, 0.05, 0.0):
        _, stats = solve_ilp(items, req_pods, alpha, return_stats=True,
                             backend=backend)
        if stats.residual_demand > 0:
            return alpha
    return 0.0


def _time_cycles(fn, repeat: int) -> float:
    best = float("inf")
    for _ in range(repeat):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def bench_case(n_items: int, req_pods: int, repeat: int = 3) -> dict:
    backend = get_backend()
    items = _items_for(n_items, req_pods)
    market = compile_market(items)

    engine_pool, engine_trace = bracketed_gss(
        items, req_pods, tolerance=TOLERANCE, prescan=PRESCAN,
        backend=backend)
    ref_pool, ref_trace = bracketed_gss(
        items, req_pods, tolerance=TOLERANCE, prescan=PRESCAN,
        solver=solve_ilp_reference)

    cycle_engine = _time_cycles(
        lambda: bracketed_gss(items, req_pods, tolerance=TOLERANCE,
                              prescan=PRESCAN, backend=backend), repeat)
    cycle_engine_warm = _time_cycles(
        lambda: bracketed_gss(items, req_pods, tolerance=TOLERANCE,
                              prescan=PRESCAN, market=market,
                              backend=backend), repeat)
    cycle_reference = _time_cycles(
        lambda: bracketed_gss(items, req_pods, tolerance=TOLERANCE,
                              prescan=PRESCAN, solver=solve_ilp_reference),
        repeat)    # same repeat count as the engine: best-of-N vs best-of-N

    alpha = _residual_heavy_alpha(items, req_pods, backend)
    _, stats = solve_ilp(items, req_pods, alpha, market=market,
                         return_stats=True, backend=backend)

    tracemalloc.start()
    solve_ilp(items, req_pods, alpha, market=market, backend=backend)
    _, peak_engine = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    tracemalloc.start()
    solve_ilp_reference(items, req_pods, alpha)
    _, peak_reference = tracemalloc.get_traced_memory()
    tracemalloc.stop()

    history_bytes = market.n_bundles * (stats.residual_demand + 1) * 8
    return {
        "n_items": len(items),
        "req_pods": req_pods,
        "prescan": PRESCAN,
        "tolerance": TOLERANCE,
        "n_bundles": market.n_bundles,
        "residual_demand": stats.residual_demand,
        "ilp_solves_per_cycle": engine_trace.ilp_solves,
        "cycle_us_engine": round(cycle_engine),
        "cycle_us_engine_warm": round(cycle_engine_warm),
        "cycle_us_reference": round(cycle_reference),
        "speedup_full_cycle": round(cycle_reference / cycle_engine, 2),
        "speedup_warm_cycle": round(cycle_reference / cycle_engine_warm, 2),
        "e_total_engine": e_total(engine_pool, req_pods),
        "e_total_reference": e_total(ref_pool, req_pods),
        "solve_peak_bytes_engine": peak_engine,
        "solve_peak_bytes_reference": peak_reference,
        "seed_history_matrix_bytes": history_bytes,
    }


def run(smoke: bool = False, repeat: int = 3,
        json_path: Optional[str] = None) -> dict:
    cases = [bench_case(n, r, repeat)
             for n, r in (SMOKE_CASES if smoke else CASES)]
    out = {
        "benchmark": "bench_solver",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "cases": cases,
        "us_per_call": cases[-1]["cycle_us_engine"],
        "min_speedup_full_cycle": min(c["speedup_full_cycle"] for c in cases),
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="single small case (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, repeat=args.repeat,
              json_path=args.json or None)
    detail = ";".join(
        f"{c['n_items']}x{c['req_pods']}:"
        f"{c['cycle_us_engine']}us(vs{c['cycle_us_reference']}us,"
        f"{c['speedup_full_cycle']}x,mem{c['solve_peak_bytes_engine']//1024}K"
        f"vs{c['solve_peak_bytes_reference']//1024}K)"
        for c in out["cases"])
    print(f"bench_solver,{out['us_per_call']:.0f},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
