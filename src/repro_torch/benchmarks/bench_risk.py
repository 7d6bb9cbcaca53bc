"""Risk-subsystem benchmark: backtest kubepacs_risk vs kubepacs across the
standard stress scenarios and score forecast calibration (DESIGN.md §10).

Returns (and with ``--json`` writes) a risk-performance record:

  * per-scenario ``summary`` — seed-mean perf-per-dollar net of
    interruption losses, interrupted nodes, lost perf, cost — for the
    static policy and the risk policy, plus their net-ppd ratio;
  * ``calibration`` — Brier score and predicted-vs-realized interrupted
    node counts of the hazard forecast replayed over a recorded
    interrupt-storm trace;
  * ``decision_overhead_us`` — wall time of one risk-adjusted provisioning
    cycle vs the static cycle at the storm's market size (the adjustment
    is O(n) on top of the unchanged solver stack).

Every solve runs on the process-default backend
(``KUBEPACS_SOLVER_BACKEND``, the card's ``torch`` unless set).

Usage:
  python -m repro_torch.benchmarks.bench_risk [--smoke] [--json PATH]
      [--repeat N]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import List, Optional

import numpy as np

from ..core import Request, compile_market, preprocess
from ..risk import backtest
from ..sim import ClusterSim, make_policy

RISK_POLICY = "kubepacs_risk:12"
POLICIES = ("kubepacs", RISK_POLICY)


def _scenarios(smoke: bool):
    # smoke: shorter horizon + smaller catalog, single seed
    tweak = dict(duration_hours=24.0, max_offerings=120) if smoke else {}
    return [
        (backtest.interrupt_storm_scenario(**tweak), (0,)),
        (backtest.price_shock_scenario(**tweak), (0,)),
        (backtest.pressure_crunch_scenario(**tweak),
         (0,) if smoke else (0, 1, 2)),
    ]


def _decision_overhead(scenario, repeat: int) -> dict:
    """One provisioning cycle, static vs risk-adjusted, best-of-N."""
    catalog = scenario.build_catalog()
    request = Request(pods=scenario.pods, cpu_per_pod=scenario.cpu_per_pod,
                      mem_per_pod=scenario.mem_per_pod)
    items = preprocess(catalog, request)
    market = compile_market(items)
    out = {}
    for spec in POLICIES:
        policy = make_policy(spec)
        policy.bind(catalog)
        best = float("inf")
        for _ in range(repeat):
            t0 = time.perf_counter()
            policy.provision(request, catalog, 0.0,
                             precompiled=(items, market))
            best = min(best, time.perf_counter() - t0)
        out[spec] = round(best * 1e6)
    out["overhead_ratio"] = round(out[RISK_POLICY] / out["kubepacs"], 3)
    return out


def run(smoke: bool = False, repeat: int = 3,
        json_path: Optional[str] = None) -> dict:
    scenarios = _scenarios(smoke)
    results = {}
    for scenario, seeds in scenarios:
        comp = backtest.compare_policies(scenario, policies=POLICIES,
                                         seeds=seeds)
        comp["net_ppd_ratio"] = round(
            comp["summary"][RISK_POLICY]["mean_net_ppd"]
            / comp["summary"]["kubepacs"]["mean_net_ppd"], 4)
        results[scenario.name] = comp

    storm, storm_seeds = scenarios[0]
    trace = ClusterSim(storm).run().records
    calibration = backtest.calibration_report(trace)

    out = {
        "benchmark": "bench_risk",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "risk_policy": RISK_POLICY,
        "scenarios": results,
        "calibration": calibration,
        "decision_overhead_us": _decision_overhead(storm, repeat),
        "storm_net_ppd_ratio":
            results[storm.name]["net_ppd_ratio"],
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="short horizons / small catalogs (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, repeat=args.repeat,
              json_path=args.json or None)
    detail = ";".join(
        f"{name}:risk/static={rec['net_ppd_ratio']}"
        for name, rec in out["scenarios"].items())
    detail += (f";brier={out['calibration']['brier']:.3f}"
               f";overhead={out['decision_overhead_us']['overhead_ratio']}x")
    print(f"bench_risk,{out['decision_overhead_us'][RISK_POLICY]},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
