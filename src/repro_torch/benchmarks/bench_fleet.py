"""Fleet-engine benchmark: replica throughput of ``FleetSim`` vs the
per-seed ``run_replicas`` path, plus decision-memo effectiveness
(DESIGN.md §11).

Returns (and with ``--json`` writes) a sweep-throughput record:

  * ``storm`` — the acceptance scenario (interrupt storm, 250-offering
    catalog, R=256): replicas/second for both paths and their ratio.
    The baseline is measured at a smaller R and reported per-replica —
    the per-seed path is embarrassingly linear in R (one full
    ``ClusterSim`` per seed), so its throughput is R-independent;
  * ``crunch`` — the stochastic pressure scenario, where interruption
    draws genuinely diverge replicas and the memo collapses only
    coinciding (state, demand, exclusion) keys: the honest
    mid-hit-rate data point;
  * ``hetero`` — the heterogeneous-demand scenario (per-replica demand
    jitter, DESIGN.md §12): memo hit rate collapses below 50 %, so the
    fleet pays O(unique ≈ R) solves per tick — the regime the
    collect-then-solve batched tick phase targets.  Recorded as batched
    tick phase ON vs OFF (OFF is the per-replica sequential path running
    on the current solver);
  * per-scenario ``fleet_stats`` — memo hits/misses/unique solves and
    compiled-market cache hits, so cache effectiveness is asserted from
    counters, not inferred from timing;
  * ``equality_checked`` — the bench re-proves fleet ≡ run_replicas
    decision equality on a small seed set before timing anything.

Every fleet solves on the process-default backend
(``KUBEPACS_SOLVER_BACKEND``, the card's ``torch`` unless set), handed to
``FleetSim`` explicitly so a fused default takes the fused record; the
per-seed runs' inline solves take the process default too.

Usage:
  python -m repro_torch.benchmarks.bench_fleet [--smoke] [--json PATH]
                                               [--replicas R]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import List, Optional

import numpy as np

from ..core import get_backend
from ..risk import backtest
from ..sim import FleetSim, heterogeneous_demand_scenario, run_replicas

#: acceptance bar of the fleet engine: ≥20× replica throughput
#: vs per-seed run_replicas at R=256 on the interrupt-storm scenario
TARGET_SPEEDUP = 20.0

#: acceptance bar of the batched tick phase: ≥3× replica throughput on
#: the heterogeneous-demand scenario vs the sequential tick phase
#: (measured honestly as batched ON vs OFF on today's solver)
TARGET_HETERO_SPEEDUP = 3.0


def _decision_equality(scenario, seeds) -> bool:
    """Fleet and per-seed runner must produce identical decision records."""
    fleet = FleetSim(scenario, seeds, record_traces=True,
                     backend=get_backend()).run()
    per_seed = run_replicas(scenario, seeds)
    for a, b in zip(fleet, per_seed):
        if a.decision_records() != b.decision_records():
            return False
        if a.total_cost != b.total_cost:
            return False
    return True


def _bench_scenario(scenario, fleet_replicas: int, baseline_replicas: int,
                    ) -> dict:
    seeds = list(range(baseline_replicas))
    t0 = time.perf_counter()
    run_replicas(scenario, seeds)
    base_wall = time.perf_counter() - t0
    base_rate = baseline_replicas / base_wall

    # construction (catalog build, market-path scripting, replica setup) is
    # timed too — run_replicas pays for all of that inside its call
    t0 = time.perf_counter()
    fleet = FleetSim(scenario, list(range(fleet_replicas)),
                     backend=get_backend())
    fleet.run()
    fleet_wall = time.perf_counter() - t0
    fleet_rate = fleet_replicas / fleet_wall

    stats = fleet.stats()
    lookups = stats.get("memo_hits", 0) + stats.get("memo_misses", 0)
    return {
        "scenario": scenario.name,
        "catalog_offerings": scenario.max_offerings,
        "baseline_replicas": baseline_replicas,
        "baseline_ms_per_replica": round(base_wall / baseline_replicas * 1e3,
                                         2),
        "baseline_replicas_per_s": round(base_rate, 2),
        "fleet_replicas": fleet_replicas,
        "fleet_wall_s": round(fleet_wall, 3),
        "fleet_ms_per_replica": round(fleet_wall / fleet_replicas * 1e3, 3),
        "fleet_replicas_per_s": round(fleet_rate, 1),
        "speedup": round(fleet_rate / base_rate, 1),
        "fleet_stats": stats,
        "memo_hit_rate": (round(stats.get("memo_hits", 0) / lookups, 4)
                          if lookups else None),
    }


def _bench_hetero(scenario, fleet_replicas: int) -> dict:
    """Batched tick phase ON vs OFF on the low-memo-hit scenario."""
    seeds = list(range(fleet_replicas))
    t0 = time.perf_counter()
    off = FleetSim(scenario, seeds, batch_decisions=False,
                   backend=get_backend())
    off.run()
    off_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    on = FleetSim(scenario, seeds, backend=get_backend())
    on.run()
    on_wall = time.perf_counter() - t0
    stats = on.stats()
    lookups = stats.get("memo_hits", 0) + stats.get("memo_misses", 0)
    hit_rate = (stats.get("memo_hits", 0) / lookups) if lookups else None
    return {
        "scenario": scenario.name,
        "catalog_offerings": scenario.max_offerings,
        "demand_jitter": scenario.demand_jitter,
        "replicas": fleet_replicas,
        "batched_off_wall_s": round(off_wall, 3),
        "batched_on_wall_s": round(on_wall, 3),
        "batched_off_replicas_per_s": round(fleet_replicas / off_wall, 2),
        "batched_on_replicas_per_s": round(fleet_replicas / on_wall, 2),
        "speedup_on_vs_off": round(off_wall / on_wall, 2),
        "memo_hit_rate": round(hit_rate, 4) if hit_rate is not None else None,
        "fleet_stats": stats,
    }


def sizes(smoke: bool = False, fleet_replicas: Optional[int] = None):
    """The run's sizes: ``(R, baseline R, hetero R, scenario tweak)``."""
    # smoke still runs a real fleet: R must stay large enough to amortize
    # the (shared) construction cost the speedup target is defined over
    R = fleet_replicas or (128 if smoke else 256)
    base_R = 2 if smoke else 8
    hetero_R = min(R, 32 if smoke else 128)
    tweak = dict(max_offerings=120, duration_hours=24.0) if smoke \
        else dict(max_offerings=250)
    return R, base_R, hetero_R, tweak


def scenarios(tweak: dict):
    """The storm, crunch and hetero scenarios at ``tweak``'s size."""
    return (backtest.interrupt_storm_scenario(**tweak),
            backtest.pressure_crunch_scenario(**tweak),
            heterogeneous_demand_scenario(**tweak))


def run(smoke: bool = False, fleet_replicas: Optional[int] = None,
        json_path: Optional[str] = None) -> dict:
    R, base_R, hetero_R, tweak = sizes(smoke, fleet_replicas)
    storm, crunch, hetero = scenarios(tweak)

    equality = _decision_equality(storm, [0, 1]) \
        and _decision_equality(crunch, [0, 1]) \
        and _decision_equality(hetero, [0, 1])
    if not equality:
        raise AssertionError("fleet ≠ run_replicas decision records — the "
                             "equality contract is broken; refusing to "
                             "report throughput for a divergent engine")

    storm_rec = _bench_scenario(storm, R, base_R)
    crunch_rec = _bench_scenario(crunch, R, base_R)
    hetero_rec = _bench_hetero(hetero, hetero_R)

    out = {
        "benchmark": "bench_fleet",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "equality_checked": equality,
        "target_speedup": TARGET_SPEEDUP,
        "target_hetero_speedup": TARGET_HETERO_SPEEDUP,
        "storm": storm_rec,
        "crunch": crunch_rec,
        "hetero": hetero_rec,
        "headline": {
            "storm_speedup": storm_rec["speedup"],
            "storm_fleet_replicas_per_s": storm_rec["fleet_replicas_per_s"],
            "crunch_speedup": crunch_rec["speedup"],
            "crunch_memo_hit_rate": crunch_rec["memo_hit_rate"],
            "hetero_memo_hit_rate": hetero_rec["memo_hit_rate"],
            "hetero_batched_speedup": hetero_rec["speedup_on_vs_off"],
            "meets_target": storm_rec["speedup"] >= TARGET_SPEEDUP,
            "hetero_meets_target": (hetero_rec["speedup_on_vs_off"]
                                    >= TARGET_HETERO_SPEEDUP),
        },
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="small fleet / catalog / horizon (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="fleet size R (default 256; 128 with --smoke)")
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, fleet_replicas=args.replicas,
              json_path=args.json or None)
    h = out["headline"]
    detail = (f"storm:{h['storm_speedup']}x@R{out['storm']['fleet_replicas']}"
              f";crunch:{h['crunch_speedup']}x"
              f";crunch_hit_rate={h['crunch_memo_hit_rate']}"
              f";hetero:{h['hetero_batched_speedup']}x"
              f"@hit_rate={h['hetero_memo_hit_rate']}"
              f";target>={out['target_speedup']}x:"
              f"{'met' if h['meets_target'] else 'MISSED'}")
    us = round(out["storm"]["fleet_ms_per_replica"] * 1e3)
    print(f"bench_fleet,{us},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
