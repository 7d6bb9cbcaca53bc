"""ChaosPlane benchmark: hardened vs naive control plane under fault
storms (DESIGN.md §16).

Returns (and with ``--json`` writes) a record of FleetSim fault-storm
sweeps comparing the
``hardened`` policy (degradation ladder) against plain ``kubepacs``
(naive: decides on whatever the corrupted feed says, loses whole decision
cycles to solver faults):

  * per storm (``combined`` headline; ``feed`` / ``ice`` / ``solver`` in
    the full run), both policies face the byte-identical fault schedule,
    market path, and interrupt streams;
  * **SLO perf-per-dollar** — delivered useful perf-hours per dollar with
    unserved demand backfilled at on-demand rates: every pod-hour of
    demand the spot plane failed to cover is charged (and credited) at
    the catalog's cheapest on-demand rate per pod, which is what a real
    operator pays when the spot plane is down.  Raw perf-per-dollar alone
    rewards dropping the cluster (idle capacity is cheap); the backfill
    accounting makes unavailability cost what it actually costs;
  * ``headline.chaos_hardened_vs_naive_ratio`` — hardened over naive on
    SLO perf-per-dollar, combined storm — must meet ``TARGET_RATIO``
    with hardened decision availability ≥ ``TARGET_AVAILABILITY``;
  * before measuring, the bench re-proves the determinism contract under
    chaos (same seed ⇒ byte-identical JSONL trace; replay RNG-free) and
    the **inertness contract** (faults disabled ⇒ hardened trace byte-
    identical to kubepacs) — comparisons against a non-reproducible or
    non-inert hardening layer would be meaningless, so these raise.

The fleets solve on the process-default backend
(``KUBEPACS_SOLVER_BACKEND``, the card's ``torch`` unless set), handed to
``run_fleet`` explicitly so a fused default takes the fused record.

Usage:
  python -m repro_torch.benchmarks.bench_chaos [--smoke] [--json PATH]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..chaos import fault_storm
from ..chaos.guard import decision_available
from ..core import get_backend
from ..core.provisioner import preprocess
from ..sim.engine import ClusterSim, SimResult
from ..sim.fleet import run_fleet
from ..sim.scenario import Scenario

#: acceptance bar: hardened ≥ 1.3× naive SLO perf-per-dollar
#: under the combined storm, at ≥ 0.95 decision availability
TARGET_RATIO = 1.3
TARGET_AVAILABILITY = 0.95

STORMS = ("feed", "ice", "solver", "combined")
POLICIES = ("hardened", "kubepacs")

_DENOM_FLOOR = 1e-9


def chaos_scenario(storm: Optional[str], policy: str) -> Scenario:
    """The pinned 48 h / 3 h-step storm scenario: the fault windows of
    :func:`repro.chaos.fault_storm` are laid out for exactly this grid
    (every window edge on a tick boundary, so fleet memo keys can never
    straddle a fault phase change)."""
    return Scenario(
        name=f"chaos_{storm or 'clean'}", duration_hours=48.0,
        step_hours=3.0, pods=160,
        demand_schedule=((12.0, 220), (24.0, 140)),
        interrupt_model="pressure", policy=policy,
        catalog_seed=7, max_offerings=150, market_seed=7,
        interrupt_seed=7,
        faults=fault_storm(storm) if storm else ())


def od_backfill_rate(scenario: Scenario) -> Tuple[float, float]:
    """(od $/pod-hour, perf/pod-hour) of the catalog's cheapest-per-pod
    on-demand offering — the deterministic reference rate unserved demand
    is billed (and credited) at."""
    items = preprocess(scenario.build_catalog(), scenario.request())
    best = min(items, key=lambda it: (it.offering.od_price / it.pods,
                                      it.offering.offering_id))
    return best.offering.od_price / best.pods, best.bs


def _demand_at(scenario: Scenario, t: float) -> int:
    pods = scenario.pods
    for ts, p in scenario.demand_schedule:
        if ts <= t + 1e-9:
            pods = p
    return int(pods)


def slo_metrics(result: SimResult, od_rate: float,
                od_perf: float) -> Dict[str, float]:
    """Per-run metrics: raw and SLO (backfilled) perf-per-dollar plus
    decision availability and demand coverage."""
    sc = result.scenario
    deficit_pod_hours = 0.0
    demand_pod_hours = 0.0
    prev_t = 0.0
    for rd in result.rounds:
        dt = rd.time - prev_t
        demand = _demand_at(sc, rd.time)
        deficit_pod_hours += max(0, demand - rd.pool.total_pods) * dt
        demand_pod_hours += demand * dt
        prev_t = rd.time
    backfill_cost = deficit_pod_hours * od_rate
    backfill_perf = deficit_pod_hours * od_perf
    avail = [decision_available(d) for _, d in result.decisions]
    raw_ppd = result.total_perf_hours / max(result.total_cost,
                                            _DENOM_FLOOR)
    slo_ppd = ((result.total_perf_hours + backfill_perf)
               / max(result.total_cost + backfill_cost, _DENOM_FLOOR))
    return {
        "perf_hours": round(result.total_perf_hours, 3),
        "cost": round(result.total_cost, 4),
        "raw_perf_per_dollar": round(raw_ppd, 2),
        "slo_perf_per_dollar": round(slo_ppd, 2),
        "deficit_pod_hours": round(deficit_pod_hours, 2),
        "demand_coverage": round(
            1.0 - deficit_pod_hours / max(demand_pod_hours, _DENOM_FLOOR),
            4),
        "decision_availability": round(
            sum(avail) / max(len(avail), 1), 4),
        "decisions": len(avail),
        "interrupted_nodes": result.interrupted_nodes,
    }


def _mean(rows: List[Dict[str, float]], key: str) -> float:
    return float(np.mean([r[key] for r in rows]))


def _contract_checks() -> Dict[str, bool]:
    """Determinism under chaos + inertness of the hardening layer."""
    sc = chaos_scenario("combined", "hardened")
    a = ClusterSim(sc, clock=lambda: 0.0).run()
    b = ClusterSim(sc, clock=lambda: 0.0).run()
    determinism = a.recorder.dumps() == b.recorder.dumps()
    replay = (ClusterSim.replay(a.records).run().recorder.dumps()
              == a.recorder.dumps())
    # faults disabled ⇒ hardened is bit-identical to kubepacs (the guard's
    # healthy path literally delegates to the contained provisioner)
    clean_h = ClusterSim(chaos_scenario(None, "hardened"),
                         clock=lambda: 0.0).run()
    clean_k = ClusterSim(chaos_scenario(None, "kubepacs"),
                         clock=lambda: 0.0).run()
    ha = clean_h.recorder.dumps().replace('"policy": "hardened"',
                                          '"policy": "kubepacs"')
    inert = ha == clean_k.recorder.dumps()
    return {"determinism_ok": determinism, "replay_ok": replay,
            "inert_ok": inert}


def _sweep(storm: str, seeds: List[int], od_rate: float,
           od_perf: float) -> Dict[str, Dict]:
    rows = {}
    for policy in POLICIES:
        sc = chaos_scenario(storm, policy)
        t0 = time.perf_counter()
        results = run_fleet(sc, seeds, clock=lambda: 0.0,
                            backend=get_backend())
        wall = time.perf_counter() - t0
        per_seed = [slo_metrics(r, od_rate, od_perf) for r in results]
        agg = {k: round(_mean(per_seed, k), 4)
               for k in ("raw_perf_per_dollar", "slo_perf_per_dollar",
                         "decision_availability", "demand_coverage",
                         "deficit_pod_hours", "cost")}
        agg["wall_s"] = round(wall, 3)
        agg["per_seed"] = per_seed
        if policy == "hardened":
            agg["ladder"] = {k: v for k, v in
                             results[0].cache_stats.items()
                             if k.startswith("chaos_")}
        rows[policy] = agg
    return rows


def run(smoke: bool = False, json_path: Optional[str] = None) -> dict:
    seeds = [7] if smoke else [3, 7, 11]
    storms = ("combined",) if smoke else STORMS

    checks = _contract_checks()
    if not all(checks.values()):
        raise AssertionError(
            f"chaos contracts violated: {checks} — the determinism/"
            "inertness guarantees are preconditions for a meaningful "
            "hardened-vs-naive comparison")

    od_rate, od_perf = od_backfill_rate(chaos_scenario(None, "kubepacs"))
    sweeps = {storm: _sweep(storm, seeds, od_rate, od_perf)
              for storm in storms}

    hard = sweeps["combined"]["hardened"]
    naive = sweeps["combined"]["kubepacs"]
    ratio = hard["slo_perf_per_dollar"] / max(naive["slo_perf_per_dollar"],
                                              _DENOM_FLOOR)
    out = {
        "benchmark": "bench_chaos",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "seeds": seeds,
        "od_backfill_rate_per_pod_hour": round(od_rate, 6),
        "od_backfill_perf_per_pod_hour": round(od_perf, 4),
        "target_ratio": TARGET_RATIO,
        "target_availability": TARGET_AVAILABILITY,
        "contracts": checks,
        "storms": sweeps,
        "headline": {
            "chaos_hardened_vs_naive_ratio": round(ratio, 3),
            "hardened_availability": hard["decision_availability"],
            "naive_availability": naive["decision_availability"],
            "hardened_slo_perf_per_dollar": hard["slo_perf_per_dollar"],
            "naive_slo_perf_per_dollar": naive["slo_perf_per_dollar"],
            "hardened_demand_coverage": hard["demand_coverage"],
            "naive_demand_coverage": naive["demand_coverage"],
            "availability_ok": (hard["decision_availability"]
                                >= TARGET_AVAILABILITY),
            "meets_target": (ratio >= TARGET_RATIO
                             and hard["decision_availability"]
                             >= TARGET_AVAILABILITY),
        },
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def gate_measurement(repeat: int = 1) -> dict:
    """The ``make perf-gate`` metrics.  The sweep is numpy-engine
    deterministic (FleetSim decisions are backend-bitwise by the DESIGN
    §12 contract), so the ratio is identical on the jax and no-jax legs
    and one run suffices; ``repeat`` is accepted for signature parity."""
    checks = _contract_checks()
    od_rate, od_perf = od_backfill_rate(chaos_scenario(None, "kubepacs"))
    rows = _sweep("combined", [7], od_rate, od_perf)
    hard, naive = rows["hardened"], rows["kubepacs"]
    ratio = hard["slo_perf_per_dollar"] / max(naive["slo_perf_per_dollar"],
                                              _DENOM_FLOOR)
    return {
        "chaos_hardened_vs_naive_ratio": round(ratio, 3),
        "availability_ok": (hard["decision_availability"]
                            >= TARGET_AVAILABILITY),
        "determinism_ok": checks["determinism_ok"] and checks["replay_ok"],
        "inert_ok": checks["inert_ok"],
        "hardened_availability": hard["decision_availability"],
    }


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="combined storm only, one seed (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, json_path=args.json or None)
    h = out["headline"]
    detail = (f"slo_ppd_ratio={h['chaos_hardened_vs_naive_ratio']}x"
              f";avail={h['hardened_availability']}"
              f"vs{h['naive_availability']}"
              f";coverage={h['hardened_demand_coverage']}"
              f"vs{h['naive_demand_coverage']}"
              f";target>={out['target_ratio']}x:"
              f"{'met' if h['meets_target'] else 'MISSED'}")
    wall = out["storms"]["combined"]["hardened"]["wall_s"]
    print(f"bench_chaos,{round(wall * 1e6)},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
