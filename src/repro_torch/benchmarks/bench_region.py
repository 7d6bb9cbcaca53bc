"""RegionPlane benchmark: cross-region failover vs region pinning under a
correlated regional brownout storm (DESIGN.md §17).

Returns (and with ``--json`` writes) a record of FleetSim sweeps over a
3-region catalog
whose per-region price paths share a correlated shock factor
(``rho = 0.7``) while the home region walks through
:func:`repro_torch.chaos.region_storm` (brownout → outage → partition):

  * ``hardened`` rides the §17 failover rung: the faulted region's rows
    are quarantined and demand is re-solved into the survivors with
    egress priced into the objective — the multi-region control plane;
  * ``region_pinned:<home>`` is the single-market strawman: all capacity
    in the home region, so every regional fault window is an outage;
  * **SLO perf-per-dollar** (the §16 backfill accounting, reused from
    :mod:`.bench_chaos`): unserved demand is billed and
    credited at the catalog's cheapest on-demand rate, so losing the
    cluster costs what it actually costs;
  * ``headline.region_failover_vs_pinned_ratio`` — hardened over pinned
    on SLO perf-per-dollar — must meet ``TARGET_RATIO``;
  * before measuring, the bench re-proves the §9/§16/§17 contracts:
    determinism under the correlated storm (same seed ⇒ byte-identical
    trace; RNG-free replay; fleet ≡ standalone), **single-region
    inertness** (a K=1 RegionalCatalog scenario is byte-identical to the
    equivalent region-free scenario), and **identity-config inertness**
    (``hardened`` with a solver-inert RegionConfig and no region faults
    decides bit-identically to ``hardened`` without one).  A regional
    layer that moves any of those bits would invalidate the comparison,
    so violations raise.

The fleets solve on the process-default backend, handed to
``run_fleet`` explicitly as in :mod:`.bench_chaos`.

Usage:
  python -m repro_torch.benchmarks.bench_region [--smoke] [--json PATH]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import platform
import time
from typing import Dict, List, Optional

import numpy as np

from .bench_chaos import od_backfill_rate, slo_metrics
from ..chaos import fault_storm, region_storm
from ..core import get_backend
from ..region import RegionConfig, region_pool_shares
from ..sim.engine import ClusterSim
from ..sim.fleet import run_fleet
from ..sim.scenario import Scenario
from ..sim.trace import loads_trace

#: acceptance bar: hardened-with-failover ≥ 1.3× region-pinned
#: SLO perf-per-dollar through the correlated regional brownout storm
TARGET_RATIO = 1.3

HOME = "us-east-1"
REGIONS = ("us-east-1", "us-west-2", "eu-west-1")
POLICIES = ("hardened", f"region_pinned:{HOME}")

_DENOM_FLOOR = 1e-9


def region_config(shock_seed: int = 11) -> RegionConfig:
    """The bench's 3-region market: correlated (rho 0.7) with real
    idiosyncratic volatility, data gravity toward the home region."""
    return RegionConfig(regions=REGIONS, rho=0.7, vol=0.25,
                        shock_seed=shock_seed, home_region=HOME,
                        egress_per_pod_hour=0.002)


def region_scenario(policy: str, *, storm: bool = True,
                    shock_seed: int = 11) -> Scenario:
    """48 h / 3 h-step regional storm scenario — same grid discipline as
    ``bench_chaos`` (every region_storm window edge on a tick boundary)."""
    return Scenario(
        name=f"region_{'storm' if storm else 'clean'}",
        duration_hours=48.0, step_hours=3.0, pods=160,
        demand_schedule=((12.0, 220), (24.0, 140)),
        interrupt_model="pressure", policy=policy,
        catalog_seed=7, max_offerings=200, market_seed=7, interrupt_seed=7,
        region=region_config(shock_seed),
        faults=region_storm(HOME) if storm else ())


def _strip_region_header(trace: str) -> str:
    """Normalize a trace's header for inertness comparisons: the scenario
    dict's ``region``/``name``/``policy`` fields are *declared config*,
    not behavior — every other byte must match on its own."""
    lines = trace.splitlines()
    head = json.loads(lines[0])
    head["scenario"]["region"] = None
    head["scenario"]["name"] = ""
    head["scenario"]["policy"] = ""
    lines[0] = json.dumps(head, sort_keys=True)
    return "\n".join(lines)


def _contract_checks() -> Dict[str, bool]:
    """Determinism + the two §17 inertness obligations."""
    sc = region_scenario("hardened")
    a = ClusterSim(sc, clock=lambda: 0.0).run()
    b = ClusterSim(sc, clock=lambda: 0.0).run()
    determinism = a.recorder.dumps() == b.recorder.dumps()
    replay = (ClusterSim.replay(loads_trace(a.recorder.dumps()))
              .run().recorder.dumps() == a.recorder.dumps())
    fleet = run_fleet(sc, [sc.interrupt_seed], record_traces=True,
                      clock=lambda: 0.0, backend=get_backend())[0]
    fleet_eq = fleet.recorder.dumps() == a.recorder.dumps()

    # single-region inertness: K=1 RegionalCatalog ≡ the region-free
    # scenario over the identical (restricted) catalog, byte-for-byte
    plain = Scenario(name="region_clean", duration_hours=24.0,
                     step_hours=3.0, pods=120, policy="kubepacs",
                     catalog_seed=7, max_offerings=200, market_seed=7,
                     interrupt_seed=7)
    k1 = dataclasses.replace(plain,
                             region=RegionConfig(regions=(HOME,)))
    cat = k1.build_catalog()
    rk1 = ClusterSim(k1, clock=lambda: 0.0).run()
    rpl = ClusterSim(plain, catalog=cat, clock=lambda: 0.0).run()
    single_inert = (_strip_region_header(rk1.recorder.dumps())
                    == _strip_region_header(rpl.recorder.dumps())
                    and rk1.total_egress == 0.0)

    # identity-config inertness: hardened + solver-inert RegionConfig +
    # a *non-region* storm ≡ hardened without a RegionConfig — the
    # failover rung must be bit-inert when no region faults are declared
    storm = fault_storm("combined")
    ident = dataclasses.replace(plain, policy="hardened", faults=storm,
                                region=RegionConfig(regions=REGIONS))
    bare = dataclasses.replace(plain, policy="hardened", faults=storm)
    rid = ClusterSim(ident, catalog=ident.build_catalog(),
                     clock=lambda: 0.0).run()
    rbare = ClusterSim(bare, catalog=ident.build_catalog(),
                       clock=lambda: 0.0).run()
    identity_inert = (_strip_region_header(rid.recorder.dumps())
                      == _strip_region_header(rbare.recorder.dumps()))

    return {"determinism_ok": determinism, "replay_ok": replay,
            "fleet_ok": fleet_eq, "single_region_inert": single_inert,
            "identity_config_inert": identity_inert}


def _mean(rows: List[Dict[str, float]], key: str) -> float:
    return float(np.mean([r[key] for r in rows]))


def _sweep(seeds: List[int], path_seeds: List[int], od_rate: float,
           od_perf: float) -> Dict[str, Dict]:
    """Both policies through every correlated market path × interrupt
    seed, byte-identical storm/market/interrupt streams across policies."""
    rows = {}
    for policy in POLICIES:
        per_seed: List[Dict[str, float]] = []
        ladder: Dict[str, int] = {}
        shares: Dict[str, int] = {}
        egress = 0.0
        t0 = time.perf_counter()
        for ps in path_seeds:
            sc = region_scenario(policy, shock_seed=ps)
            results = run_fleet(sc, seeds, clock=lambda: 0.0,
                                backend=get_backend())
            for r in results:
                per_seed.append(slo_metrics(r, od_rate, od_perf))
                egress += r.total_egress
                for reg, n in region_pool_shares(r.pool).items():
                    shares[reg] = shares.get(reg, 0) + n
            for k, v in results[0].cache_stats.items():
                if k.startswith("chaos_region"):
                    ladder[k] = ladder.get(k, 0) + v
        wall = time.perf_counter() - t0
        agg = {k: round(_mean(per_seed, k), 4)
               for k in ("raw_perf_per_dollar", "slo_perf_per_dollar",
                         "decision_availability", "demand_coverage",
                         "deficit_pod_hours", "cost")}
        agg["wall_s"] = round(wall, 3)
        agg["total_egress"] = round(egress, 4)
        agg["final_pool_shares"] = shares
        agg["per_seed"] = per_seed
        if ladder:
            agg["failover_ladder"] = ladder
        rows[policy] = agg
    return rows


def run(smoke: bool = False, json_path: Optional[str] = None) -> dict:
    seeds = [7] if smoke else [3, 7, 11]
    path_seeds = [11] if smoke else [11, 23]

    checks = _contract_checks()
    if not all(checks.values()):
        raise AssertionError(
            f"region contracts violated: {checks} — determinism and the "
            "inertness obligations are preconditions for a meaningful "
            "failover-vs-pinned comparison")

    od_rate, od_perf = od_backfill_rate(
        region_scenario("kubepacs", storm=False))
    sweep = _sweep(seeds, path_seeds, od_rate, od_perf)

    hard = sweep["hardened"]
    pinned = sweep[f"region_pinned:{HOME}"]
    ratio = (hard["slo_perf_per_dollar"]
             / max(pinned["slo_perf_per_dollar"], _DENOM_FLOOR))
    out = {
        "benchmark": "bench_region",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "seeds": seeds,
        "path_seeds": path_seeds,
        "regions": list(REGIONS),
        "home_region": HOME,
        "od_backfill_rate_per_pod_hour": round(od_rate, 6),
        "od_backfill_perf_per_pod_hour": round(od_perf, 4),
        "target_ratio": TARGET_RATIO,
        "contracts": checks,
        "sweep": sweep,
        "headline": {
            "region_failover_vs_pinned_ratio": round(ratio, 3),
            "hardened_slo_perf_per_dollar": hard["slo_perf_per_dollar"],
            "pinned_slo_perf_per_dollar": pinned["slo_perf_per_dollar"],
            "hardened_demand_coverage": hard["demand_coverage"],
            "pinned_demand_coverage": pinned["demand_coverage"],
            "hardened_total_egress": hard["total_egress"],
            "meets_target": ratio >= TARGET_RATIO,
        },
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def gate_measurement(repeat: int = 1) -> dict:
    """The ``make perf-gate`` metrics: the failover ratio plus the §17
    hard contracts.  Numpy-engine deterministic (region policies solve
    inline through the same backend-bitwise stack), so one run suffices;
    ``repeat`` is accepted for signature parity."""
    checks = _contract_checks()
    od_rate, od_perf = od_backfill_rate(
        region_scenario("kubepacs", storm=False))
    rows = _sweep([7], [11], od_rate, od_perf)
    hard = rows["hardened"]
    pinned = rows[f"region_pinned:{HOME}"]
    ratio = (hard["slo_perf_per_dollar"]
             / max(pinned["slo_perf_per_dollar"], _DENOM_FLOOR))
    return {
        "region_failover_vs_pinned_ratio": round(ratio, 3),
        "determinism_ok": (checks["determinism_ok"] and checks["replay_ok"]
                           and checks["fleet_ok"]),
        "single_region_inert": checks["single_region_inert"],
        "identity_config_inert": checks["identity_config_inert"],
        "hardened_demand_coverage": hard["demand_coverage"],
    }


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="one interrupt seed, one market path (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, json_path=args.json or None)
    h = out["headline"]
    detail = (f"slo_ppd_ratio={h['region_failover_vs_pinned_ratio']}x"
              f";coverage={h['hardened_demand_coverage']}"
              f"vs{h['pinned_demand_coverage']}"
              f";egress=${h['hardened_total_egress']}"
              f";target>={out['target_ratio']}x:"
              f"{'met' if h['meets_target'] else 'MISSED'}")
    wall = out["sweep"]["hardened"]["wall_s"]
    print(f"bench_region,{round(wall * 1e6)},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
