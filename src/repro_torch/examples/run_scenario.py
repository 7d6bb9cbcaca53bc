"""Scenario-engine tour: define a scenario declaratively, run it, record the
JSONL trace, replay the trace bit-exactly, and sweep interruption seeds —
with the per-seed runner by default, or the replica-major fleet engine
(one shared market path + cross-replica decision memo, DESIGN.md §11)
when ``--replicas N`` asks for a real Monte-Carlo sweep.

With ``--workload`` the tour switches to the serving co-simulation
(DESIGN.md §15): a deterministic request-rate trace staffs the pod
demand, the chosen policy provisions it, and the run is read back as a
serving system — SLO attainment, served QPS-hours, recovery losses.

    PYTHONPATH=src python -m repro_torch.examples.run_scenario --trace /tmp/storm.jsonl
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --smoke   # small & fast
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --smoke --policy kubepacs_risk:12
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --smoke --replicas 256
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --smoke --workload diurnal
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --workload flash --policy karpenter_like
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --smoke --faults combined --policy hardened
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --faults feed:0.5
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --smoke --regions 3
    PYTHONPATH=src python -m repro_torch.examples.run_scenario --regions 3:0.8 --faults region --policy hardened

With ``--faults`` a named fault storm (DESIGN.md §16: ``feed`` / ``ice``
/ ``solver`` / ``combined``, optionally ``NAME:SCALE`` to compress the
windows) overlays the run; the tour then also reports decision
availability and — under ``--policy hardened`` — the degradation-ladder
rung counters.  The replay assertion runs as usual: fault injection is
part of the deterministic trace contract, not an exception to it.

With ``--regions K[:RHO]`` the run provisions across the first K catalog
regions as correlated markets (DESIGN.md §17: shared-factor shocks at
correlation RHO, data gravity toward the home region); the tour then
also reports per-region pool shares and egress spend.  ``--faults
region`` overlays :func:`repro_torch.chaos.region_storm` on the home region —
try it with ``--policy hardened`` to watch the failover rung counters.

Every solve runs on the process-default backend (the card unless
``KUBEPACS_SOLVER_BACKEND`` names another: ``torch:cpu`` on a host;
``torch:fused`` runs the fleet's ticks through its fused plane).  The
trace goes to ``kubepacs_scenario.jsonl`` in the temporary directory
unless ``--trace`` says where.
"""

import argparse
import os
import tempfile

import numpy as np

from ..chaos import fault_storm, region_storm
from ..chaos.guard import decision_available
from ..core.backend import get_backend
from ..core.market import REGIONS
from ..region import RegionConfig, region_pool_shares
from ..sim import (ClusterSim, FleetSim, Scenario, Shock, load_trace,
                   make_policy, run_replicas)


def parse_faults(spec: str, smoke: bool, region=None):
    """``NAME`` or ``NAME:SCALE``.  The storm presets are laid out for a
    48 h horizon; without an explicit scale they are compressed to fit
    the tour's 36 h (or 12 h smoke) run."""
    name, _, scale = spec.partition(":")
    factor = float(scale) if scale else (0.25 if smoke else 0.75)
    if name == "region":
        if region is None:
            raise SystemExit("--faults region needs --regions K "
                             "(the storm targets the home region)")
        return region_storm(region.home, factor)
    return fault_storm(name, factor)


def parse_regions(spec: str) -> RegionConfig:
    """``K`` or ``K:RHO`` — the first K catalog regions as correlated
    markets, home (and data gravity) in the first."""
    k, _, rho = spec.partition(":")
    k = max(1, min(int(k), len(REGIONS)))
    return RegionConfig(regions=REGIONS[:k],
                        rho=float(rho) if rho else 0.6,
                        vol=0.25, shock_seed=11, home_region=REGIONS[0],
                        egress_per_pod_hour=0.002)


def build_scenario(smoke: bool, policy: str = "kubepacs",
                   faults=(), region=None) -> Scenario:
    return Scenario(
        name="interrupt_storm_with_spike",
        duration_hours=12.0 if smoke else 36.0, step_hours=6.0,
        pods=40 if smoke else 150, cpu_per_pod=2, mem_per_pod=2,
        # demand doubles mid-run; a price spike hits us-east-1 at hour 9
        demand_schedule=((9.0, 80 if smoke else 300),),
        shocks=(Shock(time=9.0, kind="price", factor=2.5,
                      selector="us-east-1"),),
        # two-hour rebalance warnings wrapped around bid crossings
        interrupt_model="rebalance:2:price_crossing:1.3",
        policy=policy,
        catalog_seed=7, max_offerings=300 if smoke else 800,
        market_seed=7, interrupt_seed=7,
        faults=tuple(faults), region=region,
    )


def run_serving_workload(kind: str, policy: str, smoke: bool) -> None:
    """The ServeSim tour: provision a staffed request trace, then report
    the run as a serving system (DESIGN.md §15)."""
    from ..serve_sim import build_serve_scenario, run_serving

    ss = build_serve_scenario(kind, policy=policy,
                              duration_hours=8.0 if smoke else 24.0,
                              max_offerings=120 if smoke else 250)
    rep = run_serving(ss)
    print(f"serving {kind!r}: policy={rep.policy}, "
          f"perf_model={rep.perf_mode}, slo={rep.slo_ms:.0f}ms, "
          f"trace digest {rep.workload_digest[:12]}…")
    print(f"        offered {rep.offered_qps_hours:,.0f} QPS·h -> served "
          f"{rep.served_qps_hours:,.0f} ({rep.served_fraction:.1%}), "
          f"within SLO {rep.slo_served_qps_hours:,.0f} "
          f"(attainment {rep.slo_attainment:.1%})")
    print(f"        recovery losses {rep.recovery_lost_qps_hours:,.1f} "
          f"QPS·h across {rep.interrupted_nodes} interrupted nodes; "
          f"{rep.infeasible_decisions}/{rep.decisions} infeasible decisions")
    print(f"        ${rep.total_cost:.2f} total -> "
          f"{rep.slo_qps_hours_per_dollar:,.1f} SLO-served QPS·h per $")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default=os.path.join(tempfile.gettempdir(),
                                                  "kubepacs_scenario.jsonl"))
    ap.add_argument("--smoke", action="store_true",
                    help="small catalog / short horizon")
    ap.add_argument("--policy", default="kubepacs",
                    help="policy spec, e.g. kubepacs, kubepacs_risk:12, "
                         "karpenter_like, fixed_alpha:0.5, serving_slo")
    ap.add_argument("--replicas", type=int, default=None, metavar="N",
                    help="sweep N interruption seeds with the fleet engine "
                         "(default: 5 seeds via the per-seed runner)")
    ap.add_argument("--workload", default=None, metavar="KIND",
                    choices=("diurnal", "bursty", "flash"),
                    help="run the serving co-simulation on this request-"
                         "trace family instead of the interrupt storm")
    ap.add_argument("--faults", default=None, metavar="STORM[:SCALE]",
                    help="overlay a named fault storm (feed, ice, solver, "
                         "combined; DESIGN.md §16 — or region, §17) — try "
                         "with --policy hardened")
    ap.add_argument("--regions", default=None, metavar="K[:RHO]",
                    help="provision across the first K catalog regions as "
                         "correlated markets (DESIGN.md §17), shared-factor "
                         "correlation RHO (default 0.6)")
    args = ap.parse_args(argv)

    region = parse_regions(args.regions) if args.regions else None
    # validate the spec before building anything
    make_policy(args.policy, region=region)

    if args.workload:
        policy = ("serving_slo" if args.policy == "kubepacs"
                  else args.policy)        # serving default unless chosen
        run_serving_workload(args.workload, policy, args.smoke)
        return

    faults = (parse_faults(args.faults, args.smoke, region)
              if args.faults else ())
    scenario = build_scenario(args.smoke, policy=args.policy,
                              faults=faults, region=region)
    print(f"scenario {scenario.name!r}: {scenario.duration_hours:.0f}h, "
          f"policy={scenario.policy}, interrupts={scenario.interrupt_model}"
          + (f", faults={args.faults} ({len(faults)} windows)"
             if faults else "")
          + (f", regions={'/'.join(region.regions)} (rho={region.rho:g})"
             if region else ""))

    # 1. live run, recorded
    res = ClusterSim(scenario).run()
    res.recorder.dump(args.trace)
    print(f"live:   {len(res.decisions)} decisions, "
          f"{res.interrupted_nodes} nodes interrupted, "
          f"${res.total_cost:.2f} total -> {args.trace} "
          f"({len(res.records)} records)")
    if faults:
        avail = [decision_available(d) for _, d in res.decisions]
        rungs = {k[len("chaos_"):]: v for k, v in res.cache_stats.items()
                 if k.startswith("chaos_")}
        print(f"chaos:  decision availability "
              f"{sum(avail)}/{len(avail)} "
              f"({sum(avail) / max(len(avail), 1):.0%}); ladder rungs "
              + (str(rungs) if rungs
                 else "n/a (unhardened policy — no ladder)"))
    if region is not None:
        shares = region_pool_shares(res.pool) or {"(empty pool)": 0}
        share_s = ", ".join(f"{r}: {n}" for r, n in sorted(shares.items()))
        print(f"region: final pool shares {{{share_s}}}; egress "
              f"${res.total_egress:.2f} of ${res.total_cost:.2f} total"
              + (f"; failover rungs "
                 f"{ {k[len('chaos_'):]: v for k, v in res.cache_stats.items() if k.startswith('chaos_region')} }"
                 if any(k.startswith("chaos_region")
                        for k in res.cache_stats) else ""))

    # 2. replay from the JSONL trace — no RNG, identical decisions
    rep = ClusterSim.replay(load_trace(args.trace)).run()
    identical = rep.decision_records() == res.decision_records()
    byte_equal = rep.recorder.dumps() == res.recorder.dumps()
    print(f"replay: identical decisions={identical}, "
          f"byte-identical trace={byte_equal}")
    assert identical and byte_equal

    # 3. multi-seed sweep over one shared market path + compiled market:
    #    the fleet engine for real Monte-Carlo sizes, the per-seed runner
    #    for the default handful of seeds
    if args.replicas:
        # the process default named explicitly: a fleet handed no backend
        # solves per dispatch, never through a fused plane
        fleet = FleetSim(scenario, list(range(args.replicas)),
                         backend=get_backend())
        results = fleet.run()
        costs = [r.total_cost for r in results]
        stats = fleet.stats()
        lookups = stats.get("memo_hits", 0) + stats.get("memo_misses", 0)
        print(f"fleet:  {args.replicas} interruption seeds in "
              f"{fleet.wall_seconds:.2f}s "
              f"({args.replicas / fleet.wall_seconds:.0f} replicas/s) -> "
              f"total cost ${np.mean(costs):.2f} ± {np.std(costs):.2f}")
        print(f"        decision memo: {stats.get('memo_unique_solves', 0)} "
              f"unique solves for {lookups} decisions "
              f"(hit rate {stats.get('memo_hits', 0) / max(lookups, 1):.1%})")
    else:
        seeds = list(range(5))
        replicas = run_replicas(scenario, seeds)
        costs = [r.total_cost for r in replicas]
        print(f"sweep:  {len(seeds)} interruption seeds -> total cost "
              f"${np.mean(costs):.2f} ± {np.std(costs):.2f} "
              f"(min {min(costs):.2f}, max {max(costs):.2f})")


if __name__ == "__main__":
    main()
