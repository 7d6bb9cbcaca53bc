"""Trace-driven backtesting of the risk subsystem (DESIGN.md §10).

Two questions, answered offline from the scenario engine:

1. **Is the forecast calibrated?**  :func:`calibration_report` replays a
   recorded trace with a :class:`CalibrationObserver` attached — an
   estimator stack that, at every tick, *first* predicts this tick's
   interrupt outcome for the live pool from its current hazard state and
   *then* updates on what actually happened.  Scores: Brier score of the
   per-(tick, offering) any-interrupt probability, and predicted vs
   realized interrupted-node totals.

2. **Does risk-adjusted provisioning pay?**  :func:`compare_policies` runs
   the same scenario under multiple policies × interruption seeds and
   scores each run on perf-per-dollar *net of interruption losses*:

       net_ppd = (perf_hours − c·Σ lost_perf) / total_cost

   where ``perf_hours = ∫ pool perf_rate dt`` is the work the cluster
   delivered — already net of the expected half-tick of downtime the
   engine charges per reclaimed node — ``Σ lost_perf`` the aggregate
   Perf_i of reclaimed nodes, and ``c = RECOVERY_OVERHEAD_HOURS`` the
   *additional* node-hours one interruption destroys beyond downtime
   (emergency checkpoint, restore, lost step work).  The policy-side
   ``RiskParams.reprovision_hours`` internalizes the sum of both, so the
   objective and the scoreboard agree on what an interruption costs.

The module also ships the two standard stress scenarios
(:func:`interrupt_storm_scenario`, :func:`price_shock_scenario`) shared by
``benchmarks/bench_risk.py`` and the test suite.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.market import Offering
from ..sim.engine import ClusterSim, SimResult
from ..sim.fleet import FleetSim, run_fleet
from ..sim.scenario import Scenario, Shock
from .estimators import RiskEstimators, RiskParams
from .survival import interrupt_probability


# ---------------------------------------------------------------------------
# Standard stress scenarios
# ---------------------------------------------------------------------------

def interrupt_storm_scenario(**overrides) -> Scenario:
    """Bid-crossing interrupt storm: a market-wide price spike (then a
    regional aftershock) drives live spot past the 1.15× bid for much of
    the pool, reclaiming capacity wholesale behind 2 h rebalance warnings —
    the same storm shape as the ``run_scenario`` example.  Crossing is
    deterministic given the market path, so the backtest comparison is
    RNG-noise-free: policy deltas are pure selection differences."""
    base = dict(
        name="risk_interrupt_storm", duration_hours=48.0, step_hours=6.0,
        pods=160, cpu_per_pod=2.0, mem_per_pod=2.0,
        interrupt_model="rebalance:2:price_crossing:1.15",
        shocks=(Shock(time=12.0, kind="price", factor=1.6),
                Shock(time=30.0, kind="price", factor=1.6,
                      selector="us-east-1")),
        policy="kubepacs", catalog_seed=11, max_offerings=200,
        market_seed=11, interrupt_seed=11)
    base.update(overrides)
    return Scenario(**base)


def price_shock_scenario(**overrides) -> Scenario:
    """Bid-crossing interrupts under regional price spikes: offerings whose
    spot runs past the bid get reclaimed wholesale, so drift/hazard state
    should steer re-provisioning away from the spiking regions."""
    base = dict(
        name="risk_price_shock", duration_hours=48.0, step_hours=6.0,
        pods=80, cpu_per_pod=2.0, mem_per_pod=2.0,
        interrupt_model="price_crossing:1.15",
        shocks=(Shock(time=12.0, kind="price", factor=1.8,
                      selector="us-east-1"),
                Shock(time=24.0, kind="price", factor=1.6,
                      selector="eu-west-1")),
        policy="kubepacs", catalog_seed=13, max_offerings=200,
        market_seed=13, interrupt_seed=13)
    base.update(overrides)
    return Scenario(**base)


def pressure_crunch_scenario(**overrides) -> Scenario:
    """Pressure-sampled interrupts over a capacity-crunched market: a T3
    crunch pushes allocations toward their pools' capacity.  The pressure
    law's per-offering base rate is the IF band the hazard prior already
    encodes, so this scenario measures what risk adjustment costs when
    there is little *extra* signal to learn (reported for honesty; the
    headline comparisons are the storm and price-shock scenarios)."""
    base = dict(
        name="risk_pressure_crunch", duration_hours=48.0, step_hours=6.0,
        pods=80, cpu_per_pod=2.0, mem_per_pod=2.0,
        interrupt_model="pressure",
        shocks=(Shock(time=12.0, kind="capacity", factor=0.5),),
        policy="kubepacs", catalog_seed=11, max_offerings=200,
        market_seed=11, interrupt_seed=11)
    base.update(overrides)
    return Scenario(**base)


# ---------------------------------------------------------------------------
# Forecast calibration
# ---------------------------------------------------------------------------

class CalibrationObserver:
    """Predict-then-update probe over the engine's event stream.

    At each tick it forecasts, for every offering with live allocation,
    the probability of *any* interrupt over the tick
    (``1 − exp(−λ_i·x_i·Δt)``, the exact union of x_i independent
    exponential clocks) and the expected interrupted-node count
    (``x_i·(1 − exp(−λ_i·Δt))``), records the realized outcome, and only
    then folds the tick into its estimators — predictions are always
    out-of-sample.
    """

    def __init__(self, catalog: Sequence[Offering],
                 params: Optional[RiskParams] = None):
        self.estimators = RiskEstimators(catalog, params)
        self.brier_terms: List[float] = []
        self.predicted_nodes = 0.0
        self.realized_nodes = 0
        self.ticks = 0

    def observe_market(self, time, spot, t3):
        self.estimators.on_market_state(time, spot, t3)

    def observe_interrupts(self, time, dt, pool, notices):
        if dt > 0:
            hazard = self.estimators.hazard()
            hit = {}
            for n in notices:
                hit[n.offering_id] = hit.get(n.offering_id, 0) + n.count
            for oid, count in pool.items():
                i = self.estimators.index.get(oid)
                if i is None or count <= 0:
                    continue
                p_any = float(interrupt_probability(
                    np.array([hazard[i] * count]), dt)[0])
                y = 1.0 if hit.get(oid, 0) > 0 else 0.0
                self.brier_terms.append((p_any - y) ** 2)
                self.predicted_nodes += count * float(interrupt_probability(
                    np.array([hazard[i]]), dt)[0])
            self.realized_nodes += sum(n.count for n in notices)
            self.ticks += 1
        self.estimators.on_interrupts(time, dt, pool, notices)

    def observe_fulfillment(self, time, requested, grants):
        self.estimators.on_fulfillment(time, requested, grants)

    def observe_pool(self, time, pool, reason):
        """Formal observer protocol (DESIGN.md §9): calibration scores
        interrupt forecasts, not capacity timelines — nothing to do."""

    def report(self) -> Dict:
        n = len(self.brier_terms)
        return {
            "ticks": self.ticks,
            "allocations_scored": n,
            "brier": float(np.mean(self.brier_terms)) if n else None,
            "predicted_interrupted_nodes": round(self.predicted_nodes, 3),
            "realized_interrupted_nodes": int(self.realized_nodes),
            "forecast_ratio": (round(self.predicted_nodes
                                     / self.realized_nodes, 3)
                               if self.realized_nodes else None),
        }


def calibration_report(records: Sequence[Dict], *,
                       catalog: Optional[Sequence[Offering]] = None,
                       params: Optional[RiskParams] = None) -> Dict:
    """Replay a recorded trace and score the hazard forecast against it."""
    records = list(records)
    if catalog is None:
        catalog = Scenario.from_dict(records[0]["scenario"]).build_catalog()
    probe = CalibrationObserver(catalog, params)
    ClusterSim.replay(records, catalog=catalog, observers=[probe]).run()
    return probe.report()


def fleet_calibration(scenario: Scenario, seeds: Sequence[int], *,
                      catalog: Optional[Sequence[Offering]] = None,
                      params: Optional[RiskParams] = None) -> Dict:
    """Calibration over a whole interruption-seed fleet (DESIGN.md §11).

    One predict-then-update :class:`CalibrationObserver` rides each fleet
    replica — fed the identical event stream a standalone run would feed
    it — so the Brier score and forecast ratio are estimated over
    ``len(seeds)`` independent interrupt realizations of one market path
    instead of a single draw.  Returns the pooled score (every
    (tick, offering, seed) Brier term weighted equally), the summed
    predicted/realized node counts, and the per-seed reports.
    """
    probes: List[CalibrationObserver] = []

    def factory(cat):
        probe = CalibrationObserver(cat, params)
        probes.append(probe)
        return [probe]

    FleetSim(scenario, seeds, catalog=catalog,
             observer_factory=factory).run()
    reports = [p.report() for p in probes]
    terms = [t for p in probes for t in p.brier_terms]
    predicted = float(sum(p.predicted_nodes for p in probes))
    realized = int(sum(p.realized_nodes for p in probes))
    return {
        "seeds": [int(s) for s in seeds],
        "allocations_scored": len(terms),
        "brier": float(np.mean(terms)) if terms else None,
        "predicted_interrupted_nodes": round(predicted, 3),
        "realized_interrupted_nodes": realized,
        "forecast_ratio": (round(predicted / realized, 3)
                           if realized else None),
        "per_seed": reports,
    }


# ---------------------------------------------------------------------------
# Policy comparison on perf-per-dollar net of interruption losses
# ---------------------------------------------------------------------------

#: node-hours of work destroyed per interruption beyond the engine's
#: half-tick downtime charge (emergency checkpoint + restore + lost steps)
RECOVERY_OVERHEAD_HOURS = 0.25


def net_perf_per_dollar(result: SimResult,
                        recovery_overhead_hours: float = RECOVERY_OVERHEAD_HOURS,
                        ) -> float:
    """(delivered perf-hours − c·Σ lost Perf_i) / total cost."""
    if result.total_cost <= 0:
        return 0.0
    net = (result.total_perf_hours
           - recovery_overhead_hours * result.lost_perf_total)
    return float(net) / float(result.total_cost)


def _run_metrics(result: SimResult, recovery_overhead_hours: float) -> Dict:
    return {
        "interrupt_seed": result.scenario.interrupt_seed,
        "total_cost": round(result.total_cost, 4),
        "perf_hours": round(result.total_perf_hours, 1),
        "lost_perf": round(result.lost_perf_total, 1),
        "interrupted_nodes": result.interrupted_nodes,
        "decisions": len(result.decisions),
        "net_ppd": round(net_perf_per_dollar(result,
                                             recovery_overhead_hours), 1),
        "raw_ppd": round(result.total_perf_hours / result.total_cost, 1)
        if result.total_cost > 0 else 0.0,
    }


def compare_policies(scenario: Scenario,
                     policies: Sequence[str] = ("kubepacs",
                                                "kubepacs_risk:24"),
                     seeds: Sequence[int] = (0, 1, 2),
                     recovery_overhead_hours: float = RECOVERY_OVERHEAD_HOURS,
                     ) -> Dict:
    """Backtest ``policies`` on one scenario across interruption seeds.

    Every (policy, seed) run shares the scenario's market path seeds, so
    differences are pure policy differences plus the interrupt draws their
    distinct pools induce.  Returns per-policy per-seed metrics and
    seed-mean summaries keyed by policy spec.

    Runs ride the fleet engine (one :class:`FleetSim` per policy over all
    seeds — DESIGN.md §11), which produces per-seed results identical to
    standalone ``ClusterSim`` runs; ``apply_fulfillment`` scenarios, which
    the fleet cannot script, fall back to the per-seed path.
    """
    c = recovery_overhead_hours
    runs: Dict[str, List[Dict]] = {}
    for spec in policies:
        sc = dataclasses.replace(scenario, policy=spec)
        if scenario.apply_fulfillment:
            results = [ClusterSim(dataclasses.replace(
                sc, interrupt_seed=int(seed))).run() for seed in seeds]
        else:
            results = run_fleet(sc, seeds)
        runs[spec] = [_run_metrics(r, c) for r in results]
    summary = {}
    for spec, rows in runs.items():
        summary[spec] = {
            "mean_net_ppd": round(float(np.mean([r["net_ppd"]
                                                 for r in rows])), 1),
            "mean_raw_ppd": round(float(np.mean([r["raw_ppd"]
                                                 for r in rows])), 1),
            "mean_cost": round(float(np.mean([r["total_cost"]
                                              for r in rows])), 4),
            "mean_interrupted_nodes": round(float(np.mean(
                [r["interrupted_nodes"] for r in rows])), 2),
            "mean_lost_perf": round(float(np.mean([r["lost_perf"]
                                                   for r in rows])), 1),
        }
    return {
        "scenario": scenario.name,
        "seeds": [int(s) for s in seeds],
        "recovery_overhead_hours": c,
        "runs": runs,
        "summary": summary,
    }
