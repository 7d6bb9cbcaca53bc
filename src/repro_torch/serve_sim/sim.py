"""The serving co-simulation: traffic × provisioning × recovery accounting.

This is the layer that closes the loop between the ML stack and the
decision plane (DESIGN.md §15).  A :class:`ServeScenario` pairs a
deterministic request-rate trace (:mod:`repro_torch.serve_sim.workload`) with a
provisioning :class:`~repro_torch.sim.scenario.Scenario` whose pod-demand
schedule is staffed from that trace; :func:`run_serving` drives the
unchanged ``ClusterSim`` engine and then *re-reads the run as a serving
system*:

* a :class:`PoolTimeline` observer captures the pool composition at every
  change (launches, interruption losses) through the engine's
  ``observe_pool`` hook — the piecewise-constant capacity function;
* each pool segment is converted to served QPS via the perf model's
  per-offering QPS/pod table: ``served(t) = min(λ(t), C(t))``, and to
  SLO-served QPS with capacity restricted to SLO-feasible offerings
  (``request_ms ≤ slo_ms``) — cheap slow nodes serve traffic but not
  *within* the SLO, which is exactly the karpenter-baseline failure mode;
* **recovery accounting** (the elastic-reconfiguration charge): capacity
  *added* after an interruption or demand change spends
  ``recovery_hours`` warming up — node boot, image pull, weight load,
  cache re-shard (the runtime/elastic.py re-step path) — during which its
  QPS is charged as lost.  The initial t=0 provisioning is exempt (the
  service is assumed warm at the start of the horizon).

The resulting :class:`ServeReport` carries the headline production
metrics: SLO attainment and served-QPS-hours per dollar.  Everything is
deterministic: the trace, the table, and the integration are pure
functions of (spec, profile, scenario); the only randomness is the
engine's own seeded market/interrupt streams.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .perf_model import (ServingProfile, ServingTable, default_profile,
                         default_slo_ms, serving_table)
from .workload import WorkloadSpec, trace_digest

_EPS = 1e-9

#: default elastic-reconfiguration window (hours): time for a replacement
#: node to boot, pull the serving image, load weights, and rejoin the
#: decode mesh — newly added capacity serves nothing for this long
DEFAULT_RECOVERY_HOURS = 0.25


class PoolTimeline:
    """Engine observer recording (time, reason, pool composition) at every
    pool change — the capacity step function the report integrates.  Pure
    recorder: adding it to ``observers=`` cannot perturb decisions."""

    def __init__(self) -> None:
        self.events: List[Tuple[float, str, Tuple[Tuple[str, int, int], ...]]] = []

    # observer protocol (only the pool hook does anything)
    def observe_market(self, time, spot, t3) -> None:
        pass

    def observe_interrupts(self, time, dt, pool, notices) -> None:
        pass

    def observe_fulfillment(self, time, requested, grants) -> None:
        pass

    def observe_pool(self, time, pool, reason) -> None:
        alloc = tuple((it.offering.offering_id, int(c), int(it.pods))
                      for it, c in zip(pool.items, pool.counts) if c > 0)
        self.events.append((float(time), str(reason), alloc))


@dataclasses.dataclass(frozen=True)
class ServeScenario:
    """A workload trace + the provisioning scenario staffed from it."""

    workload: WorkloadSpec
    scenario: "object"                   # repro_torch.sim.Scenario
    profile: ServingProfile
    slo_ms: float
    recovery_hours: float = DEFAULT_RECOVERY_HOURS


def build_serve_scenario(workload: str = "diurnal", *,
                         policy: str = "serving_slo",
                         base_qps: float = 1000.0, seed: int = 11,
                         profile: Optional[ServingProfile] = None,
                         slo_ms: Optional[float] = None,
                         recovery_hours: float = DEFAULT_RECOVERY_HOURS,
                         duration_hours: float = 24.0,
                         step_hours: float = 1.0,
                         **overrides) -> ServeScenario:
    """The serving counterpart of the ``*_scenario()`` factories: one call
    yields the workload spec, the staffed :class:`Scenario`, and the SLO —
    everything :func:`run_serving` needs.  ``profile=None`` resolves
    :func:`default_profile` (env-overridable mode), which is also what the
    ``serving_slo`` policy resolves internally, so the policy and the
    report always price capacity with the same table."""
    from ..sim.scenario import serving_scenario
    if profile is None:
        profile = default_profile()
    spec = WorkloadSpec(kind=workload, base_qps=base_qps, seed=seed,
                        duration_hours=duration_hours,
                        step_hours=step_hours)
    scenario = serving_scenario(workload, base_qps=base_qps, seed=seed,
                                policy=policy,
                                duration_hours=duration_hours,
                                step_hours=step_hours, profile=profile,
                                **overrides)
    return ServeScenario(
        workload=spec, scenario=scenario, profile=profile,
        slo_ms=float(slo_ms) if slo_ms is not None
        else default_slo_ms(profile),
        recovery_hours=float(recovery_hours))


@dataclasses.dataclass
class ServeReport:
    """Serving-side reading of one simulation run."""

    policy: str
    workload_kind: str
    workload_digest: str                 # trace determinism pin
    perf_mode: str                       # "roofline" | "analytic"
    slo_ms: float
    total_cost: float
    offered_qps_hours: float             # ∫ λ dt
    served_qps_hours: float              # ∫ min(λ, C_warm) dt
    slo_served_qps_hours: float          # ∫ min(λ, C_slo,warm) dt
    nominal_served_qps_hours: float      # ∫ min(λ, C) dt (no warm-up charge)
    recovery_lost_qps_hours: float       # nominal − served (warm-up losses)
    interrupted_nodes: int
    decisions: int
    infeasible_decisions: int            # SLO mask left no feasible pool

    @property
    def slo_attainment(self) -> float:
        """Fraction of offered traffic served within the latency SLO."""
        return (self.slo_served_qps_hours / self.offered_qps_hours
                if self.offered_qps_hours > 0 else 0.0)

    @property
    def served_fraction(self) -> float:
        return (self.served_qps_hours / self.offered_qps_hours
                if self.offered_qps_hours > 0 else 0.0)

    @property
    def qps_hours_per_dollar(self) -> float:
        return (self.served_qps_hours / self.total_cost
                if self.total_cost > 0 else 0.0)

    @property
    def slo_qps_hours_per_dollar(self) -> float:
        """The headline: served QPS-hours *under SLO* per dollar spent."""
        return (self.slo_served_qps_hours / self.total_cost
                if self.total_cost > 0 else 0.0)

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(slo_attainment=self.slo_attainment,
                 served_fraction=self.served_fraction,
                 qps_hours_per_dollar=self.qps_hours_per_dollar,
                 slo_qps_hours_per_dollar=self.slo_qps_hours_per_dollar)
        return d


def _segment_capacity(alloc: Sequence[Tuple[str, int, int]],
                      table: ServingTable, slo_ms: float,
                      ) -> Tuple[float, float, Dict[str, float]]:
    """(total QPS, SLO-feasible QPS, per-offering QPS) of one pool."""
    idx = table.index
    total, slo_total = 0.0, 0.0
    per: Dict[str, float] = {}
    for oid, nodes, pods in alloc:
        k = idx.get(oid)
        if k is None:
            continue
        qps = nodes * pods * float(table.qps_per_pod[k])
        per[oid] = per.get(oid, 0.0) + qps
        total += qps
        if float(table.request_ms[k]) <= slo_ms + _EPS:
            slo_total += qps
    return total, slo_total, per


def evaluate_serving(ss: ServeScenario, table: ServingTable,
                     timeline: PoolTimeline, result) -> ServeReport:
    """Integrate λ(t) against the capacity timeline → :class:`ServeReport`.

    Capacity is piecewise constant between pool events; λ is piecewise
    constant per workload interval; warm-up adjustments subtract newly
    added per-offering QPS over ``[t_event, t_event + recovery_hours)``.
    The integration grid is the union of all three breakpoint families,
    so every sub-interval has constant integrand and the result is exact
    (no quadrature error to drift across platforms)."""
    spec = ss.workload
    lam = spec.trace()
    horizon = spec.n_steps * spec.step_hours

    events = sorted(timeline.events, key=lambda e: e[0])
    # per-event capacity + warm-up windows for capacity *added* after t=0
    seg: List[Tuple[float, float, float]] = []      # (start, C, C_slo)
    warm: List[Tuple[float, float, float, float]] = []  # (a, b, dC, dC_slo)
    prev_per: Dict[str, float] = {}
    for t, reason, alloc in events:
        total, slo_total, per = _segment_capacity(alloc, table, ss.slo_ms)
        seg.append((t, total, slo_total))
        if t > _EPS and ss.recovery_hours > 0:
            added = 0.0
            added_slo = 0.0
            idx = table.index
            for oid, qps in per.items():
                delta = qps - prev_per.get(oid, 0.0)
                if delta > _EPS:
                    added += delta
                    k = idx.get(oid)
                    if k is not None and \
                            float(table.request_ms[k]) <= ss.slo_ms + _EPS:
                        added_slo += delta
            if added > 0:
                warm.append((t, min(t + ss.recovery_hours, horizon),
                             added, added_slo))
        prev_per = per
    if not seg or seg[0][0] > _EPS:
        seg.insert(0, (0.0, 0.0, 0.0))              # empty pool until t=0+

    cuts = {0.0, horizon}
    cuts.update(t for t, _, _ in seg if t < horizon)
    cuts.update(x for a, b, _, _ in warm for x in (a, b) if x < horizon)
    cuts.update(float(k * spec.step_hours) for k in range(1, spec.n_steps))
    grid = sorted(cuts)

    offered = served = slo_served = nominal = 0.0
    si = 0
    for a, b in zip(grid, grid[1:]):
        dt = b - a
        if dt <= _EPS:
            continue
        while si + 1 < len(seg) and seg[si + 1][0] <= a + _EPS:
            si += 1
        _, cap, cap_slo = seg[si]
        warming = sum(d for (wa, wb, d, _) in warm if wa <= a + _EPS < wb)
        warming_slo = sum(d for (wa, wb, _, d) in warm
                          if wa <= a + _EPS < wb)
        k = min(int((a + _EPS) / spec.step_hours), spec.n_steps - 1)
        rate = float(lam[k])
        offered += rate * dt
        nominal += min(rate, cap) * dt
        served += min(rate, max(cap - warming, 0.0)) * dt
        slo_served += min(rate, max(cap_slo - warming_slo, 0.0)) * dt

    metrics_list = [d.metrics for _, d in result.decisions]
    infeasible = sum(1 for m in metrics_list
                     if m.get("serve_infeasible", 0.0) > 0
                     or (m.get("pods", 0.0) <= 0 and m.get("nodes", 0) <= 0))
    return ServeReport(
        policy=ss.scenario.policy, workload_kind=spec.kind,
        workload_digest=trace_digest(spec), perf_mode=table.mode,
        slo_ms=ss.slo_ms, total_cost=float(result.total_cost),
        offered_qps_hours=offered, served_qps_hours=served,
        slo_served_qps_hours=slo_served, nominal_served_qps_hours=nominal,
        recovery_lost_qps_hours=max(nominal - served, 0.0),
        interrupted_nodes=int(result.interrupted_nodes),
        decisions=len(result.decisions),
        infeasible_decisions=int(infeasible))


def run_serving(ss: ServeScenario, *, catalog=None,
                clock=None) -> ServeReport:
    """Run the provisioning simulation and read it back as a serving
    system.  The engine, policies, and trace format are untouched — the
    co-simulation is an observer plus a post-pass."""
    from ..sim.engine import ClusterSim
    timeline = PoolTimeline()
    kwargs = {} if clock is None else {"clock": clock}
    sim = ClusterSim(ss.scenario, catalog=catalog, observers=[timeline],
                     **kwargs)
    result = sim.run()
    table = serving_table(ss.profile, sim.catalog)
    return evaluate_serving(ss, table, timeline, result)


__all__ = ["DEFAULT_RECOVERY_HOURS", "PoolTimeline", "ServeReport",
           "ServeScenario", "build_serve_scenario", "evaluate_serving",
           "run_serving"]
