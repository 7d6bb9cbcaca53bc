"""Declarative scenario specs: a paper figure as ~20 lines of config.

A :class:`Scenario` fully determines a simulation run — catalog seed,
market evolution seeds, demand schedule, shock schedule, interruption
model, and provisioning policy are all plain JSON-serializable values —
so the trace header alone is enough to re-instantiate and replay a run
(DESIGN.md §9).  Interrupt models and policies are referenced by spec
*string* (parsed by ``make_interrupt_model`` / ``make_policy``) precisely
to keep the spec serializable.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..chaos.faults import Fault
from ..core.efficiency import Request
from ..core.market import Offering, generate_catalog, restrict
from ..region.config import RegionConfig


@dataclasses.dataclass(frozen=True)
class Shock:
    """A deterministic scheduled market shock (price spike, supply crunch).

    ``selector`` substring-matches offering_ids ("" = the whole market);
    ``kind`` is "price" or "capacity"; ``factor`` multiplies spot price or
    T3 respectively (clipped to the market's valid ranges).
    """

    time: float
    kind: str
    factor: float
    selector: str = ""

    def __post_init__(self):
        # normalize numerics so construction and the trace-header JSON
        # round trip serialize identically (9 vs 9.0 would break the
        # byte-identical replay contract)
        object.__setattr__(self, "time", float(self.time))
        object.__setattr__(self, "factor", float(self.factor))

    def factors(self) -> Tuple[float, float]:
        """(price_factor, t3_factor) — the single source of the kind→factor
        dispatch, shared by the live source and the scripted market path so
        the two can never desynchronize."""
        if self.kind == "price":
            return self.factor, 1.0
        if self.kind == "capacity":
            return 1.0, self.factor
        raise ValueError(f"unknown shock kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Everything needed to reproduce one trace-driven simulation run."""

    name: str
    duration_hours: float = 24.0
    step_hours: float = 6.0
    # -- demand -----------------------------------------------------------
    pods: int = 100
    cpu_per_pod: float = 2.0
    mem_per_pod: float = 2.0
    workload: Tuple[str, ...] = ()            # subset of ("network", "disk")
    demand_schedule: Tuple[Tuple[float, int], ...] = ()   # (time, new pods)
    # -- environment ------------------------------------------------------
    shocks: Tuple[Shock, ...] = ()
    interrupt_model: str = "pressure"
    catalog_seed: int = 0
    max_offerings: int = 600
    market_seed: int = 0
    interrupt_seed: int = 0
    price_vol: float = 0.06
    t3_vol: float = 1.6
    # -- control plane ----------------------------------------------------
    policy: str = "kubepacs"
    tolerance: float = 0.01
    ttl_hours: float = 2.0              # UnavailableOfferingsCache TTL
    apply_fulfillment: bool = False     # clip launches by live T3 capacity
    inject_if_idle: bool = False        # §5.4.3 fault injection: if a tick
    #                                     samples no interrupt, kill the
    #                                     largest allocation deterministically
    demand_jitter: float = 0.0          # per-replica demand jitter amplitude
    #                                     (fraction; see effective_pods)
    # -- chaos (DESIGN.md §16) --------------------------------------------
    faults: Tuple[Fault, ...] = ()      # deterministic fault windows; part
    #                                     of the spec, so the trace header
    #                                     alone still replays the run
    # -- regions (DESIGN.md §17) ------------------------------------------
    region: Optional[RegionConfig] = None   # multi-region knobs; None (and
    #                                         every RegionConfig default)
    #                                         is bit-inert

    def __post_init__(self):
        # normalize order-insensitive and numeric fields so construction
        # and the to_dict/from_dict trace-header round trip compare equal
        # AND serialize to identical bytes (int vs float demand times
        # would break the byte-identical replay contract)
        object.__setattr__(self, "workload", tuple(sorted(self.workload)))
        object.__setattr__(self, "demand_schedule",
                           tuple((float(t), int(p))
                                 for t, p in self.demand_schedule))
        object.__setattr__(self, "duration_hours", float(self.duration_hours))
        object.__setattr__(self, "step_hours", float(self.step_hours))
        object.__setattr__(self, "demand_jitter", float(self.demand_jitter))

    def effective_pods(self, seed: int, time: float, pods: int) -> int:
        """Per-replica demand for a (initial or scheduled) demand event.

        With ``demand_jitter`` = j > 0 the base ``pods`` is scaled by a
        factor drawn uniformly from [1−j, 1+j] — *stream-free*: the draw
        seeds a fresh generator from (interruption seed, event time, base
        pods), so it is a pure function of those values, consumes no RNG
        stream anywhere, and therefore reproduces identically in
        ``ClusterSim``, ``run_replicas``, ``FleetSim``, and trace replay
        (the per-seed equality contract, DESIGN.md §12).  Replicas at
        different seeds see different demands — the heterogeneous-demand
        regime where the cross-replica DecisionMemo stops collapsing
        solves and the collect-then-solve batch must carry the load.
        With ``demand_jitter == 0`` (the default) the base demand passes
        through untouched, keeping every pre-existing scenario byte-exact.
        """
        if not self.demand_jitter:
            return int(pods)
        rng = np.random.default_rng(
            (int(seed) & 0xFFFFFFFF, int(round(time * 3600.0)), int(pods)))
        factor = 1.0 + self.demand_jitter * (2.0 * rng.random() - 1.0)
        return max(1, int(round(pods * factor)))

    def request(self) -> Request:
        return Request(pods=self.pods, cpu_per_pod=self.cpu_per_pod,
                       mem_per_pod=self.mem_per_pod,
                       workload=frozenset(self.workload))

    def build_catalog(self) -> List[Offering]:
        catalog = generate_catalog(seed=self.catalog_seed,
                                   max_offerings=self.max_offerings)
        if self.region is not None and self.region.regions:
            # restrict *after* generation: generate_catalog draws from one
            # shared rng across regions, so passing a region subset into it
            # would change every draw — filtering the full catalog keeps
            # the surviving offerings byte-identical to the K=all run
            catalog = restrict(catalog, regions=self.region.regions)
        return catalog

    # -- (de)serialization — the trace-header round trip -------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["workload"] = sorted(self.workload)
        d["demand_schedule"] = [list(x) for x in self.demand_schedule]
        d["shocks"] = [dataclasses.asdict(s) for s in self.shocks]
        d["faults"] = [dataclasses.asdict(f) for f in self.faults]
        d["region"] = None if self.region is None else self.region.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        d["workload"] = tuple(d.get("workload", ()))
        d["demand_schedule"] = tuple(
            tuple(x) for x in d.get("demand_schedule", ()))
        d["shocks"] = tuple(Shock(**s) for s in d.get("shocks", ()))
        d["faults"] = tuple(Fault(**f) for f in d.get("faults", ()))
        region = d.get("region")
        d["region"] = (None if region is None
                       else RegionConfig.from_dict(region))
        return cls(**d)   # __post_init__ normalizes numerics/order


def high_demand_scenario(pods: int = 250_000, **overrides) -> Scenario:
    """Demand-coarsening stress family (DESIGN.md §14).

    Six-figure pod demands against a generated catalog whose per-instance
    pod counts share a large power-of-two factor: quarter-vCPU /
    quarter-GiB pods make ``Pod_i = 4·vCPU_i``, so the compiled market's
    ``pods_gcd`` is ≥ 8 and the coarsening ladder always has a gcd rung
    available.  At the default demand the residual still exceeds
    ``max_rows·gcd``, so the default policy lands on the certified approx
    tier — pass a custom :class:`~repro_torch.core.CoarseningConfig` to the
    provisioner to pin the gcd tier instead.  The demand schedule swings
    ±20 % so re-provisioning stays in the coarse regime all run."""
    base = dict(
        name=f"high_demand_{pods}", duration_hours=24.0, step_hours=6.0,
        pods=pods, cpu_per_pod=0.25, mem_per_pod=0.25,
        demand_schedule=((6.0, int(pods * 1.2)), (12.0, int(pods * 0.8)),
                         (18.0, int(pods * 1.1))),
        interrupt_model="pressure",
        policy="kubepacs", catalog_seed=17, max_offerings=400,
        market_seed=17, interrupt_seed=17)
    base.update(overrides)
    return Scenario(**base)


def serving_scenario(workload: str = "diurnal", *, base_qps: float = 1000.0,
                     seed: int = 11, policy: str = "serving_slo",
                     duration_hours: float = 24.0, step_hours: float = 1.0,
                     profile=None, **overrides) -> Scenario:
    """SLO-driven serving scenario family (DESIGN.md §15): the pod-demand
    schedule is *derived* from a deterministic request-rate trace
    (:class:`repro_torch.serve_sim.workload.WorkloadSpec`) via square-root
    staffing against the perf model's reference QPS/pod — so every
    compared policy faces the identical capacity demand and differs only
    in which offerings provide it.  ``workload`` picks the trace family
    (``diurnal`` | ``bursty`` | ``flash``); hourly ticks keep the
    interrupt → re-provision → recovery loop running all day.  Lazy
    imports keep ``repro_torch.sim`` ↔ ``repro_torch.serve_sim`` acyclic."""
    from ..serve_sim.perf_model import default_profile, reference_qps_per_pod
    from ..serve_sim.workload import WorkloadSpec, demand_schedule_from_trace
    if profile is None:
        profile = default_profile()
    spec = WorkloadSpec(kind=workload, base_qps=base_qps, seed=seed,
                        duration_hours=duration_hours,
                        step_hours=step_hours)
    initial, schedule = demand_schedule_from_trace(
        spec, reference_qps_per_pod(profile))
    base = dict(
        name=f"serving_{workload}", duration_hours=duration_hours,
        step_hours=step_hours, pods=initial, cpu_per_pod=2.0,
        mem_per_pod=4.0, demand_schedule=schedule,
        interrupt_model="pressure", policy=policy,
        catalog_seed=11, max_offerings=250, market_seed=11,
        interrupt_seed=seed)
    base.update(overrides)
    return Scenario(**base)


def heterogeneous_demand_scenario(**overrides) -> Scenario:
    """Standard low-memo-hit stress scenario (DESIGN.md §12).

    Per-replica demand jitter (±15 % at the initial provisioning and at
    every scheduled demand change) makes each replica's requested pod
    count unique, so the cross-replica DecisionMemo's keys almost never
    coincide — the regime the fleet engine is weakest in and the
    collect-then-solve batched tick phase exists for.  Pressure-sampled
    interrupts plus a mid-run capacity crunch keep the §4.1 exclusion /
    shortfall machinery exercised while replicas diverge.
    """
    base = dict(
        name="heterogeneous_demand", duration_hours=48.0, step_hours=6.0,
        pods=160, cpu_per_pod=2.0, mem_per_pod=2.0,
        demand_schedule=((6.0, 220), (18.0, 140), (30.0, 260)),
        demand_jitter=0.15,
        interrupt_model="pressure",
        shocks=(Shock(time=24.0, kind="capacity", factor=0.7),),
        policy="kubepacs", catalog_seed=17, max_offerings=200,
        market_seed=17, interrupt_seed=17)
    base.update(overrides)
    return Scenario(**base)
