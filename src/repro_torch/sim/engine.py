"""ClusterSim: the discrete-event scenario engine (DESIGN.md §9).

One reproducible harness unifying market evolution, interruption modeling,
and provisioning.  A :class:`ClusterSim` advances a ``SpotMarketSimulator``
+ a pluggable policy through a time-ordered event queue of price ticks,
scheduled shocks, demand changes, and interrupt notices, recording every
event to a JSONL trace (``repro_torch.sim.trace``).  The same loop runs in three
modes, differing only in the :class:`MarketSource` behind it:

* **live** — ``LiveMarketSource``: seeded ``SpotMarketSimulator`` RNG for
  prices, a separately-seeded ``InterruptModel`` for notices;
* **replay** — ``ReplaySource``: market states / notices / fulfillment
  grants are popped from a recorded trace, no RNG anywhere — same policy
  code re-derives bit-identical decisions (the determinism contract);
* **scripted** — ``ScriptedMarketSource``: one precomputed market path
  shared by N replicas of :func:`run_replicas`, which also share one
  preprocessed ``CompiledMarket`` per (market state, request shape) so
  multi-seed sweeps reuse the batched solver instead of re-solving
  the identical candidate universe per replica.

The engine also exposes an incremental event-stream API
(:meth:`ClusterSim.advance` / :meth:`ClusterSim.current_snapshot`) used by
``runtime.elastic.ElasticSpotTrainer``,
which owns its own training loop but sources market time, interrupts, and
the trace from the engine — and an *observer* fan-out (DESIGN.md §10): the
policy and any ``observers=`` passed to the constructor receive every
market refresh, interrupt sample, and fulfillment round, which is how the
risk subsystem's online estimators (and the backtest's calibration probe)
learn from the same stream live and under replay.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chaos.faults import ChaosController
from ..core import events_log
from ..core.efficiency import NodePool, Request, decision_metrics
from ..core.ilp import compile_market
from ..core.market import (InterruptEvent, Offering, SpotMarketSimulator,
                           snapshot_with)
from ..core.provisioner import (ProvisioningDecision, merge_pools, preprocess)
from ..region.market import (hazard_scale_rows, make_overlay,
                             pool_egress_rate)
from .events import (InterruptNotice, catalog_digest, decision_record,
                     demand_record, fault_record, fulfillment_record,
                     header_record, interrupts_record, market_state_record,
                     probe_record, shock_record, summary_record, tick_record,
                     TRACE_VERSION)
from .interrupts import InterruptModel, make_interrupt_model
from .policy import make_policy
from .scenario import Scenario, Shock
from .trace import TraceRecorder

_EPS = 1e-9

#: sentinel payload for the initial provisioning event — scheduled at
#: (t=0, demand priority) so a t=0 shock (priority 0) is applied first and
#: the same-instant-visibility rule of DESIGN.md §9 holds at t=0 too
_INITIAL = object()


# ---------------------------------------------------------------------------
# Market sources
# ---------------------------------------------------------------------------

class LiveMarketSource:
    """Seeded simulator RNG for prices + a separate model RNG for notices."""

    def __init__(self, catalog: Sequence[Offering], scenario: Scenario,
                 model: InterruptModel,
                 market: Optional[SpotMarketSimulator] = None,
                 overlay=None):
        self.market = market or SpotMarketSimulator(
            catalog, seed=scenario.market_seed,
            price_vol=scenario.price_vol, t3_vol=scenario.t3_vol)
        self.model = model
        #: optional RegionalMarketOverlay (DESIGN.md §17): a pure per-
        #: refresh view transform — the simulator's own state (and its OU
        #: dynamics) never see the regional factor
        self.overlay = overlay
        model.reset(catalog, scenario.interrupt_seed)

    def advance(self, hours: float) -> None:
        self.market.step(hours)

    def apply_shock(self, shock: Shock) -> None:
        price_factor, t3_factor = shock.factors()
        self.market.apply_shock(selector=shock.selector,
                                price_factor=price_factor,
                                t3_factor=t3_factor)

    def state(self, now: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        # the engine passes its own clock: shock-triggered refreshes do
        # not advance market.time, but the overlay must be evaluated at
        # the refresh time in the live and scripted paths identically
        spot, t3 = self.market.state_arrays()
        if self.overlay is not None:
            spot, t3 = self.overlay.apply(spot, t3, now)
        return spot, t3

    def interrupts(self, offerings: Dict[str, Offering],
                   pool: Dict[str, int], hours: float,
                   now: float) -> List[InterruptNotice]:
        return self.model.sample(offerings, pool, hours, now)

    def fulfill(self, offering_id: str, count: int, now: float) -> int:
        return self.market.fulfill(offering_id, count)

    def fulfill_pool(self, requests: Dict[str, int],
                     now: float) -> Dict[str, int]:
        return {oid: self.market.fulfill(oid, c)
                for oid, c in requests.items()}


class ScriptedMarketSource:
    """A precomputed market path (see :func:`script_market_states`) shared
    read-only across replicas; interrupts still come from a live per-replica
    model.  Fulfillment is the deterministic T3 clip (no RNG) so replica
    sweeps stay reproducible without a market RNG stream."""

    def __init__(self, catalog: Sequence[Offering],
                 states: Sequence[Tuple[np.ndarray, np.ndarray]],
                 model: InterruptModel, seed: int):
        self._states = states
        self._idx = 0
        self._index = {o.offering_id: i for i, o in enumerate(catalog)}
        self.model = model
        model.reset(catalog, seed)

    def advance(self, hours: float) -> None:
        pass

    def apply_shock(self, shock: Shock) -> None:
        pass

    def state(self, now: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        # scripted states were pre-overlaid by script_market_states; the
        # time argument exists only for protocol uniformity
        spot, t3 = self._states[self._idx]
        self._idx += 1
        return spot, t3

    def interrupts(self, offerings, pool, hours, now):
        return self.model.sample(offerings, pool, hours, now)

    def _capacity(self, offering_id: str) -> int:
        # before the first pop the "current" state is the t=0 state, not a
        # [-1] wraparound into the end-of-horizon vector
        _, t3 = self._states[max(self._idx - 1, 0)]
        return int(t3[self._index[offering_id]])

    def fulfill(self, offering_id, count, now):
        return min(count, self._capacity(offering_id))

    def fulfill_pool(self, requests, now):
        return {oid: min(c, self._capacity(oid))
                for oid, c in requests.items()}


class ReplaySource:
    """Serve market states, notices, and grants from a recorded trace.

    Replay needs no RNG: everything stochastic was recorded; everything
    else (policy decisions) is recomputed deterministically."""

    def __init__(self, records: Sequence[Dict]):
        self._records = list(records)
        self._pos = 0

    def _next(self, *rtypes: str) -> Dict:
        while self._pos < len(self._records):
            rec = self._records[self._pos]
            self._pos += 1
            if rec["type"] in rtypes:
                return rec
        raise ValueError(f"trace exhausted while looking for {rtypes}")

    def advance(self, hours: float) -> None:
        pass

    def apply_shock(self, shock: Shock) -> None:
        pass

    def state(self, now: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
        # recorded states already carry any regional overlay (the trace
        # records TRUE post-overlay state), so replay stays RNG-free
        rec = self._next("market_state")
        return (np.array(rec["spot"], dtype=np.float64),
                np.array(rec["t3"], dtype=np.int64))

    def interrupts(self, offerings, pool, hours, now):
        rec = self._next("interrupts")
        return [InterruptNotice.from_record(n) for n in rec["notices"]]

    def fulfill(self, offering_id, count, now):
        return int(self._next("probe")["granted"])

    def fulfill_pool(self, requests, now):
        return {k: int(v)
                for k, v in self._next("fulfillment")["grants"].items()}


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SimRound:
    """One tick's outcome: what was sampled, lost, and re-provisioned."""

    time: float
    notices: List[InterruptNotice]           # sampled this tick (incl. advisory)
    effective: List[InterruptNotice]         # capacity actually reclaimed now
    lost_nodes: int
    lost_pods: int                           # per-item Pod_i accounting
    shortfall: int
    decision: Optional[ProvisioningDecision]
    pool: NodePool                           # post-round pool
    snapshot: Optional[List[Offering]] = None
    lost_perf: float = 0.0                   # Σ Perf_i over reclaimed nodes


@dataclasses.dataclass
class SimResult:
    scenario: Scenario
    decisions: List[Tuple[str, ProvisioningDecision]]   # (reason, decision)
    rounds: List[SimRound]
    total_cost: float
    interrupted_nodes: int
    pool: NodePool
    recorder: TraceRecorder
    total_perf_hours: float = 0.0     # ∫ pool perf_rate dt (delivered work)
    #: data-gravity spend (DESIGN.md §17): the egress component already
    #: included in ``total_cost`` — 0.0 whenever the scenario has no
    #: RegionConfig or a zero egress rate (the accrual is skipped, not
    #: added as 0, so legacy float sequences are untouched)
    total_egress: float = 0.0
    #: cache-effectiveness counters (DESIGN.md §11): ``compile_hits`` /
    #: ``compile_misses`` of the shared CompiledMarket cache, plus
    #: ``memo_hits`` / ``memo_misses`` / ``memo_unique_solves`` of the
    #: cross-replica decision memo under the fleet engine (fleet results
    #: carry the fleet-wide aggregate).  Deliberately NOT part of decision
    #: metrics or the trace: cache provenance must never break the
    #: fleet ≡ standalone equality contract.
    cache_stats: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def lost_perf_total(self) -> float:
        """Σ Perf_i of every reclaimed node — the backtest charges each
        interruption ``reprovision_hours`` of this rate (DESIGN.md §10)."""
        return float(sum(rd.lost_perf for rd in self.rounds))

    @property
    def records(self) -> List[Dict]:
        return self.recorder.records

    def decision_records(self) -> List[Dict]:
        return [r for r in self.records if r["type"] == "decision"]


def useful_scale(pool: NodePool, req_pods: int) -> float:
    """Fraction of a pool's perf rate doing *useful* work: pods beyond the
    requested demand contribute nothing (the E_OverPods principle, Eq. 2),
    an underfilled pool is fully utilized.  One definition shared by
    ClusterSim and FleetSim — the value enters the delivered-work accrual,
    so the float sequence must be identical in both engines."""
    alloc = pool.total_pods
    return min(1.0, req_pods / alloc) if alloc > 0 else 0.0


def accrual_increments(pool: NodePool, req_pods: int,
                       dt: float) -> Tuple[float, float]:
    """(cost, useful perf-hours) one interval adds to the running totals —
    the single definition of the accrual float sequence (DESIGN.md §11:
    fleet totals must match standalone totals bit-for-bit, so both engines
    add exactly these products in exactly this order)."""
    return (pool.hourly_cost * dt,
            pool.perf_rate * useful_scale(pool, req_pods) * dt)


def shock_affected(catalog: Sequence[Offering], shock: Shock) -> int:
    """Offerings a shock's selector matches — the trace-record count."""
    return sum(shock.selector in o.offering_id for o in catalog)


def _split_pending(pending: Sequence[InterruptNotice],
                   sampled: Sequence[InterruptNotice], now: float,
                   ) -> Tuple[List[InterruptNotice], List[InterruptNotice]]:
    """Advisory-lead split shared by ClusterSim and FleetSim: matured
    pending notices plus zero-lead fresh ones are effective *now*; the
    rest wait out their lead time.  Determinism-critical (it decides which
    tick reclaims capacity), hence one definition."""
    effective: List[InterruptNotice] = []
    still_pending: List[InterruptNotice] = []
    for n in pending:
        (effective if n.effective_time <= now + _EPS
         else still_pending).append(n)
    for n in sampled:
        (still_pending if n.lead_hours > 0 else effective).append(n)
    return effective, still_pending


def shared_precompile(cache: Dict, stats: Dict[str, int], state_idx: int,
                      snapshot: Sequence[Offering], request: Request):
    """The (market state, request shape)-keyed preprocess+compile cache
    shared by ClusterSim replicas and the fleet engine, with hit/miss
    counters (``SimResult.cache_stats``)."""
    key = (state_idx, request.cpu_per_pod, request.mem_per_pod,
           request.workload)
    if key not in cache:
        stats["compile_misses"] += 1
        items = preprocess(snapshot, request)
        cache[key] = (items, compile_market(items))
    else:
        stats["compile_hits"] += 1
    return cache[key]


def billable_pool(chaos: Optional[ChaosController],
                  snap_index: Dict[str, Offering],
                  pool: NodePool) -> NodePool:
    """Map a decision's pool (solved over the *observed* snapshot) onto
    TRUE market rows for billing/capacity accounting: feed corruption can
    change what the controller believes, never what the market charges —
    which is exactly how trusting a corrupted feed costs real money
    (DESIGN.md §16).  ``Pod_i``/``BS_i`` derive from static offering
    fields, so only offering/spot/t3 swap.  Identity when no chaos is
    configured, keeping healthy runs byte-identical — and one definition
    shared by ClusterSim and FleetSim (the fleet ≡ standalone contract)."""
    if chaos is None or not pool.items:
        return pool
    items = []
    for it in pool.items:
        o = snap_index[it.offering.offering_id]
        items.append(dataclasses.replace(it, offering=o,
                                         spot_price=o.spot_price, t3=o.t3))
    return NodePool(items=items, counts=list(pool.counts),
                    alpha=pool.alpha, request=pool.request)


def failed_decision(request: Request) -> ProvisioningDecision:
    """The record of a decision cycle the control plane could not run
    (solver fault, unhardened policy): an empty pool with
    ``decision_failed`` stamped — deterministic, so it traces and replays
    like any other decision.  Shared by both engines."""
    pool = NodePool(items=[], counts=[], request=request)
    metrics = decision_metrics(pool, request.pods)
    metrics["decision_failed"] = 1.0
    return ProvisioningDecision(pool=pool, trace=None, alpha=None,
                                wall_seconds=0.0, excluded_offerings=set(),
                                metrics=metrics)


def solver_down(chaos: Optional[ChaosController], policy,
                now: float) -> bool:
    """An active solver fault takes out *unhardened* decision cycles
    entirely — they have no retry/ladder machinery to ride it out.
    Hardened policies (``chaos_hardened``) still get called and absorb
    the fault themselves (DESIGN.md §16)."""
    return (chaos is not None
            and not getattr(policy, "chaos_hardened", False)
            and chaos.solver_faulted(now) is not None)


def _apply_losses(pool: NodePool, notices: Sequence[InterruptNotice],
                  ) -> Tuple[NodePool, int, int, float]:
    """Remove interrupted nodes; lost pods use each item's actual Pod_i
    (not a hardcoded per-node pod count — large-instance interrupts count
    fully).  Also totals the reclaimed Perf_i rate for loss accounting."""
    lost: Dict[str, int] = {}
    for n in notices:
        lost[n.offering_id] = lost.get(n.offering_id, 0) + n.count
    items, counts, lost_nodes, lost_pods = [], [], 0, 0
    lost_perf = 0.0
    for it, c in zip(pool.items, pool.counts):
        take = min(c, lost.get(it.offering.offering_id, 0))
        lost_nodes += take
        lost_pods += take * it.pods
        lost_perf += take * it.perf
        if c - take > 0:
            items.append(it)
            counts.append(c - take)
    return (NodePool(items=items, counts=counts, alpha=pool.alpha,
                     request=pool.request), lost_nodes, lost_pods, lost_perf)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _schedule(scenario: Scenario) -> List[Tuple[float, int, object]]:
    """Time-ordered event queue: shocks (0) < demand changes (1) < ticks (2)
    at equal timestamps, so a shock is visible to the same tick's decision.
    A tick's payload is its dt; a duration that is not a step multiple gets
    a final partial tick so the whole horizon is simulated and billed.
    Shocks/demand changes beyond the horizon are dropped — the scenario
    declares its world ends at ``duration_hours``.  The initial
    provisioning itself is the ``_INITIAL`` event at (0, demand priority),
    so a t=0 shock is visible to it like at any other timestamp."""
    horizon = scenario.duration_hours
    events: List[Tuple[float, int, object]] = [(0.0, 1, _INITIAL)]
    for s in scenario.shocks:
        if s.time <= horizon + _EPS:
            events.append((s.time, 0, s))
    for t, pods in scenario.demand_schedule:
        if t <= horizon + _EPS:
            events.append((t, 1, int(pods)))
    if scenario.step_hours > 0:
        n_ticks = int(math.floor(horizon / scenario.step_hours + _EPS))
        for k in range(1, n_ticks + 1):
            events.append((k * scenario.step_hours, 2,
                           scenario.step_hours))
        covered = n_ticks * scenario.step_hours
        if horizon - covered > _EPS:
            events.append((horizon, 2, horizon - covered))
    return sorted(events, key=lambda e: (e[0], e[1]))


def script_market_states(scenario: Scenario, catalog: Sequence[Offering],
                         ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Precompute every market state a run will observe (initial + one per
    tick/shock), in the exact refresh order ``ClusterSim.run`` uses."""
    market = SpotMarketSimulator(catalog, seed=scenario.market_seed,
                                 price_vol=scenario.price_vol,
                                 t3_vol=scenario.t3_vol)
    # Regional overlay: the scripted path must record the same TRUE states
    # the live source produces, so the overlay applies at the same times
    # the engine would pass to ``source.state(now)``.
    overlay = make_overlay(scenario.region, catalog, scenario.faults)

    def _state(t: float) -> Tuple[np.ndarray, np.ndarray]:
        spot, t3 = market.state_arrays()
        if overlay is not None:
            spot, t3 = overlay.apply(spot, t3, t)
        return spot, t3

    states = []
    last_t = 0.0
    for t, prio, payload in _schedule(scenario):
        if payload is _INITIAL:             # initial refresh at t=0
            states.append(_state(0.0))
        elif prio == 2:                     # tick
            market.step(t - last_t)
            last_t = t
            states.append(_state(t))
        elif prio == 0:                     # shock
            shock: Shock = payload
            price_factor, t3_factor = shock.factors()
            market.apply_shock(selector=shock.selector,
                               price_factor=price_factor,
                               t3_factor=t3_factor)
            states.append(_state(t))
    return states


class ClusterSim:
    """Event-queue simulation of one scenario (see module docstring)."""

    def __init__(self, scenario: Scenario, *,
                 catalog: Optional[Sequence[Offering]] = None,
                 source=None, recorder: Optional[TraceRecorder] = None,
                 keep_snapshots: bool = False,
                 compile_cache: Optional[Dict] = None,
                 observers: Sequence = (), clock=None):
        self.scenario = scenario
        self.catalog = (list(catalog) if catalog is not None
                        else scenario.build_catalog())
        if source is None:
            source = LiveMarketSource(self.catalog, scenario,
                                      make_interrupt_model(
                                          scenario.interrupt_model),
                                      overlay=make_overlay(
                                          scenario.region, self.catalog,
                                          scenario.faults))
        self.source = source
        # regional hazard regimes (DESIGN.md §17): scale the pressure
        # model's per-node law; skipped entirely (None) for unit scales so
        # the law stays bitwise untouched
        scale_rows = hazard_scale_rows(scenario.region, self.catalog)
        model = getattr(self.source, "model", None)
        if model is not None and scale_rows is not None:
            model.set_hazard_scale(
                dict(zip((o.offering_id for o in self.catalog),
                         scale_rows.tolist())))
        policy_kwargs = {} if clock is None else {"clock": clock}
        self.policy = make_policy(scenario.policy,
                                  tolerance=scenario.tolerance,
                                  ttl_hours=scenario.ttl_hours,
                                  region=scenario.region,
                                  **policy_kwargs)
        # event-stream observer fan-out (DESIGN.md §10): the policy always
        # observes (risk policies learn online), plus any caller-supplied
        # observers (e.g. the backtest's calibration probe) — each owns its
        # own state, so fan-out order is not decision-relevant
        self.policy.bind(self.catalog)
        # chaos controller (DESIGN.md §16): derived purely from the
        # scenario spec + catalog, so live/replay/fleet all rebuild the
        # identical fault view.  None when the scenario declares no faults
        # — every chaos branch below is then skipped, keeping healthy runs
        # byte-identical to the pre-chaos engine.
        self.chaos = (ChaosController(scenario.faults, self.catalog)
                      if scenario.faults else None)
        self.policy.bind_chaos(self.chaos)
        self._observers = [self.policy, *observers]
        self._events_snap = events_log.snapshot()
        self.recorder = recorder or TraceRecorder()
        self.recorder.write(header_record(scenario.to_dict(),
                                          len(self.catalog),
                                          catalog_digest(self.catalog)))
        self.keep_snapshots = keep_snapshots
        self.compile_cache = compile_cache
        self.cache_stats: Dict[str, int] = {"compile_hits": 0,
                                            "compile_misses": 0}

        self.request = scenario.request()
        self.pool = NodePool(items=[], counts=[])
        self.pending: List[InterruptNotice] = []
        self.time = 0.0
        self.total_cost = 0.0
        self.total_perf_hours = 0.0
        self.total_egress = 0.0
        # egress accrual is armed only by a non-zero rate: the off case
        # must not even add 0.0 to the running totals (bit-inertness)
        self._egress_cfg = (scenario.region
                            if scenario.region is not None and
                            scenario.region.egress_per_pod_hour > 0.0
                            else None)
        self._cost_accrued_to = 0.0
        self.interrupted_nodes = 0
        self.decisions: List[Tuple[str, ProvisioningDecision]] = []
        self.rounds: List[SimRound] = []
        self._snapshot: Optional[List[Offering]] = None
        self._snap_index: Dict[str, Offering] = {}
        self._state_idx = -1

    # -- construction helpers ---------------------------------------------
    @classmethod
    def replay(cls, records: Sequence[Dict], *,
               catalog: Optional[Sequence[Offering]] = None,
               keep_snapshots: bool = False,
               observers: Sequence = ()) -> "ClusterSim":
        """Rebuild a sim from a recorded trace; running it re-derives the
        identical decision sequence without any RNG (DESIGN.md §9)."""
        records = list(records)
        header = records[0]
        if header.get("type") != "header":
            raise ValueError("trace does not start with a header record")
        if header.get("version") != TRACE_VERSION:
            raise ValueError(f"trace version {header.get('version')!r} != "
                             f"supported {TRACE_VERSION}")
        scenario = Scenario.from_dict(header["scenario"])
        catalog = (list(catalog) if catalog is not None
                   else scenario.build_catalog())
        # a trace is only meaningful against the exact offering universe it
        # was recorded on; refuse to pair it with a different catalog
        # (e.g. the recording run was handed an explicit catalog whose
        # seeds don't match the Scenario's) instead of silently diverging
        digest = catalog_digest(catalog)
        if digest != header.get("catalog_digest"):
            raise ValueError(
                "catalog mismatch: trace was recorded against digest "
                f"{header.get('catalog_digest')!r} but replay catalog has "
                f"{digest!r}; pass the recording run's catalog= explicitly")
        return cls(scenario, catalog=catalog,
                   source=ReplaySource(records),
                   keep_snapshots=keep_snapshots, observers=observers)

    @classmethod
    def from_market(cls, market: SpotMarketSimulator,
                    interrupt_model: str = "pressure",
                    interrupt_seed: int = 0, name: str = "live",
                    recorder: Optional[TraceRecorder] = None) -> "ClusterSim":
        """Wrap an existing market for event-stream consumers (the elastic
        trainer): the engine owns time, interrupts, and the trace while the
        caller drives its own loop via :meth:`advance`."""
        catalog = market.catalog
        scenario = Scenario(name=name, duration_hours=0.0,
                            interrupt_model=interrupt_model,
                            interrupt_seed=interrupt_seed,
                            max_offerings=len(catalog))
        model = make_interrupt_model(interrupt_model)
        sim = cls(scenario, catalog=catalog,
                  source=LiveMarketSource(catalog, scenario, model,
                                          market=market),
                  recorder=recorder)
        sim.time = market.time
        return sim

    @property
    def market(self) -> Optional[SpotMarketSimulator]:
        """The underlying simulator of a live source (None on replay)."""
        return getattr(self.source, "market", None)

    # -- internals ---------------------------------------------------------
    def _record(self, rec: Dict) -> None:
        self.recorder.write(rec)

    def _useful_scale(self) -> float:
        """See :func:`useful_scale` (per hour, useful perf / cost is then
        exactly E_Total)."""
        return useful_scale(self.pool, self.request.pods)

    def _accrue_cost(self, now: float) -> None:
        """Charge the current pool for the interval since the last accrual —
        called before any event mutates the pool or the demand, so
        mid-interval changes (demand merges, interrupts) are billed at the
        rate that actually ran.  Useful perf-hours accrue on the same
        schedule, so cost and work integrals cover identical pool
        histories."""
        dt = now - self._cost_accrued_to
        cost, perf = accrual_increments(self.pool, self.request.pods, dt)
        self.total_cost += cost
        self.total_perf_hours += perf
        if self._egress_cfg is not None:
            egress = pool_egress_rate(self._egress_cfg, self.pool) * dt
            self.total_cost += egress
            self.total_egress += egress
        self._cost_accrued_to = now

    def _refresh(self) -> None:
        """TRUE/OBSERVED split (DESIGN.md §16): the trace records the TRUE
        market state (so the header + records replay regardless of faults);
        the chaos controller then derives the *observed* view the policy
        decides on.  ``_snap_index`` stays TRUE — interrupt hazards and
        billing live in reality even when the feed lies."""
        spot, t3 = self.source.state(self.time)
        self._record(market_state_record(self.time, spot, t3))
        self._state_idx += 1
        if self.chaos is not None:
            spot_obs, t3_obs, transitions = self.chaos.observe(
                self._state_idx, self.time, spot, t3)
            for kind, phase, idx in transitions:
                self._record(fault_record(self.time, kind, phase, idx))
            self._true_snapshot = snapshot_with(self.catalog, spot, t3)
            self._snapshot = (self._true_snapshot
                              if spot_obs is spot and t3_obs is t3
                              else snapshot_with(self.catalog, spot_obs,
                                                 t3_obs))
        else:
            spot_obs, t3_obs = spot, t3
            self._snapshot = snapshot_with(self.catalog, spot, t3)
            self._true_snapshot = self._snapshot
        self._snap_index = {o.offering_id: o for o in self._true_snapshot}
        for obs in self._observers:
            obs.observe_market(self.time, spot_obs, t3_obs)

    def _notify_pool(self, reason: str) -> None:
        """Pool-change fan-out: fired whenever ``self.pool`` changes (a
        launch, or interruption losses with no re-provision decision).
        ``observe_pool`` is part of the formal observer protocol (no-op on
        the :class:`~repro_torch.sim.policy.Policy` base) — serving co-sim
        timelines integrate capacity between exactly these events
        (DESIGN.md §15)."""
        for obs in self._observers:
            obs.observe_pool(self.time, self.pool, reason)

    def _solver_down(self) -> bool:
        return solver_down(self.chaos, self.policy, self.time)

    def _provision(self, request: Request) -> ProvisioningDecision:
        if self._solver_down():
            return failed_decision(request)
        return self.policy.provision(request, self._snapshot, self.time,
                                     precompiled=self._precompiled(request))

    def _precompiled(self, request: Request):
        """Shared-compile hook: replicas keyed on (market state, request
        shape) reuse one preprocessed candidate set + CompiledMarket."""
        if self.compile_cache is None:
            return None
        return shared_precompile(self.compile_cache, self.cache_stats,
                                 self._state_idx, self._snapshot, request)

    def _launch(self, decision: ProvisioningDecision, reason: str,
                base_pool: Optional[NodePool] = None) -> None:
        """Apply a decision: optional fulfillment clip, trace record, merge."""
        new_pool = billable_pool(self.chaos, self._snap_index,
                                 decision.pool)
        # ICE-style partial fulfillment (DESIGN.md §16): active ice faults
        # cap per-offering grants as a pure function of the REQUESTED
        # counts, so replay re-deriving the caps and re-clipping recorded
        # grants is the identity
        caps = (self.chaos.ice_caps(self.time, new_pool.as_dict())
                if self.chaos is not None and new_pool.total_nodes else None)
        if new_pool.total_nodes and (self.scenario.apply_fulfillment
                                     or caps is not None):
            requested = new_pool.as_dict()
            if self.scenario.apply_fulfillment:
                grants = self.source.fulfill_pool(requested, self.time)
            else:
                grants = dict(requested)
            if caps is not None:
                grants = {oid: min(g, caps.get(oid, g))
                          for oid, g in grants.items()}
            self._record(fulfillment_record(self.time, grants))
            for obs in self._observers:
                obs.observe_fulfillment(self.time, requested, grants)
            items, counts = [], []
            for it, c in zip(new_pool.items, new_pool.counts):
                g = min(c, grants.get(it.offering.offering_id, 0))
                if g > 0:
                    items.append(it)
                    counts.append(g)
            new_pool = NodePool(items=items, counts=counts,
                                alpha=new_pool.alpha,
                                request=new_pool.request)
        self._record(decision_record(self.time, reason, self.policy.name,
                                     decision.pool.as_dict(), decision.alpha,
                                     decision.metrics))
        self.decisions.append((reason, decision))
        if base_pool is not None and base_pool.total_nodes:
            self.pool = merge_pools(base_pool, new_pool)
        else:
            self.pool = new_pool
        self._notify_pool(reason)

    def _split_notices(self, sampled: Sequence[InterruptNotice],
                       now: float) -> List[InterruptNotice]:
        """Advisory notices wait out their lead time in the pending queue;
        returns the notices whose capacity is reclaimed *now*."""
        effective, self.pending = _split_pending(self.pending, sampled, now)
        return effective

    def _tick_events(self, t: float, dt: float, pool: Dict[str, int],
                     ) -> Tuple[List[InterruptNotice],
                                List[InterruptNotice]]:
        """The tick protocol shared by :meth:`run` and :meth:`advance`:
        record tick → advance market → refresh state → sample notices
        (with §5.4.3 fault injection on genuinely calm rounds: nothing
        sampled AND no advisory notice maturing now) → record → split into
        (sampled, effective-now)."""
        self._record(tick_record(t, dt))
        self.source.advance(dt)
        self.time = t
        self._refresh()
        sampled = self.source.interrupts(self._snap_index, pool, dt, t)
        matured = any(n.effective_time <= t + _EPS for n in self.pending)
        if (self.scenario.inject_if_idle and not sampled and not matured
                and any(c > 0 for c in pool.values())):
            # deterministically kill the largest allocation so
            # interrupt-handling is exercised every round
            oid, c = max(pool.items(), key=lambda kv: kv[1])
            sampled = [InterruptNotice(time=t, offering_id=oid, count=c,
                                       reason="fault-injection")]
        self._record(interrupts_record(t, sampled))
        for obs in self._observers:
            obs.observe_interrupts(t, dt, pool, sampled)
        return sampled, self._split_notices(sampled, t)

    def _on_tick(self, t: float, dt: float) -> None:
        scale = self._useful_scale()        # utilization of the interval's pool
        self._accrue_cost(t)                # interval just run, old pool
        sampled, effective = self._tick_events(t, dt, self.pool.as_dict())

        survivors, lost_nodes, lost_pods, lost_perf = _apply_losses(
            self.pool, effective)
        # a notice sampled over this tick reclaimed its capacity at an
        # unknown instant within it, but the accrual above credited the
        # full interval — charge the expected half-tick of undelivered
        # useful work (cost is NOT rebated: reclaimed capacity was still
        # billed, which is exactly why interruptions hurt perf-per-dollar)
        self.total_perf_hours -= 0.5 * dt * lost_perf * scale
        self.interrupted_nodes += lost_nodes
        decision, shortfall = None, 0
        if effective:
            shortfall = max(0, self.request.pods - survivors.total_pods)
            if self._solver_down():
                # the unhardened reactive loop is down with the solver:
                # exclusions don't update and the shortfall goes unfilled
                decision = (failed_decision(dataclasses.replace(
                    self.request, pods=shortfall)) if shortfall > 0
                    else None)
            else:
                decision = self.policy.on_interrupts(
                    effective, self.request, self._snapshot,
                    survivors.total_pods, t,
                    precompiled=self._precompiled(self.request))
            self.pool = survivors
            if decision is not None:
                # recorded even when the replacement pool is empty
                # (infeasible shortfall) so the trace shows every
                # re-optimization attempt, exactly like initial/demand
                self._launch(decision, "interrupt", base_pool=survivors)
            else:
                self._notify_pool("losses")
        self.rounds.append(SimRound(
            time=t, notices=list(sampled), effective=effective,
            lost_nodes=lost_nodes, lost_pods=lost_pods, shortfall=shortfall,
            decision=decision, pool=self.pool,
            snapshot=self._snapshot if self.keep_snapshots else None,
            lost_perf=lost_perf))

    def _on_shock(self, shock: Shock) -> None:
        self.source.apply_shock(shock)
        self._record(shock_record(self.time, shock.kind, shock.selector,
                                  shock.factor,
                                  shock_affected(self.catalog, shock)))
        self._refresh()

    def _on_demand(self, pods: int) -> None:
        """Demand change: scale-ups provision only the shortfall and merge
        with the running pool (capacity is never discarded for free);
        scale-downs keep the pool over-provisioned — consolidation is a
        billing optimization the paper leaves to Karpenter's own path.
        ``Scenario.demand_jitter`` perturbs the scheduled demand per
        interruption seed (stream-free; identical across engines)."""
        self._accrue_cost(self.time)
        pods = self.scenario.effective_pods(self.scenario.interrupt_seed,
                                            self.time, pods)
        self.request = dataclasses.replace(self.request, pods=pods)
        self._record(demand_record(self.time, pods))
        shortfall = pods - self.pool.total_pods
        if shortfall <= 0 and self.pool.total_nodes:
            return
        repl_request = (dataclasses.replace(self.request, pods=shortfall)
                        if self.pool.total_nodes else self.request)
        decision = self._provision(repl_request)
        self._launch(decision, "demand",
                     base_pool=self.pool if self.pool.total_nodes else None)

    # -- scenario run ------------------------------------------------------
    def _on_initial(self) -> None:
        if self.scenario.demand_jitter:
            self.request = dataclasses.replace(
                self.request, pods=self.scenario.effective_pods(
                    self.scenario.interrupt_seed, 0.0, self.scenario.pods))
        self._refresh()
        decision = self._provision(self.request)
        self._launch(decision, "initial")

    def run(self) -> SimResult:
        if self._state_idx != -1:
            # current_snapshot()/advance()/probe_fulfillment() already
            # consumed market state: a run() on top would desynchronize
            # the recorded state sequence (and a scripted source's state
            # queue), silently breaking the byte-identical-trace contract
            raise RuntimeError(
                "run() must drive a fresh ClusterSim; this instance "
                "already served the event-stream/probe API — construct a "
                "new ClusterSim for the scenario run")
        for t, prio, payload in _schedule(self.scenario):
            self.time = t
            if payload is _INITIAL:
                self._on_initial()
            elif prio == 0:
                self._on_shock(payload)
            elif prio == 1:
                self._on_demand(payload)
            else:
                self._on_tick(t, payload)
        self._record(summary_record(self.time, self.total_cost,
                                    self.interrupted_nodes,
                                    len(self.decisions),
                                    self.pool.as_dict()))
        return SimResult(scenario=self.scenario, decisions=self.decisions,
                         rounds=self.rounds, total_cost=self.total_cost,
                         interrupted_nodes=self.interrupted_nodes,
                         pool=self.pool, recorder=self.recorder,
                         total_perf_hours=self.total_perf_hours,
                         total_egress=self.total_egress,
                         cache_stats=self._final_stats())

    def _final_stats(self) -> Dict[str, int]:
        """cache_stats + the run's one-time-warning counter deltas
        (``event_*``, repro_torch.core.events_log) + the hardened policy's
        degradation-ladder counters (``chaos_*``).  Diagnostic only —
        never part of decisions, records, or metrics (DESIGN.md §16)."""
        stats = dict(self.cache_stats)
        for k, v in events_log.delta_since(self._events_snap).items():
            stats[f"event_{k}"] = stats.get(f"event_{k}", 0) + v
        chaos_stats = getattr(self.policy, "chaos_stats", None)
        if chaos_stats is not None:
            for k, v in chaos_stats().items():
                stats[f"chaos_{k}"] = v
        return stats

    # -- incremental event-stream API (elastic trainer) --------------------
    def current_snapshot(self) -> List[Offering]:
        if self._snapshot is None:
            self._refresh()
        return self._snapshot

    def advance(self, hours: float,
                pool: Dict[str, int]) -> List[InterruptEvent]:
        """Advance the market by ``hours`` and return the interrupt events
        effective *now* for ``pool`` (advisory notices queue until their
        lead time elapses; ``inject_if_idle`` scenarios fault-inject on
        calm ticks here too).  Records tick/state/notices to the trace."""
        t = self.time + hours
        _, effective = self._tick_events(t, hours, pool)
        # clip to the caller's live pool (a matured advisory may refer to
        # capacity the caller already replaced), mirroring _apply_losses
        remaining = dict(pool)
        events: List[InterruptEvent] = []
        for n in effective:
            take = min(n.count, remaining.get(n.offering_id, 0))
            if take <= 0:
                continue
            remaining[n.offering_id] -= take
            self.interrupted_nodes += take
            events.append(InterruptEvent(time=n.time,
                                         offering_id=n.offering_id,
                                         count=take, reason=n.reason))
        return events

    def probe_fulfillment(self, offering_id: str, count: int) -> int:
        """One-off fulfillment probe (Fig. 9): how many of ``count`` nodes
        the market would grant right now.  Recorded and replayable."""
        granted = int(self.source.fulfill(offering_id, count, self.time))
        self._record(probe_record(self.time, offering_id, count, granted))
        return granted


def run_replicas(scenario: Scenario, interrupt_seeds: Sequence[int], *,
                 catalog: Optional[Sequence[Offering]] = None,
                 keep_snapshots: bool = False) -> List[SimResult]:
    """Per-seed multi-replica runner: N scenario replicas over one shared
    market path and one shared ``CompiledMarket`` per (state, request shape).

    This is the *reference* sweep implementation: one full ``ClusterSim``
    per seed.  For Monte-Carlo sizes (tens to thousands of seeds) use
    ``repro_torch.sim.fleet.FleetSim`` / ``run_fleet`` (DESIGN.md §11), which is
    proven per-seed identical to this path and ~20-50× faster per replica.

    The market evolution is computed once (:func:`script_market_states`);
    each replica varies only the interruption RNG stream.  Because every
    replica at a given tick sees the identical snapshot, preprocessing +
    market compilation happen once and every replica's GSS prescan rides
    the batched solver against the same compiled arrays — a replica
    is pure policy work, not market work.  A replica's decisions are
    identical to a standalone ``ClusterSim`` run at the same seeds
    (asserted in tests/test_scenario_engine.py).

    ``apply_fulfillment`` scenarios are rejected: live fulfillment draws
    from (and advances) the market's price RNG, which a scripted shared
    path cannot reproduce — the replica≡standalone guarantee would
    silently break.  Sweep fulfillment-sensitive scenarios with
    independent ``ClusterSim`` runs instead.
    """
    if scenario.apply_fulfillment:
        raise ValueError(
            "run_replicas does not support apply_fulfillment scenarios: "
            "live fulfillment consumes the market price RNG, so replicas "
            "over a scripted market path would diverge from standalone "
            "runs; use independent ClusterSim runs for that sweep")
    catalog = (list(catalog) if catalog is not None
               else scenario.build_catalog())
    states = script_market_states(scenario, catalog)
    compile_cache: Dict = {}
    results = []
    for seed in interrupt_seeds:
        sc = dataclasses.replace(scenario, interrupt_seed=int(seed))
        source = ScriptedMarketSource(
            catalog, states, make_interrupt_model(sc.interrupt_model),
            seed=int(seed))
        sim = ClusterSim(sc, catalog=catalog, source=source,
                         compile_cache=compile_cache,
                         keep_snapshots=keep_snapshots)
        results.append(sim.run())
    return results
