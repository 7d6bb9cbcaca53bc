"""FleetSim: the replica-major vectorized Monte-Carlo engine (DESIGN.md §11).

``run_replicas`` shares the market path and the compiled market
across a multi-seed sweep but still executes one Python-loop ``ClusterSim``
per seed, so a 1000-seed risk backtest costs ~1000× one run.  ``FleetSim``
advances **all R interruption seeds simultaneously** over the shared
scripted market path:

* **array-resident pool state** — an (R, n_offerings) int64 count matrix
  drives the fleet-wide batched interrupt sampling; per-replica
  ``NodePool`` views are materialized only at decision/round boundaries,
  which is what keeps every float of the cost/perf accounting on the exact
  code path ``ClusterSim`` uses (``NodePool.hourly_cost`` / ``perf_rate``
  / ``_apply_losses`` — bit-identical accrual, not approximately-equal);
* **batched interrupt sampling** — one vectorized hazard evaluation per
  tick across the whole fleet (``pressure_interrupt_probability_batch``
  over the active columns of the count matrix), then one binomial draw
  per replica on that replica's own RNG stream.  The draws cannot be
  merged further without breaking the per-seed determinism contract —
  seed ``s`` must produce the byte-identical trace a standalone
  ``ClusterSim`` at ``interrupt_seed=s`` produces — and the vectorized
  single-replica sampler (``repro_torch.sim.interrupts``) already guarantees
  one RNG call per replica per tick;
* **cross-replica decision memoization** — replicas whose decision inputs
  coincide at a tick (market-state index, residual demand, excluded
  offerings, policy-state digest) share one GSS×ILP solve through the
  :class:`~repro_torch.core.provisioner.DecisionMemo` hook.  In steady state
  most replicas collapse onto a handful of unique solves per tick,
  turning O(R·solves) into O(unique·solves) + O(R) array work;
* **collect-then-solve tick phase** (DESIGN.md §12) — when replicas
  *diverge* (heterogeneous demand, differing exclusions) and the memo
  stops collapsing, each event gathers every memo-miss decision into a
  :class:`~repro_torch.core.provisioner.SolveBatch` and solves them as one
  cross-decision ``bracketed_gss_many`` — a single stacked engine
  invocation per golden round, dispatched through the pluggable solver
  backend (``backend=``: numpy, or the card's kernels through
  ``"torch"`` / ``"torch:fused"``; ``None`` is the process default, the
  card) — before launching.  Decision content is untouched: batched-on
  and batched-off runs produce byte-identical traces
  (``batch_decisions=False`` restores the sequential phase).

Determinism / equality contract: for every seed, the fleet replica's
``ProvisioningDecision`` sequence, ``SimRound`` list, ``total_cost``,
``total_perf_hours``, and (with ``record_traces=True``) the JSONL trace
are **identical** — floats bit-for-bit — to a standalone ``ClusterSim``
run and to ``run_replicas`` at the same seed (tests/test_fleet.py).
``apply_fulfillment`` scenarios are rejected for the same reason
``run_replicas`` rejects them: live fulfillment consumes the market price
RNG, which a shared scripted path cannot reproduce.

When to use what (DESIGN.md §11): ``ClusterSim`` for one run with live
event-stream consumers; ``run_replicas`` when per-replica trace recording
of a handful of seeds is the point; ``FleetSim`` for Monte-Carlo sweeps
(tens to thousands of seeds) where replica throughput dominates.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chaos.faults import ChaosController
from ..core import events_log
from ..core.backend import SolverBackend, make_backend
from ..core.efficiency import NodePool, Request
from ..core.market import Offering, pressure_interrupt_probability_batch
from ..core.market import snapshot_with
from ..core.provisioner import (DecisionMemo, PendingDecision, SolveBatch,
                                merge_pools)
from .engine import (SimResult, SimRound, _EPS, _INITIAL, _apply_losses,
                     _schedule, _split_pending, accrual_increments,
                     billable_pool, failed_decision, script_market_states,
                     shared_precompile, shock_affected, solver_down,
                     useful_scale)
from .events import (InterruptNotice, catalog_digest, decision_record,
                     demand_record, fault_record, fulfillment_record,
                     header_record, interrupts_record, market_state_record,
                     shock_record, summary_record, tick_record)
from .interrupts import (InterruptModel, NullInterruptModel,
                         PressureInterruptModel, PriceCrossingInterruptModel,
                         RebalanceRecommendationModel, make_interrupt_model)
from ..region.market import (apply_hazard_scale, hazard_scale_rows,
                             pool_egress_rate)
from .policy import make_policy
from .scenario import Scenario, Shock
from .trace import TraceRecorder


@dataclasses.dataclass
class _Replica:
    """Per-seed state the fleet cannot share: pool, RNG, policy, totals.

    ``request`` is per-replica because ``Scenario.demand_jitter`` makes the
    demand itself seed-dependent (heterogeneous-demand scenarios); without
    jitter every replica carries an equal copy of the shared request."""

    row: int                              # row in the fleet count matrix
    seed: int
    policy: object
    model: InterruptModel
    observers: List
    recorder: Optional[TraceRecorder]
    pool: NodePool
    request: Optional[Request] = None
    pending: List[InterruptNotice] = dataclasses.field(default_factory=list)
    total_cost: float = 0.0
    total_perf_hours: float = 0.0
    total_egress: float = 0.0
    cost_accrued_to: float = 0.0
    interrupted_nodes: int = 0
    decisions: List[Tuple[str, object]] = dataclasses.field(
        default_factory=list)
    rounds: List[SimRound] = dataclasses.field(default_factory=list)


class FleetSim:
    """Advance R scenario replicas in lockstep over one shared market path.

    Construction mirrors ``run_replicas``: one scenario, a sequence of
    interruption seeds, an optional explicit catalog.  ``run()`` returns
    one :class:`SimResult` per seed (same order), each carrying the
    fleet-wide cache counters in ``cache_stats``.

    ``record_traces=False`` (the default) skips building trace records —
    the big constant factor of a sweep — but changes nothing else; with
    ``record_traces=True`` every replica's trace is byte-identical to the
    standalone run's.  ``observer_factory(catalog)`` (optional) builds a
    fresh observer list per replica (e.g. a calibration probe), fed the
    identical event stream a standalone run would feed it.
    """

    def __init__(self, scenario: Scenario, interrupt_seeds: Sequence[int], *,
                 catalog: Optional[Sequence[Offering]] = None,
                 record_traces: bool = False, keep_snapshots: bool = False,
                 observer_factory: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None,
                 memoize: bool = True, batch_decisions: bool = True,
                 backend: Optional[SolverBackend] = None):
        if isinstance(backend, str):
            # convenience: FleetSim(..., backend="torch:fused") resolves the
            # registry spec exactly like make_backend would
            backend = make_backend(backend)
        if scenario.apply_fulfillment:
            raise ValueError(
                "FleetSim does not support apply_fulfillment scenarios: "
                "live fulfillment consumes the market price RNG, so replicas "
                "over a scripted market path would diverge from standalone "
                "runs; use independent ClusterSim runs for that sweep")
        self.scenario = scenario
        self.catalog = (list(catalog) if catalog is not None
                        else scenario.build_catalog())
        self.index = {o.offering_id: i for i, o in enumerate(self.catalog)}
        self._if_band = np.array([o.interruption_freq for o in self.catalog],
                                 dtype=np.float64)
        self.states = script_market_states(scenario, self.catalog)
        self.request = scenario.request()
        self.memo: Optional[DecisionMemo] = DecisionMemo() if memoize else None
        # collect-then-solve tick phase (DESIGN.md §12): decisions whose
        # policies support batching are gathered per event and solved as
        # one cross-decision bracketed_gss_many dispatch; decision content
        # is unchanged (tests prove batched-on ≡ batched-off traces)
        self.solve_batch: Optional[SolveBatch] = (
            SolveBatch(backend=backend) if batch_decisions else None)
        self.compile_cache: Dict = {}
        self.cache_stats: Dict[str, int] = {"compile_hits": 0,
                                            "compile_misses": 0}
        self.keep_snapshots = keep_snapshots
        self.record_traces = record_traces
        self.time = 0.0
        self.ticks = 0
        self.wall_seconds = 0.0
        self._state_pos = 0
        self._state_idx = -1
        self._spot: Optional[np.ndarray] = None
        self._t3: Optional[np.ndarray] = None
        self._snapshot: Optional[List[Offering]] = None
        self._snap_index: Dict[str, Offering] = {}
        self._ran = False

        # one shared chaos controller (DESIGN.md §16): every replica sees
        # the identical market path, so the observed-feed transformation is
        # fleet-wide — exactly what each standalone run would derive
        self.chaos = (ChaosController(scenario.faults, self.catalog)
                      if scenario.faults else None)
        self._events_snap = events_log.snapshot()

        # regional hazard regime + egress config (DESIGN.md §17), both
        # None outside a regional scenario so the inert path is untouched
        self._hazard_rows = hazard_scale_rows(scenario.region, self.catalog)
        self._egress_cfg = (scenario.region
                            if scenario.region is not None
                            and scenario.region.egress_per_pod_hour > 0.0
                            else None)

        digest = catalog_digest(self.catalog)
        policy_kwargs = {} if clock is None else {"clock": clock}
        self.replicas: List[_Replica] = []
        for row, seed in enumerate(interrupt_seeds):
            policy = make_policy(scenario.policy,
                                 tolerance=scenario.tolerance,
                                 ttl_hours=scenario.ttl_hours,
                                 region=scenario.region,
                                 **policy_kwargs)
            policy.bind(self.catalog)
            policy.bind_chaos(self.chaos)
            policy.set_decision_memo(self.memo)
            if self.solve_batch is not None:
                policy.set_solve_batch(self.solve_batch)
            model = make_interrupt_model(scenario.interrupt_model)
            model.reset(self.catalog, int(seed))
            if self._hazard_rows is not None:
                model.set_hazard_scale(dict(zip(
                    (o.offering_id for o in self.catalog),
                    self._hazard_rows.tolist())))
            extra = list(observer_factory(self.catalog)) \
                if observer_factory is not None else []
            recorder = None
            if record_traces:
                recorder = TraceRecorder()
                sc = dataclasses.replace(scenario, interrupt_seed=int(seed))
                recorder.write(header_record(sc.to_dict(), len(self.catalog),
                                             digest))
            self.replicas.append(_Replica(
                row=row, seed=int(seed), policy=policy, model=model,
                observers=[policy, *extra], recorder=recorder,
                pool=NodePool(items=[], counts=[]),
                request=self.request))
        # array-resident pool state: counts per (replica, offering), the
        # substrate of the fleet-wide batched interrupt sampling
        self.counts = np.zeros((len(self.replicas), len(self.catalog)),
                               dtype=np.int64)

    # -- shared-state plumbing ---------------------------------------------
    def _record_all(self, rec: Dict) -> None:
        if self.record_traces:
            for rep in self.replicas:
                rep.recorder.write(rec)

    def _refresh(self) -> None:
        """Pop the next scripted state; update the shared snapshot; fan the
        refresh out to every replica's observers (policy first, exactly the
        standalone fan-out order)."""
        spot, t3 = self.states[self._state_pos]
        self._state_pos += 1
        self._state_idx += 1
        # TRUE state: hazards (_spot/_t3/_snap_index) and billing stay in
        # reality; the policy decides on the chaos-observed snapshot
        # (DESIGN.md §16) — mirroring ClusterSim._refresh exactly
        self._spot, self._t3 = spot, t3
        recs = ([market_state_record(self.time, spot, t3)]
                if self.record_traces else None)
        if self.chaos is not None:
            spot_obs, t3_obs, transitions = self.chaos.observe(
                self._state_idx, self.time, spot, t3)
            if recs is not None:
                recs.extend(fault_record(self.time, kind, phase, idx)
                            for kind, phase, idx in transitions)
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
        for rep in self.replicas:
            if recs is not None:
                for rec in recs:
                    rep.recorder.write(rec)
            for obs in rep.observers:
                obs.observe_market(self.time, spot_obs, t3_obs)

    def _precompiled(self, request: Request):
        return shared_precompile(self.compile_cache, self.cache_stats,
                                 self._state_idx, self._snapshot, request)

    def _set_pool(self, rep: _Replica, pool: NodePool) -> None:
        rep.pool = pool
        row = self.counts[rep.row]
        row[:] = 0
        for it, c in zip(pool.items, pool.counts):
            row[self.index[it.offering.offering_id]] = c

    def _decide(self, rep: _Replica, call: Callable):
        """Run one replica's decision with the memo context bound to
        (shared market state, policy name, policy-state digest) — the
        per-replica part of the memo key contract (DESIGN.md §11).  Under
        the collect phase the result may be a :class:`PendingDecision`
        token; :meth:`_resolved` materializes it after the batch runs."""
        if self.memo is None:
            return call()
        self.memo.context = (self._state_idx, rep.policy.name,
                             rep.policy.memo_digest())
        try:
            return call()
        finally:
            self.memo.context = None

    def _execute_batch(self) -> None:
        if self.solve_batch is not None and len(self.solve_batch):
            self.solve_batch.execute()

    @staticmethod
    def _resolved(decision):
        if isinstance(decision, PendingDecision):
            return decision.resolve()
        return decision

    # -- per-replica accounting (ClusterSim's exact float sequence, via the
    # shared engine helpers) ------------------------------------------------
    def _accrue_cost(self, rep: _Replica, now: float) -> None:
        dt = now - rep.cost_accrued_to
        cost, perf = accrual_increments(rep.pool, rep.request.pods, dt)
        rep.total_cost += cost
        rep.total_perf_hours += perf
        if self._egress_cfg is not None:
            egress = pool_egress_rate(self._egress_cfg, rep.pool) * dt
            rep.total_cost += egress
            rep.total_egress += egress
        rep.cost_accrued_to = now

    def _notify_pool(self, rep: _Replica, reason: str) -> None:
        """Formal observer-protocol pool fan-out, mirroring
        ``ClusterSim._notify_pool`` (fleet ≡ standalone event streams)."""
        for obs in rep.observers:
            obs.observe_pool(self.time, rep.pool, reason)

    def _launch(self, rep: _Replica, decision, reason: str,
                base_pool: Optional[NodePool] = None) -> None:
        new_pool = billable_pool(self.chaos, self._snap_index,
                                 decision.pool)
        # ICE clip: pure function of the REQUESTED counts, identical to
        # ClusterSim._launch's chaos branch (apply_fulfillment scenarios
        # are rejected at construction, so grants start at requested)
        caps = (self.chaos.ice_caps(self.time, new_pool.as_dict())
                if self.chaos is not None and new_pool.total_nodes
                else None)
        if caps is not None:
            requested = new_pool.as_dict()
            grants = {oid: min(g, caps.get(oid, g))
                      for oid, g in requested.items()}
            if rep.recorder is not None:
                rep.recorder.write(fulfillment_record(self.time, grants))
            for obs in rep.observers:
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
        if rep.recorder is not None:
            rep.recorder.write(decision_record(
                self.time, reason, rep.policy.name,
                decision.pool.as_dict(), decision.alpha, decision.metrics))
        rep.decisions.append((reason, decision))
        if base_pool is not None and base_pool.total_nodes:
            self._set_pool(rep, merge_pools(base_pool, new_pool))
        else:
            self._set_pool(rep, new_pool)
        self._notify_pool(rep, reason)

    # -- events (each: collect decisions → execute batch → launch) ----------
    def _on_initial(self) -> None:
        self._refresh()
        staged = []
        for rep in self.replicas:
            if self.scenario.demand_jitter:
                rep.request = dataclasses.replace(
                    rep.request, pods=self.scenario.effective_pods(
                        rep.seed, 0.0, self.scenario.pods))
            if solver_down(self.chaos, rep.policy, self.time):
                staged.append((rep, failed_decision(rep.request)))
                continue
            pre = self._precompiled(rep.request)
            decision = self._decide(
                rep, lambda rep=rep, pre=pre: rep.policy.provision(
                    rep.request, self._snapshot, self.time, precompiled=pre))
            staged.append((rep, decision))
        self._execute_batch()
        for rep, decision in staged:
            self._launch(rep, self._resolved(decision), "initial")

    def _on_shock(self, shock: Shock) -> None:
        if self.record_traces:
            self._record_all(shock_record(self.time, shock.kind,
                                          shock.selector, shock.factor,
                                          shock_affected(self.catalog,
                                                         shock)))
        self._refresh()

    def _on_demand(self, pods: int) -> None:
        for rep in self.replicas:
            self._accrue_cost(rep, self.time)
        self.request = dataclasses.replace(self.request, pods=pods)
        staged = []
        for rep in self.replicas:
            rpods = self.scenario.effective_pods(rep.seed, self.time, pods)
            rep.request = dataclasses.replace(rep.request, pods=rpods)
            if rep.recorder is not None:
                rep.recorder.write(demand_record(self.time, rpods))
            shortfall = rpods - rep.pool.total_pods
            if shortfall <= 0 and rep.pool.total_nodes:
                continue
            repl_request = (dataclasses.replace(rep.request, pods=shortfall)
                            if rep.pool.total_nodes else rep.request)
            if solver_down(self.chaos, rep.policy, self.time):
                staged.append((rep, failed_decision(repl_request)))
                continue
            pre = self._precompiled(repl_request)
            decision = self._decide(
                rep, lambda rep=rep, req=repl_request, pre=pre:
                rep.policy.provision(req, self._snapshot, self.time,
                                     precompiled=pre))
            staged.append((rep, decision))
        self._execute_batch()
        for rep, decision in staged:
            self._launch(rep, self._resolved(decision), "demand",
                         base_pool=rep.pool if rep.pool.total_nodes else None)

    def _on_tick(self, t: float, dt: float) -> None:
        self.ticks += 1
        scales = []
        for rep in self.replicas:
            scales.append(useful_scale(rep.pool,     # interval's pool
                                       rep.request.pods))
            self._accrue_cost(rep, t)
        self._record_all(tick_record(t, dt))
        self._refresh()
        pool_dicts = [rep.pool.as_dict() for rep in self.replicas]
        sampled_fleet = self._sample_fleet(dt, t, pool_dicts)
        staged = []
        for rep, scale, sampled, pool_dict in zip(self.replicas, scales,
                                                  sampled_fleet, pool_dicts):
            matured = any(n.effective_time <= t + _EPS for n in rep.pending)
            if (self.scenario.inject_if_idle and not sampled and not matured
                    and any(c > 0 for c in pool_dict.values())):
                oid, c = max(pool_dict.items(), key=lambda kv: kv[1])
                sampled = [InterruptNotice(time=t, offering_id=oid, count=c,
                                           reason="fault-injection")]
            if rep.recorder is not None:
                rep.recorder.write(interrupts_record(t, sampled))
            for obs in rep.observers:
                obs.observe_interrupts(t, dt, pool_dict, sampled)
            effective, rep.pending = _split_pending(rep.pending, sampled, t)

            survivors, lost_nodes, lost_pods, lost_perf = _apply_losses(
                rep.pool, effective)
            rep.total_perf_hours -= 0.5 * dt * lost_perf * scale
            rep.interrupted_nodes += lost_nodes
            decision, shortfall = None, 0
            if effective:
                shortfall = max(0, rep.request.pods - survivors.total_pods)
                if solver_down(self.chaos, rep.policy, t):
                    decision = (failed_decision(dataclasses.replace(
                        rep.request, pods=shortfall)) if shortfall > 0
                        else None)
                else:
                    pre = self._precompiled(rep.request)
                    decision = self._decide(
                        rep, lambda rep=rep, eff=effective, surv=survivors,
                        pre=pre: rep.policy.on_interrupts(
                            eff, rep.request, self._snapshot,
                            surv.total_pods, t, precompiled=pre))
            staged.append((rep, sampled, effective, survivors, lost_nodes,
                           lost_pods, lost_perf, shortfall, decision))
        self._execute_batch()
        for (rep, sampled, effective, survivors, lost_nodes, lost_pods,
             lost_perf, shortfall, decision) in staged:
            decision = self._resolved(decision)
            if effective:
                self._set_pool(rep, survivors)
                if decision is not None:
                    self._launch(rep, decision, "interrupt",
                                 base_pool=survivors)
                else:
                    self._notify_pool(rep, "losses")
            rep.rounds.append(SimRound(
                time=t, notices=list(sampled), effective=effective,
                lost_nodes=lost_nodes, lost_pods=lost_pods,
                shortfall=shortfall, decision=decision, pool=rep.pool,
                snapshot=self._snapshot if self.keep_snapshots else None,
                lost_perf=lost_perf))

    # -- batched interrupt sampling -----------------------------------------
    def _sample_fleet(self, dt: float, now: float,
                      pool_dicts: List[Dict[str, int]],
                      ) -> List[List[InterruptNotice]]:
        """Per-replica notice lists for this tick, drawn fleet-wide.

        Known models get the batched path (one shared hazard matrix /
        crossing mask per tick; per-replica draws only where the per-seed
        RNG contract demands them), delegating every piece of model
        *semantics* — the crossing rule, the advisory-lead stamping, the
        binomial draw — back to the model's own methods so there is one
        definition of each.  An unknown custom model falls back to its
        per-replica ``sample`` — still one vectorized call per replica if
        it follows the ``PressureInterruptModel`` idiom.
        """
        if not self.replicas:
            return []
        proto = self.replicas[0].model
        wrapper = None
        if isinstance(proto, RebalanceRecommendationModel):
            wrapper = proto
            inner_of = lambda m: m.inner               # noqa: E731
            proto = proto.inner
        else:
            inner_of = lambda m: m                     # noqa: E731

        if isinstance(proto, NullInterruptModel):
            per = [[] for _ in self.replicas]
        elif isinstance(proto, PriceCrossingInterruptModel):
            # deterministic, market-wide: one crossing mask for the fleet
            # (bids are seed-independent, so replica 0's model speaks for
            # all; the rule itself lives in crossed_ids)
            crossed = proto.crossed_ids(self._snap_index)
            per = [[InterruptNotice(time=now, offering_id=oid, count=c,
                                    reason="price-crossing")
                    for oid, c in pool.items() if c > 0 and oid in crossed]
                   for pool in pool_dicts]
        elif isinstance(proto, PressureInterruptModel):
            per = self._sample_pressure(inner_of, dt, now, pool_dicts)
        else:
            return [rep.model.sample(self._snap_index, pool, dt, now)
                    for rep, pool in zip(self.replicas, pool_dicts)]

        if wrapper is not None:
            per = [wrapper.wrap(notices) for notices in per]
        return per

    def _sample_pressure(self, inner_of, dt: float, now: float,
                         pool_dicts: List[Dict[str, int]],
                         ) -> List[List[InterruptNotice]]:
        """One vectorized hazard evaluation across the whole fleet (the
        (R, active) probability matrix from the count matrix), then one
        binomial draw per replica on its own stream — bitwise the same
        probabilities and the same RNG consumption as R standalone runs."""
        active = np.flatnonzero(self.counts.any(axis=0))
        if active.size == 0:
            return [[] for _ in self.replicas]
        probs = pressure_interrupt_probability_batch(
            self.counts[:, active],
            self._t3[active].astype(np.float64),
            self._if_band[active], dt)
        if self._hazard_rows is not None:
            # regional hazard regime: same law (apply_hazard_scale), same
            # float sequence as the standalone model's per-entry path
            probs = apply_hazard_scale(probs, self._hazard_rows[active])
        col = {int(c): j for j, c in enumerate(active)}
        per: List[List[InterruptNotice]] = []
        for rep, pool in zip(self.replicas, pool_dicts):
            entries = [(oid, c) for oid, c in pool.items() if c > 0]
            if not entries:
                per.append([])
                continue
            counts = np.array([c for _, c in entries], dtype=np.int64)
            p = probs[rep.row, [col[self.index[oid]] for oid, _ in entries]]
            lost = inner_of(rep.model).draw_lost_counts(counts, p)
            per.append([InterruptNotice(time=now, offering_id=oid,
                                        count=int(k))
                        for (oid, _), k in zip(entries, lost) if k > 0])
        return per

    # -- run ----------------------------------------------------------------
    def run(self) -> List[SimResult]:
        if self._ran:
            raise RuntimeError("FleetSim.run() may only be called once; "
                               "construct a new FleetSim per sweep")
        self._ran = True
        t0 = time.perf_counter()
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
        results = []
        base_stats = self.stats()
        for k, v in events_log.delta_since(self._events_snap).items():
            base_stats[f"event_{k}"] = base_stats.get(f"event_{k}", 0) + v
        for rep in self.replicas:
            if rep.recorder is not None:
                rep.recorder.write(summary_record(
                    self.time, rep.total_cost, rep.interrupted_nodes,
                    len(rep.decisions), rep.pool.as_dict()))
            stats = dict(base_stats)
            chaos_stats = getattr(rep.policy, "chaos_stats", None)
            if chaos_stats is not None:
                for k, v in chaos_stats().items():
                    stats[f"chaos_{k}"] = v
            results.append(SimResult(
                scenario=dataclasses.replace(self.scenario,
                                             interrupt_seed=rep.seed),
                decisions=rep.decisions, rounds=rep.rounds,
                total_cost=rep.total_cost,
                interrupted_nodes=rep.interrupted_nodes,
                pool=rep.pool, recorder=rep.recorder or TraceRecorder(),
                total_perf_hours=rep.total_perf_hours,
                total_egress=rep.total_egress,
                cache_stats=stats))
        self.wall_seconds = time.perf_counter() - t0
        return results

    def stats(self) -> Dict[str, int]:
        """Fleet-wide cache-effectiveness counters (also stamped onto every
        returned ``SimResult.cache_stats``)."""
        out = dict(self.cache_stats)
        out["replicas"] = len(self.replicas)
        out["ticks"] = self.ticks
        if self.memo is not None:
            out.update(self.memo.stats())
        if self.solve_batch is not None:
            be = self.solve_batch.backend
            info = getattr(be, "device_cache_info", None)
            if callable(info):
                for k, v in info().items():
                    out[f"device_cache_{k}"] = v
        return out


def run_fleet(scenario: Scenario, interrupt_seeds: Sequence[int], *,
              catalog: Optional[Sequence[Offering]] = None,
              record_traces: bool = False, keep_snapshots: bool = False,
              observer_factory: Optional[Callable] = None,
              clock: Optional[Callable[[], float]] = None,
              memoize: bool = True, batch_decisions: bool = True,
              backend: Optional[SolverBackend] = None) -> List[SimResult]:
    """Accelerated ``run_replicas``: one :class:`SimResult` per seed,
    per-seed identical to standalone ``ClusterSim`` runs — decisions,
    rounds, and float totals always; the JSONL trace too, but **only with
    ``record_traces=True``**.  By default no trace records are built (the
    big constant factor of a sweep), so ``result.records`` /
    ``decision_records()`` are empty — pass ``record_traces=True`` when a
    consumer (e.g. ``calibration_report``) reads the trace."""
    return FleetSim(scenario, interrupt_seeds, catalog=catalog,
                    record_traces=record_traces,
                    keep_snapshots=keep_snapshots,
                    observer_factory=observer_factory, clock=clock,
                    memoize=memoize, batch_decisions=batch_decisions,
                    backend=backend).run()


def run_fleet_paths(scenario: Scenario, path_seeds: Sequence[int],
                    interrupt_seeds: Sequence[int],
                    **kwargs) -> List[List[SimResult]]:
    """Sweep *correlated market paths* on top of the interrupt-seed sweep
    (DESIGN.md §17): one FleetSim per ``path_seed``, each re-deriving the
    scenario's regional shock stream from ``shock_seed=path_seed`` — the
    shared factor ``z0`` moves every region together within a path while
    paths stay independent.  Requires a regional scenario
    (``scenario.region`` set); returns one result list per path seed, in
    order, each aligned to ``interrupt_seeds``.  Every inner run keeps the
    per-seed fleet ≡ standalone contract verbatim, since a path is just a
    scenario with a different ``RegionConfig.shock_seed``."""
    if scenario.region is None:
        raise ValueError("run_fleet_paths needs a regional scenario "
                         "(scenario.region is None)")
    out: List[List[SimResult]] = []
    for ps in path_seeds:
        sc = dataclasses.replace(
            scenario, region=dataclasses.replace(scenario.region,
                                                 shock_seed=int(ps)))
        out.append(run_fleet(sc, interrupt_seeds, **kwargs))
    return out
