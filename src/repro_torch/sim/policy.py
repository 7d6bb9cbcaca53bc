"""Pluggable provisioning policies for the scenario engine.

Every policy answers the same two questions the engine asks —

  * ``provision(request, snapshot, now)``: build a pool from scratch
    (initial provisioning, demand changes), and
  * ``on_interrupts(notices, request, snapshot, surviving_pods, now)``:
    react to capacity loss by provisioning the shortfall with the
    interrupted offerings excluded (the §4.1 loop)

— and returns the core :class:`ProvisioningDecision`, so KubePACS, a
Karpenter-like baseline, and fixed-α ablations all produce comparable,
trace-recordable decision sequences.  Policies must be deterministic
functions of their inputs (no RNG, no wall clock in the decision content):
that is what makes trace replay reproduce identical decisions.  The
diagnostic ``wall_seconds`` stamp goes through an injectable ``clock`` so
tests can assert *full* ``ProvisioningDecision`` equality.

Policies are also engine *observers* (DESIGN.md §10): the engine feeds
them the event stream (market refreshes, interrupt samples, fulfillment
grants) through the no-op ``observe_*`` hooks below.  Stateful policies —
``kubepacs_risk`` updates its online risk estimators this way — therefore
stay deterministic under replay: the recorded stream re-derives the
identical estimator state at every decision point.

Spec strings (``Scenario.policy``):

    "kubepacs"               guarded GSS × ILP (the paper's method)
    "kubepacs_unguarded"     pure Algorithm-1 GSS over α ∈ [0, 1]
    "kubepacs_risk[:H]"      risk-adjusted E_risk over an H-hour horizon
                             (default 12) — DESIGN.md §10
    "karpenter_like"         price-capacity-optimized baseline (§5.4)
    "fixed_alpha:<α>"        single ILP solve at a fixed α (Table 2)
    "serving_slo[:H]"        SLO-driven serving: QPS/pod objective from the
                             roofline perf model + latency-SLO feasibility
                             mask; optional H-hour risk discount
                             (DESIGN.md §15)
    "kubepacs_region"        KubePACS objective + the scenario RegionConfig's
                             side-constraints (caps / spread / egress)
                             through solve_with_regions (DESIGN.md §17)
    "region_pinned[:R]"      the single-market strawman: provision only in
                             region R (default: the config's home region) —
                             what bench_region measures hardened against

The optional ``precompiled=(items, CompiledMarket)`` argument lets the
multi-seed runner share one preprocessed market across N replica policies
(the batched engine is then reused instead of re-solving per replica).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.efficiency import (CandidateItem, NodePool, Request,
                               decision_metrics, pool_capacity_rate)
from ..core.gss import bracketed_gss
from ..core.ilp import CompiledMarket, compile_market, solve_ilp
from ..core.market import Offering
from ..core.baselines import karpenter_like
from ..core.provisioner import (DecisionMemo, KubePACSProvisioner,
                                ProvisioningDecision,
                                UnavailableOfferingsCache, exclusion_mask,
                                preprocess)
from ..risk.estimators import RiskEstimators, RiskParams
from ..risk.objective import (e_risk, reweight_candidates, risk_adjustment,
                              serving_risk_adjustment)
from ..serve_sim.perf_model import (ServingProfile, default_profile,
                                    default_slo_ms, serving_table)
from .events import InterruptNotice

Precompiled = Tuple[List[CandidateItem], CompiledMarket]

#: default forecasting horizon (hours) of "kubepacs_risk" without ":H"
DEFAULT_RISK_HORIZON = 12.0


class Policy:
    name = "abstract"
    decision_memo: Optional[DecisionMemo] = None

    def provision(self, request: Request, snapshot: Sequence[Offering],
                  now: float, precompiled: Optional[Precompiled] = None,
                  ) -> ProvisioningDecision:
        raise NotImplementedError

    def on_interrupts(self, notices: Sequence[InterruptNotice],
                      request: Request, snapshot: Sequence[Offering],
                      surviving_pods: int, now: float,
                      precompiled: Optional[Precompiled] = None,
                      ) -> Optional[ProvisioningDecision]:
        raise NotImplementedError

    # -- cross-replica memoization hooks (DESIGN.md §11) --------------------
    def set_decision_memo(self, memo: Optional[DecisionMemo]) -> None:
        """Attach the fleet engine's shared :class:`DecisionMemo` (None
        detaches).  Policies that route their solve through the memo must
        key it on *everything* decision-relevant; stateful policies
        additionally surface their internal state via :meth:`memo_digest`."""
        self.decision_memo = memo

    def memo_digest(self) -> Optional[str]:
        """Digest of internal decision-relevant state beyond the (snapshot,
        request, excluded-set) the memo key already covers.  ``None`` means
        the policy is stateless given those inputs (the KubePACS/baseline
        policies — their only state is the TTL exclusion cache, which the
        memo key captures as the resolved excluded frozenset)."""
        return None

    def set_solve_batch(self, batch) -> None:
        """Attach the fleet engine's collect-then-solve :class:`SolveBatch`
        (DESIGN.md §12).  Base implementation: no-op — policies without a
        batchable guarded-GSS solve path simply keep solving inline, which
        is always correct (batching changes execution, never content)."""

    # -- engine observer hooks (no-ops for stateless policies) --------------
    def bind(self, catalog: Sequence[Offering]) -> None:
        """Called once by the engine with the static offering universe."""

    def bind_chaos(self, chaos) -> None:
        """Attach the scenario's :class:`~repro_torch.chaos.faults.ChaosController`
        (None when the scenario declares no faults).  Base implementation:
        no-op — unhardened policies decide on whatever (possibly corrupted)
        snapshot the engine hands them, which is exactly the naive control
        plane the chaos benchmark measures against (DESIGN.md §16)."""

    def observe_market(self, time: float, spot: np.ndarray,
                       t3: np.ndarray) -> None:
        """A market refresh (tick or shock) produced live (spot, t3)."""

    def observe_interrupts(self, time: float, dt: float,
                           pool: Dict[str, int],
                           notices: Sequence[InterruptNotice]) -> None:
        """A tick sampled ``notices`` for ``pool`` exposed over ``dt``."""

    def observe_fulfillment(self, time: float, requested: Dict[str, int],
                            grants: Dict[str, int]) -> None:
        """A launch's fulfillment round granted ``grants`` of ``requested``."""

    def observe_pool(self, time: float, pool: NodePool,
                     reason: str) -> None:
        """The engine's pool changed (launch merge or interruption losses)
        — the serving co-simulation's capacity-timeline hook (§15)."""


class KubePACSPolicy(Policy):
    """The paper's provisioner, including its UnavailableOfferingsCache."""

    name = "kubepacs"

    def __init__(self, tolerance: float = 0.01, ttl_hours: float = 2.0,
                 guarded: bool = True,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.provisioner = KubePACSProvisioner(tolerance=tolerance,
                                               ttl_hours=ttl_hours,
                                               guarded_gss=guarded,
                                               timer=clock)
        if not guarded:
            self.name = "kubepacs_unguarded"

    def set_decision_memo(self, memo):
        self.decision_memo = memo
        self.provisioner.decision_memo = memo

    def set_solve_batch(self, batch):
        # the provisioner's guarded path defers memo-miss solves into the
        # batch; the unguarded variant ignores it (provisioner-side check)
        self.provisioner.solve_batch = batch

    def provision(self, request, snapshot, now, precompiled=None):
        self.provisioner.clock = now
        return self.provisioner.provision(request, snapshot, precompiled)

    def on_interrupts(self, notices, request, snapshot, surviving_pods, now,
                      precompiled=None):
        self.provisioner.clock = now
        self.provisioner.enqueue([n.to_core() for n in notices])
        return self.provisioner.handle_interrupts(
            request, snapshot, surviving_pods=surviving_pods,
            precompiled=precompiled)


class _BaselinePolicy(Policy):
    """Shared §4.1 plumbing (TTL exclusion cache, shortfall requests) for
    baselines that are not the KubePACS provisioner."""

    def __init__(self, ttl_hours: float = 2.0,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.cache = UnavailableOfferingsCache(ttl_hours)
        self.clock = clock

    def _solve(self, items: List[CandidateItem], req_pods: int,
               exclude: Optional[np.ndarray],
               precompiled: Optional[Precompiled]) -> Tuple[NodePool, Optional[float]]:
        raise NotImplementedError

    def _extra_mask(self, items: List[CandidateItem]) -> Optional[np.ndarray]:
        """Optional per-candidate feasibility mask ORed into the §4.1
        exclusion path (None = no constraint — the default is bit-inert;
        ``exclusion_mask(…, extra=None)`` is the pre-existing call)."""
        return None

    def provision(self, request, snapshot, now, precompiled=None):
        t0 = self.clock()
        excluded = self.cache.excluded(now)
        memo = self.decision_memo
        mkey = memo.key(request, excluded) if memo is not None else None
        if mkey is not None:
            hit = memo.fetch(mkey, self.clock() - t0)
            if hit is not None:
                return hit
        items = precompiled[0] if precompiled is not None \
            else preprocess(snapshot, request)
        exclude = exclusion_mask(items, excluded,
                                 extra=self._extra_mask(items))
        pool, alpha = self._solve(items, request.pods, exclude, precompiled)
        pool.request = request
        pool.alpha = alpha
        decision = ProvisioningDecision(
            pool=pool, trace=None, alpha=alpha,
            wall_seconds=self.clock() - t0,
            excluded_offerings=excluded,
            metrics=decision_metrics(pool, request.pods))
        if mkey is not None:
            memo.store(mkey, decision)
        return decision

    def on_interrupts(self, notices, request, snapshot, surviving_pods, now,
                      precompiled=None):
        if not notices:
            return None
        for n in notices:
            self.cache.add(n.offering_id, now)
        shortfall = max(0, request.pods - surviving_pods)
        if shortfall == 0:
            return None
        repl = dataclasses.replace(request, pods=shortfall)
        return self.provision(repl, snapshot, now, precompiled)


class FixedAlphaPolicy(_BaselinePolicy):
    """Single ILP solve at a fixed α — the Table 2 ablation as a policy."""

    def __init__(self, alpha: float, ttl_hours: float = 2.0,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        super().__init__(ttl_hours, clock)
        self.alpha = float(alpha)
        self.name = f"fixed_alpha:{alpha:g}"

    def _solve(self, items, req_pods, exclude, precompiled):
        market = precompiled[1] if precompiled is not None else None
        counts = solve_ilp(items, req_pods, self.alpha, market=market,
                           exclude=exclude)
        if counts is None:
            return NodePool(items=[], counts=[]), self.alpha
        return NodePool(items=list(items), counts=list(counts)).nonzero(), \
            self.alpha


class KarpenterLikePolicy(_BaselinePolicy):
    """Price-capacity-optimized consolidation (no BS/T3 awareness, §5.4)."""

    name = "karpenter_like"

    def _solve(self, items, req_pods, exclude, precompiled):
        if exclude is not None:
            items = [it for it, ex in zip(items, exclude) if not ex]
        return karpenter_like(items, req_pods), None


class KubePACSRiskPolicy(_BaselinePolicy):
    """Risk-adjusted KubePACS: guarded GSS × ILP over E_risk (DESIGN.md §10).

    Decisions maximize the risk-adjusted efficiency of
    :mod:`repro_torch.risk.objective` — Perf_i discounted by expected uptime and
    fulfillment rate, SP_i charged with drifted price and expected
    re-provision cost over ``horizon`` hours — by substituting adjusted
    (Perf̂, SP̂) vectors into the *unchanged* solver stack.  The
    returned pool references the real items, so cost accrual and the
    canonical metrics stay in real dollars; the optimized risk score rides
    along as the extra ``e_risk`` metric.  The §4.1 exclusion/shortfall
    protocol is inherited from :class:`_BaselinePolicy`.

    Deterministic given (snapshot, estimator state): estimators update only
    through the engine's observe hooks, which replay feeds the identical
    recorded stream.
    """

    def __init__(self, horizon: float = DEFAULT_RISK_HORIZON,
                 tolerance: float = 0.01, ttl_hours: float = 2.0,
                 params: Optional[RiskParams] = None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        super().__init__(ttl_hours, clock)
        self.horizon = float(horizon)
        self.name = f"kubepacs_risk:{self.horizon:g}"
        self.tolerance = tolerance
        self.params = params or RiskParams()
        self.estimators: Optional[RiskEstimators] = None
        # compiled-market cache mirroring KubePACSProvisioner._compiled:
        # preprocessing/bundle-splitting depends only on (snapshot identity,
        # per-pod request shape), so the same-tick §4.1 re-provision reuses
        # the initial decision's CompiledMarket and only the O(n)
        # reweighting runs per solve
        self._market_snapshot: Optional[Sequence[Offering]] = None
        self._market_shape: Optional[Tuple] = None
        self._market_items: List[CandidateItem] = []
        self._market: Optional[CompiledMarket] = None

    # -- estimator lifecycle -----------------------------------------------
    def bind(self, catalog):
        self.estimators = RiskEstimators(catalog, self.params)

    def _ensure_estimators(self, snapshot) -> RiskEstimators:
        # standalone use (no engine): bind lazily to the first snapshot —
        # offering order there matches the catalog (snapshot_with preserves
        # it), so indices line up with later observations
        if self.estimators is None:
            self.estimators = RiskEstimators(snapshot, self.params)
        return self.estimators

    def observe_market(self, time, spot, t3):
        if self.estimators is not None:
            self.estimators.on_market_state(time, spot, t3)

    def observe_interrupts(self, time, dt, pool, notices):
        if self.estimators is not None:
            self.estimators.on_interrupts(time, dt, pool, notices)

    def observe_fulfillment(self, time, requested, grants):
        if self.estimators is not None:
            self.estimators.on_fulfillment(time, requested, grants)

    # -- decisions ----------------------------------------------------------
    def _compiled(self, request, snapshot,
                  precompiled: Optional[Precompiled]) -> Precompiled:
        if precompiled is not None:
            return precompiled
        # the held snapshot reference keeps it alive, so the identity check
        # cannot alias a recycled object id
        shape = (request.cpu_per_pod, request.mem_per_pod, request.workload)
        if snapshot is not self._market_snapshot or \
                shape != self._market_shape:
            items = preprocess(snapshot, request)
            self._market_snapshot = snapshot
            self._market_shape = shape
            self._market_items = items
            self._market = compile_market(items)
        return self._market_items, self._market

    def memo_digest(self):
        # the estimator arrays are the only decision-relevant state beyond
        # the memo key's (snapshot, request, excluded) — two replicas with
        # identical observation histories share identical digests, so their
        # risk-adjusted solves coincide (DESIGN.md §11)
        if self.estimators is None:
            return None
        return self.estimators.digest()

    def provision(self, request, snapshot, now, precompiled=None):
        t0 = self.clock()
        est = self._ensure_estimators(snapshot)
        excluded = self.cache.excluded(now)
        memo = self.decision_memo
        mkey = memo.key(request, excluded) if memo is not None else None
        if mkey is not None:
            hit = memo.fetch(mkey, self.clock() - t0)
            if hit is not None:
                return hit
        items, market = self._compiled(request, snapshot, precompiled)
        exclude = exclusion_mask(items, excluded)
        adj = risk_adjustment(items, est, self.horizon)
        items_adj, market_adj = reweight_candidates(items, adj, market)
        pool_adj, trace = bracketed_gss(items_adj, request.pods,
                                        tolerance=self.tolerance,
                                        market=market_adj, exclude=exclude,
                                        timer=self.clock)
        if pool_adj is None:     # demand exceeds bounded capacity
            pool = NodePool(items=[], counts=[], request=request)
            alpha = None
            risk_score = 0.0
        else:
            # map the solved counts back onto the real items so downstream
            # cost/perf accounting uses live market numbers, not Perf̂/SP̂
            real = {it.offering.offering_id: it for it in items}
            pool = NodePool(
                items=[real[it.offering.offering_id]
                       for it in pool_adj.items],
                counts=list(pool_adj.counts), alpha=pool_adj.alpha,
                request=request)
            alpha = pool_adj.alpha
            risk_score = e_risk(pool, request.pods, items_adj)
        metrics = decision_metrics(pool, request.pods)
        metrics["e_risk"] = risk_score
        decision = ProvisioningDecision(pool=pool, trace=trace, alpha=alpha,
                                        wall_seconds=self.clock() - t0,
                                        excluded_offerings=excluded,
                                        metrics=metrics)
        if mkey is not None:
            memo.store(mkey, decision)
        return decision


class ServingSLOPolicy(KubePACSRiskPolicy):
    """SLO-driven serving provisioning (DESIGN.md §15): the decision plane
    connected to the ML stack's perf model.

    Two changes relative to the scalar-perf policies, both through
    existing solver entry points:

    * **objective** — Perf_i is replaced by the serving capacity rate
      ``QPS/pod_i · Pod_i`` from :mod:`repro_torch.serve_sim.perf_model`
      (roofline-derived, analytic fallback without jax), so GSS × ILP
      maximizes *served QPS per dollar* instead of CoreMark per dollar;
    * **feasibility** — offerings whose per-request decode latency
      exceeds ``slo_ms`` are ORed into the §4.1 exclusion mask
      (``exclusion_mask(extra=)``), entering ``solve_ilp`` as hard
      infeasibility, exactly like TTL-cached interrupted offerings.

    Inherits the risk policy's machinery: the compiled-market cache, the
    §4.1 shortfall protocol, and the online estimators — with
    ``risk_horizon > 0`` the serving rate is additionally discounted by
    expected uptime × fulfillment via
    :func:`repro_torch.risk.objective.serving_risk_adjustment` (at the default
    horizon 0 that reduces exactly to the pure serving objective).
    Deterministic given (snapshot, estimator state): the serving table is
    a pure function of (profile, offering set), cached by digest.
    """

    def __init__(self, profile: Optional[ServingProfile] = None,
                 slo_ms: Optional[float] = None, risk_horizon: float = 0.0,
                 tolerance: float = 0.01, ttl_hours: float = 2.0,
                 params: Optional[RiskParams] = None,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        super().__init__(horizon=risk_horizon, tolerance=tolerance,
                         ttl_hours=ttl_hours, params=params, clock=clock)
        self.profile = profile if profile is not None else default_profile()
        self.slo_ms = float(slo_ms) if slo_ms is not None \
            else default_slo_ms(self.profile)
        self.name = ("serving_slo" if risk_horizon <= 0
                     else f"serving_slo:{risk_horizon:g}")

    def memo_digest(self):
        # beyond the risk digest, decisions depend on the perf-model table
        # (profile digest pins mode/config/shape) and the SLO threshold
        base = super().memo_digest() or ""
        return f"{base}|{self.profile.digest}|{self.slo_ms!r}"

    def provision(self, request, snapshot, now, precompiled=None):
        t0 = self.clock()
        est = self._ensure_estimators(snapshot)
        excluded = self.cache.excluded(now)
        memo = self.decision_memo
        mkey = memo.key(request, excluded) if memo is not None else None
        if mkey is not None:
            hit = memo.fetch(mkey, self.clock() - t0)
            if hit is not None:
                return hit
        items, market = self._compiled(request, snapshot, precompiled)
        table = serving_table(self.profile,
                              [it.offering for it in items])
        slo_mask = table.slo_mask(self.slo_ms)
        exclude = exclusion_mask(items, excluded, extra=slo_mask)
        # serving capacity rate per node, risk-discounted when horizon > 0
        serve_perf = table.qps_per_pod * np.array(
            [it.pods for it in items], dtype=np.float64)
        base_perf = np.array([it.perf for it in items], dtype=np.float64)
        adj = serving_risk_adjustment(
            risk_adjustment(items, est, self.horizon), serve_perf, base_perf)
        items_adj, market_adj = reweight_candidates(items, adj, market)
        pool_adj, trace = bracketed_gss(items_adj, request.pods,
                                        tolerance=self.tolerance,
                                        market=market_adj, exclude=exclude,
                                        timer=self.clock)
        if pool_adj is None:     # demand exceeds SLO-feasible capacity
            pool = NodePool(items=[], counts=[], request=request)
            alpha = None
        else:
            real = {it.offering.offering_id: it for it in items}
            pool = NodePool(
                items=[real[it.offering.offering_id]
                       for it in pool_adj.items],
                counts=list(pool_adj.counts), alpha=pool_adj.alpha,
                request=request)
            alpha = pool_adj.alpha
        metrics = decision_metrics(pool, request.pods)
        qps = table.qps_map()
        metrics["serve_qps_capacity"] = pool_capacity_rate(pool, qps)
        metrics["serve_slo_masked"] = float(0 if slo_mask is None
                                            else int(slo_mask.sum()))
        metrics["serve_infeasible"] = float(pool_adj is None)
        decision = ProvisioningDecision(pool=pool, trace=trace, alpha=alpha,
                                        wall_seconds=self.clock() - t0,
                                        excluded_offerings=excluded,
                                        metrics=metrics)
        if mkey is not None:
            memo.store(mkey, decision)
        return decision


def make_policy(spec: str, tolerance: float = 0.01,
                ttl_hours: float = 2.0,
                clock: Callable[[], float] = time.perf_counter,
                region=None) -> Policy:
    """Parse a scenario's policy spec string (see module doc).

    ``region`` threads the scenario's :class:`~repro_torch.region.RegionConfig`
    (or None) to the policies that honor side-constraints — the engines
    pass ``scenario.region`` so region-aware specs need no extra wiring."""
    if spec == "kubepacs":
        return KubePACSPolicy(tolerance=tolerance, ttl_hours=ttl_hours,
                              clock=clock)
    if spec == "kubepacs_unguarded":
        return KubePACSPolicy(tolerance=tolerance, ttl_hours=ttl_hours,
                              guarded=False, clock=clock)
    if spec == "kubepacs_risk" or spec.startswith("kubepacs_risk:"):
        horizon = (float(spec.split(":", 1)[1])
                   if ":" in spec else DEFAULT_RISK_HORIZON)
        return KubePACSRiskPolicy(horizon=horizon, tolerance=tolerance,
                                  ttl_hours=ttl_hours, clock=clock)
    if spec == "serving_slo" or spec.startswith("serving_slo:"):
        risk_horizon = float(spec.split(":", 1)[1]) if ":" in spec else 0.0
        return ServingSLOPolicy(risk_horizon=risk_horizon,
                                tolerance=tolerance, ttl_hours=ttl_hours,
                                clock=clock)
    if spec == "hardened":
        # lazy: repro_torch.chaos.guard imports this module (the Policy base)
        from ..chaos.guard import HardenedPolicy
        return HardenedPolicy(tolerance=tolerance, ttl_hours=ttl_hours,
                              clock=clock, region=region)
    if spec == "kubepacs_region":
        # lazy: repro_torch.region.policy imports this module (the base classes)
        from ..region.policy import RegionAwarePolicy
        return RegionAwarePolicy(region, tolerance=tolerance,
                                 ttl_hours=ttl_hours, clock=clock)
    if spec == "region_pinned" or spec.startswith("region_pinned:"):
        pin = spec.split(":", 1)[1] if ":" in spec else ""
        if not pin:
            if region is None or not region.regions:
                raise ValueError("region_pinned needs ':REGION' or a "
                                 "scenario RegionConfig to pick the home")
            pin = region.home
        from ..region.policy import RegionPinnedPolicy
        return RegionPinnedPolicy(pin, tolerance=tolerance,
                                  ttl_hours=ttl_hours, clock=clock)
    if spec == "karpenter_like":
        return KarpenterLikePolicy(ttl_hours=ttl_hours, clock=clock)
    if spec.startswith("fixed_alpha:"):
        return FixedAlphaPolicy(float(spec.split(":", 1)[1]),
                                ttl_hours=ttl_hours, clock=clock)
    raise ValueError(f"unknown policy spec {spec!r}")
