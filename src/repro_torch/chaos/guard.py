"""Degraded-mode provisioning: the hardened control plane (DESIGN.md §16).

:class:`HardenedPolicy` wraps the paper's :class:`KubePACSProvisioner`
with the reliability machinery a real control plane needs when its own
inputs fail — and is **inert when healthy**: with no
:class:`~repro_torch.chaos.faults.ChaosController` bound (or no fault touching
the current decision), ``provision``/``on_interrupts`` literally delegate
to the contained provisioner, so decisions are bit-identical to the
``kubepacs`` policy by construction, not by tolerance.

Under a fault, a decision descends a ladder until something valid comes
out:

1. **Quarantine** — rows whose observed ``spot``/``t3`` fail sanity bands
   (NaN/non-finite, below ``floor_od_factor × od`` or above
   ``spike_od_factor × od``, T3 out of the market's [1, 50] band) are ORed
   into the §4.1 exclusion mask.  Detection-based: the guard never peeks
   at which rows the fault actually hit.
2. **Staleness penalty** — a frozen feed of age ``a`` hours still solves,
   but with Perf discounted by ``1 / (1 + λ·a)`` through the O(n)
   ``reweight_items``/``reweight_market`` path (the same entry point as
   the risk objective), and the solved pool mapped back onto real items.
   Beyond ``max_stale_hours`` the guard refuses to solve on the zombie
   snapshot at all and falls through to the memo rung.
3. **Solver rungs** — one bounded-retry loop per ladder backend spec
   (default ``("default", "numpy")``, where ``"default"`` is the process
   backend, the card's ``"torch"`` unless ``KUBEPACS_SOLVER_BACKEND`` says
   otherwise; a fused deployment would run ``("torch:fused", "torch",
   "numpy")``, and a ``jax*`` spec raises from ``make_backend`` the first
   time its rung is tried — all rungs produce bit-identical
   selections per the DESIGN §12 backend contract, which is what makes
   descending *safe*).  Retries wait out a deterministic decorrelated-
   jitter backoff schedule (:func:`backoff_schedule`) whose delays are
   charged against the decision deadline in *simulated* seconds — the
   guard never sleeps, and the schedule is a pure function of
   ``(seed, decision time, attempt)``.
4. **Memo rung** — the last good solved pool for this exact request shape
   (the fleet's ``DecisionMemo`` idea turned into a per-policy last-good
   store), re-scored against the current demand.
5. **Safe rung** — a solver-free, availability-first minimum-viable pool:
   greedy over sanitized rows by (interruption_freq, od-price per pod),
   the "just keep the lights on" answer when nothing else worked.

Every decision — healthy or degraded — passes the invariant monitor
(:func:`check_decision`): counts within T3 bounds, finite spot prices,
hourly cost sane relative to the on-demand bill.  A monitor reject
descends the ladder like a solve failure.  Per-rung counters surface
through ``SimResult.cache_stats`` (``chaos_*`` keys).
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.backend import SolverBackend, make_backend
from ..core.efficiency import (NodePool, Request, decision_metrics,
                               pool_metric_arrays, reweight_items)
from ..core.gss import bracketed_gss
from ..core.ilp import reweight_market
from ..core.provisioner import (KubePACSProvisioner, ProvisioningDecision,
                                exclusion_mask)
from ..region.config import RegionConfig
from ..region.solver import solve_with_regions
from ..sim.policy import Policy
from .faults import ChaosController

#: default degradation ladder: the ambient backend, then the host engine.
#: "default" = inherit the process backend (None); every other entry is a
#: ``make_backend`` spec.
DEFAULT_LADDER = ("default", "numpy")


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Hardening knobs (all deterministic; see module doc)."""

    attempts_per_rung: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0
    backoff_seed: int = 0
    #: simulated wall-seconds a decision may spend on solver attempts +
    #: backoff waits before dropping to the memo/safe rungs
    deadline_s: float = 4.0
    #: beyond this snapshot age (hours) the guard stops solving on the
    #: stale feed entirely (the penalty rung covers 0 < age ≤ max)
    max_stale_hours: float = 4.0
    #: λ of the staleness discount 1 / (1 + λ·age_hours)
    stale_penalty_per_hour: float = 0.1
    #: spot sanity band relative to od_price (the market clips real spot
    #: into [0.03·od, 1.0·od]; DESIGN §16 quarantine detection bands sit
    #: just outside it)
    floor_od_factor: float = 0.02
    spike_od_factor: float = 1.05
    #: a fulfillment round granting less than this fraction of an
    #: offering's requested nodes TTL-excludes the offering (ICE response)
    ice_exclude_below: float = 0.5
    #: ceiling on the 1/grant-ratio over-request factor the guard applies
    #: while fulfillment rounds come back *uniformly* short (market-wide
    #: ICE: diversifying away is pure loss, so compensate instead)
    ice_inflate_cap: float = 4.0
    #: learned quarantine band (§10 → §16): rows whose *online-estimated*
    #: interrupt hazard λ_i (interrupts per node-hour, from the risk
    #: subsystem's estimators) exceeds this rate are quarantined like a
    #: failed sanity band.  0.0 = off — no estimators are constructed and
    #: the guard is bit-identical to the fixed-bands-only build.
    hazard_quarantine_rate: float = 0.0


def backoff_schedule(seed: int, now: float, attempts: int,
                     base_s: float = 0.05, cap_s: float = 1.0,
                     ) -> Tuple[float, ...]:
    """Decorrelated-jitter backoff delays for one decision's retry loop.

    ``delays[0]`` is 0 (the first attempt fires immediately);
    ``delays[k] = min(cap, U(base, 3·delays[k-1]))`` with each draw from a
    fresh generator keyed on ``(seed, decision-time, k)`` — a pure
    function of its arguments, so the schedule is identical across
    engines and replay (determinism contract, DESIGN §9/§16)."""
    delays = [0.0]
    prev = base_s
    for k in range(1, max(int(attempts), 1)):
        rng = np.random.default_rng((int(seed) & 0xFFFFFFFF,
                                     int(round(now * 3600.0)), k))
        d = min(cap_s, float(rng.uniform(base_s, 3.0 * prev)))
        delays.append(d)
        prev = d
    return tuple(delays[:max(int(attempts), 1)])


def quarantine_mask(items: Sequence, config: GuardConfig,
                    hazard: Optional[np.ndarray] = None,
                    ) -> Optional[np.ndarray]:
    """Detection-based row quarantine: True where an item's *observed*
    market fields fail the sanity bands.  Returns None when every row is
    sane (so the exclusion path stays byte-identical to the unguarded
    one on clean feeds).

    ``hazard`` optionally carries the §10 estimators' per-item interrupt
    hazard rate; with ``config.hazard_quarantine_rate > 0`` rows whose
    estimated λ exceeds the rate join the quarantine — the learned band
    the fixed thresholds cannot express.  Absent/off, the mask is exactly
    the fixed-bands mask."""
    flags = np.zeros(len(items), dtype=bool)
    for i, it in enumerate(items):
        od = it.offering.od_price
        sp = it.spot_price
        flags[i] = (not math.isfinite(sp)
                    or sp <= config.floor_od_factor * od
                    or sp > config.spike_od_factor * od
                    or not (0 < it.t3 <= 50))
    if hazard is not None and config.hazard_quarantine_rate > 0.0:
        flags |= np.asarray(hazard, dtype=np.float64) \
            > config.hazard_quarantine_rate
    return flags if flags.any() else None


def check_decision(pool: Optional[NodePool], request: Request,
                   config: GuardConfig) -> bool:
    """The invariant monitor: feasibility/budget sanity of one decision.

    Checks (all cheap, all deterministic): non-negative counts within each
    item's T3 bound, finite positive spot prices, finite non-negative
    hourly cost, and cost no higher than the equivalent on-demand bill
    (spot is clipped at od by the market; paying above it means the
    decision trusted a spiked row)."""
    if pool is None:
        return False
    od_cost = 0.0
    for it, c in zip(pool.items, pool.counts):
        if c < 0 or c > it.t3:
            return False
        if not math.isfinite(it.spot_price) or it.spot_price <= 0:
            return False
        od_cost += it.offering.od_price * c
    cost = pool.hourly_cost
    if not math.isfinite(cost) or cost < 0:
        return False
    return cost <= config.spike_od_factor * od_cost + 1e-9


def safe_pool(items: Sequence, exclude: Optional[np.ndarray],
              request: Request) -> NodePool:
    """The ladder's bottom solver-free rung: a minimum-viable pool that
    greedily covers the demand from sanitized rows, most-reliable first
    (interruption_freq, then od-price per pod — od because observed spot
    is exactly what can no longer be trusted down here)."""
    order = sorted(
        range(len(items)),
        key=lambda i: (items[i].offering.interruption_freq,
                       items[i].offering.od_price / items[i].pods,
                       items[i].offering.offering_id))
    chosen, counts = [], []
    remaining = int(request.pods)
    for i in order:
        if remaining <= 0:
            break
        if exclude is not None and exclude[i]:
            continue
        it = items[i]
        if not math.isfinite(it.spot_price) or it.spot_price <= 0 \
                or it.t3 <= 0:
            continue
        take = min(int(it.t3), math.ceil(remaining / it.pods))
        if take <= 0:
            continue
        chosen.append(it)
        counts.append(take)
        remaining -= take * it.pods
    return NodePool(items=chosen, counts=counts, alpha=None,
                    request=request)


def decision_available(decision: Optional[ProvisioningDecision]) -> bool:
    """Did this decision cycle produce usable capacity?  (The bench's
    decision-availability numerator: failed/blocked cycles and empty
    pools count as unavailable.)"""
    if decision is None or not isinstance(decision, ProvisioningDecision):
        return False
    if decision.metrics.get("decision_failed"):
        return False
    return decision.pool.total_pods > 0


class HardenedPolicy(Policy):
    """The ``hardened`` policy spec: KubePACS + the degradation ladder.

    ``chaos_hardened`` marks the policy to the engine: under an active
    solver fault the engine fails *unhardened* policies' decision cycles
    outright, while hardened policies get called and handle the fault
    through the retry/ladder machinery themselves.
    """

    name = "hardened"
    chaos_hardened = True

    #: the solver-rung count is ``len(ladder)``; metrics' ``chaos_rung``
    #: uses indices 0..L-1 for solver rungs, L for memo, L+1 for safe
    def __init__(self, tolerance: float = 0.01, ttl_hours: float = 2.0,
                 clock: Callable[[], float] = time.perf_counter,
                 config: Optional[GuardConfig] = None,
                 ladder: Sequence[str] = DEFAULT_LADDER,
                 region: Optional[RegionConfig] = None) -> None:
        self.provisioner = KubePACSProvisioner(tolerance=tolerance,
                                               ttl_hours=ttl_hours,
                                               timer=clock)
        self.config = config or GuardConfig()
        self.ladder = tuple(ladder)
        #: scenario RegionConfig (None outside a regional scenario); the
        #: §17 failover rung prices egress / honors caps through it
        self.region = region
        #: §10 estimators for the learned quarantine band — constructed in
        #: :meth:`bind` only when ``hazard_quarantine_rate`` is enabled
        self.estimators = None
        self.chaos: Optional[ChaosController] = None
        self._backends: Dict[str, Optional[SolverBackend]] = {}
        # last-good solved pools keyed by exact request shape (pods
        # included: a pool sized for 100 pods cannot serve 300)
        self._last_good: Dict[Tuple, Tuple[NodePool, Optional[float]]] = {}
        self._lg_digest = ""
        # observed grant ratio of the latest uniformly-short fulfillment
        # round (1.0 = market granting in full; see observe_fulfillment)
        self._grant_ratio = 1.0
        self.counters: Dict[str, int] = {}

    # -- protocol hooks ------------------------------------------------------
    def bind(self, catalog) -> None:
        if self.config.hazard_quarantine_rate > 0.0:
            from ..risk.estimators import RiskEstimators
            self.estimators = RiskEstimators(catalog)

    def bind_chaos(self, chaos: Optional[ChaosController]) -> None:
        self.chaos = chaos

    def observe_market(self, time, spot, t3):
        if self.estimators is not None:
            self.estimators.on_market_state(time, spot, t3)

    def observe_interrupts(self, time, dt, pool, notices):
        if self.estimators is not None:
            self.estimators.on_interrupts(time, dt, pool, notices)

    def set_decision_memo(self, memo):
        self.decision_memo = memo
        self.provisioner.decision_memo = memo

    def set_solve_batch(self, batch):
        """Deliberately a no-op: the guard solves inline so every attempt
        is individually retryable/deadline-checkable.  Correct under the
        batching contract (batching changes execution, never content)."""

    def memo_digest(self) -> Optional[str]:
        # without chaos the guard is stateless beyond the TTL cache the
        # memo key already covers (inert-path parity with "kubepacs");
        # with chaos, degraded decisions additionally depend on the
        # last-good store, which this digest pins conservatively (equal
        # histories ⇒ equal digests; a differing history never shares)
        if self.chaos is None and self.estimators is None:
            return None
        lg = f"guard:{self._lg_digest}"
        if self.estimators is not None:
            # learned quarantine band: decisions depend on estimator state
            lg += f":{self.estimators.digest()}"
        return lg

    def chaos_stats(self) -> Dict[str, int]:
        """Per-rung/diagnostic counters (``cache_stats``' ``chaos_*``)."""
        return dict(self.counters)

    def _count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _backend(self, spec: str) -> Optional[SolverBackend]:
        if spec not in self._backends:
            self._backends[spec] = (None if spec == "default"
                                    else make_backend(spec))
        return self._backends[spec]

    # -- last-good store -----------------------------------------------------
    @staticmethod
    def _shape_key(request: Request) -> Tuple:
        return (request.pods, request.cpu_per_pod, request.mem_per_pod,
                request.workload)

    def _lookup_last_good(self, request: Request
                          ) -> Optional[Tuple[NodePool, Optional[float]]]:
        """Exact shape first; otherwise the smallest remembered pool of
        the same (cpu, mem, workload) that covers at least the requested
        pods, trimmed down to the shortfall keeping the cheapest pods.
        Shortfall re-provisions carry pod counts the exact-match store
        has never seen, and dropping those to the safe rung buys the
        most expensive (availability-first) pods in the catalog."""
        shape = self._shape_key(request)
        hit = self._last_good.get(shape)
        if hit is not None:
            return hit
        best = None
        for key, val in self._last_good.items():
            if key[1:] == shape[1:] and key[0] >= request.pods \
                    and (best is None or key[0] < best[0]):
                best = (key[0], val)
        if best is None:
            return None
        pool, alpha = best[1]
        order = sorted(range(len(pool.items)),
                       key=lambda i: (pool.items[i].spot_price
                                      / pool.items[i].pods,
                                      pool.items[i].offering.offering_id))
        remaining = request.pods
        items, counts = [], []
        for i in order:
            if remaining <= 0:
                break
            it = pool.items[i]
            take = min(int(pool.counts[i]), math.ceil(remaining / it.pods))
            if take <= 0:
                continue
            items.append(it)
            counts.append(take)
            remaining -= take * it.pods
        if not items:
            return None
        self._count("memo_trimmed")
        return (NodePool(items=items, counts=counts, alpha=alpha,
                         request=request), alpha)

    def _remember(self, request: Request,
                  decision: ProvisioningDecision) -> None:
        if not isinstance(decision, ProvisioningDecision):
            return                      # PendingDecision (batched healthy)
        if decision.pool.total_pods <= 0:
            return
        self._last_good[self._shape_key(request)] = (decision.pool,
                                                     decision.alpha)
        h = hashlib.blake2s(digest_size=8)
        h.update(self._lg_digest.encode())
        h.update(repr((self._shape_key(request),
                       sorted(decision.pool.as_dict().items()),
                       decision.alpha)).encode())
        self._lg_digest = h.hexdigest()

    # -- the policy interface ------------------------------------------------
    def provision(self, request, snapshot, now, precompiled=None):
        self.provisioner.clock = now
        chaos = self.chaos
        if chaos is None:
            return self.provisioner.provision(request, snapshot,
                                              precompiled)
        if chaos.has_region_faults:
            # §17 failover rung — sits above the ladder; bit-inert unless
            # the scenario actually declares region-kind faults
            qregions = chaos.region_fault_regions(now)
            if qregions:
                d = self._region_failover(request, snapshot, now,
                                          precompiled, qregions)
                if d is not None:
                    self._remember(request, d)
                    return self._inflate(request, d)
        healthy = (not chaos.snapshot_tainted
                   and chaos.solver_faulted(now) is None)
        if healthy:
            d = self.provisioner.provision(request, snapshot, precompiled)
            if not isinstance(d, ProvisioningDecision) \
                    or check_decision(d.pool, request, self.config):
                self._count("healthy")
                self._remember(request, d)
                return self._inflate(request, d)
            self._count("monitor_rejects")      # pragma: no cover
        return self._inflate(request, self._degraded(request, snapshot,
                                                     now, precompiled))

    def on_interrupts(self, notices, request, snapshot, surviving_pods,
                      now, precompiled=None):
        self.provisioner.clock = now
        if self.chaos is None:
            self.provisioner.enqueue([n.to_core() for n in notices])
            return self.provisioner.handle_interrupts(
                request, snapshot, surviving_pods=surviving_pods,
                precompiled=precompiled)
        if not notices:
            return None
        for n in notices:
            self.provisioner.cache.add(n.offering_id, now)
        shortfall = max(0, request.pods - surviving_pods)
        if shortfall == 0:
            return None
        repl = dataclasses.replace(request, pods=shortfall)
        return self.provision(repl, snapshot, now, precompiled)

    def observe_fulfillment(self, time, requested, grants):
        """ICE response, split by shortfall shape.

        *Offering-specific* (some offerings granted in full, others far
        short): the short offerings join the §4.1 TTL exclusion cache —
        the SpotKube-style diversification answer to capacity errors.

        *Market-wide* (every requested offering short, or uniformly
        partial): diversifying away from everything is pure loss, so the
        guard instead records the observed grant ratio and subsequent
        decisions over-request by ``1/ratio`` (T3-clipped, capped at
        ``ice_inflate_cap``; see :meth:`_inflate`) until a round is
        granted in full again.  Over-requesting under a cap is free:
        grants — and therefore billing — never exceed what the market
        actually yields."""
        if self.estimators is not None:
            self.estimators.on_fulfillment(time, requested, grants)
        if self.chaos is None:
            return
        cfg = self.config
        pos = {oid: c for oid, c in requested.items() if c > 0}
        if not pos:
            return
        short = [oid for oid, c in pos.items()
                 if grants.get(oid, 0) < cfg.ice_exclude_below * c]
        if short and len(short) < len(pos):
            self._grant_ratio = 1.0
            for oid in short:
                self.provisioner.cache.add(oid, time)
                self._count("ice_excluded")
            return
        got = sum(grants.get(oid, 0) for oid in pos)
        ratio = got / sum(pos.values())
        if ratio >= 1.0:
            self._grant_ratio = 1.0
        else:
            self._grant_ratio = max(ratio, 1.0 / cfg.ice_inflate_cap)
            self._count("ice_market_wide")

    def _inflate(self, request, decision):
        """Market-wide ICE compensation: while fulfillment rounds come
        back uniformly short, scale each item's requested count by the
        observed grant ratio (clipped to its T3 bound) so the post-cap
        grants land near the solved pool instead of ``ratio ×`` it."""
        if self._grant_ratio >= 1.0 \
                or not isinstance(decision, ProvisioningDecision) \
                or decision.pool.total_pods <= 0:
            return decision
        pool = decision.pool
        counts = [min(int(it.t3), math.ceil(c / self._grant_ratio))
                  if c > 0 else int(c)
                  for it, c in zip(pool.items, pool.counts)]
        if counts == [int(c) for c in pool.counts]:
            return decision
        self._count("ice_inflated")
        new_pool = NodePool(items=list(pool.items), counts=counts,
                            alpha=pool.alpha, request=pool.request)
        metrics = decision_metrics(new_pool, request.pods)
        metrics.update({k: v for k, v in decision.metrics.items()
                        if k.startswith("chaos_")})
        metrics["chaos_ice_inflate"] = round(1.0 / self._grant_ratio, 4)
        return dataclasses.replace(decision, pool=new_pool,
                                   metrics=metrics)

    # -- the §17 region failover rung ----------------------------------------
    def _hazard_rows(self, items) -> Optional[np.ndarray]:
        """Per-item estimated hazard for the learned quarantine band, or
        None when the band is off (the default — bit-inert)."""
        est = self.estimators
        if est is None or self.config.hazard_quarantine_rate <= 0.0:
            return None
        lam = est.hazard()
        return lam[est.gather([it.offering.offering_id for it in items])]

    def _region_failover(self, request, snapshot, now, precompiled,
                         qregions) -> Optional[ProvisioningDecision]:
        """Quarantine every row of the actively-faulted regions and
        re-solve the full demand into the survivors with the scenario
        RegionConfig's side-constraints (egress priced into the objective,
        caps, minimum spread).  Detection is declaration-based but
        row-blind: the guard reads *which regions* are under an active
        fault window from the controller — the operator signal a real
        control plane gets from health probes — never which rows the
        fault actually corrupted.  Returns None when the survivors cannot
        cover demand (or the monitor rejects), and the decision falls
        through to the healthy/degraded paths."""
        prov = self.provisioner
        cfg = self.config
        t0 = prov.timer()
        excluded = prov.cache.excluded(now)
        items, market = prov._compiled(request, snapshot, precompiled)
        qset = set(qregions)
        rmask = np.array([getattr(it.offering, "region", "") in qset
                          for it in items], dtype=bool)
        # rmask may be empty — e.g. an outage already blanked the region's
        # rows out of the frozen observed feed.  The quarantine is vacuous
        # then, but the side-constrained re-solve below is still the §17
        # response: min-spread/caps/egress matter *most* mid-outage, and
        # the plain degraded ladder applies none of them
        if rmask.any():
            self._count("region_quarantined_rows", int(rmask.sum()))
        qmask = quarantine_mask(items, cfg, hazard=self._hazard_rows(items))
        extra = rmask if qmask is None else (rmask | qmask)
        exclude = exclusion_mask(items, excluded, extra=extra)
        if exclude is not None and bool(exclude.all()):
            return None     # no survivors — let the ladder cope
        rcfg = self.region if self.region is not None else RegionConfig()
        pool, trace, info = solve_with_regions(
            items, request.pods, rcfg, market=market,
            tolerance=prov.tolerance, exclude=exclude, timer=prov.timer,
            coarsening=prov.coarsening)
        if pool is None or not check_decision(pool, request, cfg):
            self._count("region_failover_failed")
            return None
        self._count("region_failover")
        if info["egress_reweighted"]:
            self._count("region_egress_solves")
        if info["cap_repairs"]:
            self._count("region_cap_repairs", info["cap_repairs"])
        if info["spread_forced"]:
            self._count("region_spread_forced", info["spread_forced"])
        metrics = decision_metrics(pool, request.pods)
        metrics["chaos_rung"] = -1.0    # above solver rung 0
        metrics["chaos_region_failover"] = float(len(qregions))
        return ProvisioningDecision(
            pool=pool, trace=trace, alpha=pool.alpha,
            wall_seconds=prov.timer() - t0,
            excluded_offerings=excluded, metrics=metrics)

    # -- the degraded path ---------------------------------------------------
    def _degraded(self, request, snapshot, now, precompiled):
        prov = self.provisioner
        cfg = self.config
        chaos = self.chaos
        timer = prov.timer
        t0 = timer()
        excluded = prov.cache.excluded(now)
        memo = self.decision_memo
        mkey = memo.key(request, excluded) if memo is not None else None
        if mkey is not None:
            hit = memo.fetch(mkey, timer() - t0)
            if hit is not None:
                return hit
        items, market = prov._compiled(request, snapshot, precompiled)
        qmask = quarantine_mask(items, cfg, hazard=self._hazard_rows(items))
        nq = int(qmask.sum()) if qmask is not None else 0
        if nq:
            self._count("quarantined_rows", nq)
        exclude = exclusion_mask(items, excluded, extra=qmask)
        age = chaos.stale_age

        decision = None
        total_attempts = cfg.attempts_per_rung * len(self.ladder)
        schedule = backoff_schedule(cfg.backoff_seed, now, total_attempts,
                                    cfg.backoff_base_s, cfg.backoff_cap_s)
        budget = cfg.deadline_s
        attempt = 0
        if age > cfg.max_stale_hours:
            self._count("stale_beyond_ttl")
        else:
            # staleness penalty through the O(n) reweighting path
            items_s, market_s = items, market
            if age > 0.0:
                perf, price, _ = pool_metric_arrays(items)
                pen = 1.0 / (1.0 + cfg.stale_penalty_per_hour * age)
                items_s = reweight_items(items, perf * pen, price)
                market_s = reweight_market(market, perf * pen, price,
                                           items=items_s)
            infeasible = False
            for ri, rung in enumerate(self.ladder):
                solved = None
                for _ in range(cfg.attempts_per_rung):
                    if attempt > 0:   # simulated backoff wait (no sleep)
                        budget -= schedule[min(attempt,
                                               len(schedule) - 1)]
                    if budget <= 0.0:
                        self._count("deadline_exhausted")
                        break
                    outcome = chaos.attempt_outcome(now, attempt)
                    attempt += 1
                    if outcome == "error":
                        self._count("solve_errors")
                        continue
                    if outcome == "overrun":
                        budget -= chaos.attempt_cost_s(now)
                        self._count("solve_overruns")
                        continue
                    solved = bracketed_gss(
                        items_s, request.pods, tolerance=prov.tolerance,
                        market=market_s, exclude=exclude, timer=timer,
                        backend=self._backend(rung),
                        coarsening=prov.coarsening)
                    break
                if solved is not None:
                    pool, trace = solved
                    if pool is None:
                        # genuinely infeasible on sanitized inputs — the
                        # backend contract makes every rung agree, so go
                        # straight to the memo rung
                        self._count("infeasible_solves")
                        infeasible = True
                        break
                    if age > 0.0:
                        # map penalized counts back onto real items so
                        # cost accrual uses observed market numbers
                        real = {it.offering.offering_id: it
                                for it in items}
                        pool = NodePool(
                            items=[real[it.offering.offering_id]
                                   for it in pool.items],
                            counts=list(pool.counts), alpha=pool.alpha,
                            request=request)
                    if check_decision(pool, request, cfg):
                        self._count(f"solver_rung_{ri}")
                        decision = self._build(
                            request, excluded, pool, trace, pool.alpha,
                            t0, float(ri), age, nq, attempt, mkey)
                        self._remember(request, decision)
                        break
                    self._count("monitor_rejects")
                if infeasible or budget <= 0.0:
                    break

        if decision is None:
            lg = self._lookup_last_good(request)
            if lg is not None:
                pool, alpha = lg
                # shallow copy: never mutate a previously returned pool
                pool = NodePool(items=list(pool.items),
                                counts=list(pool.counts), alpha=alpha,
                                request=request)
                self._count("memo_rung")
                decision = self._build(request, excluded, pool, None,
                                       alpha, t0, float(len(self.ladder)),
                                       age, nq, attempt, mkey)
            else:
                pool = safe_pool(items, exclude, request)
                self._count("safe_rung" if pool.total_pods > 0
                            else "no_decision")
                decision = self._build(request, excluded, pool, None,
                                       None, t0,
                                       float(len(self.ladder) + 1),
                                       age, nq, attempt, mkey)
        return decision

    def _build(self, request, excluded, pool, trace, alpha, t0, rung,
               age, nq, attempts, mkey):
        metrics = decision_metrics(pool, request.pods)
        metrics["chaos_rung"] = rung
        metrics["chaos_attempts"] = float(attempts)
        if age > 0.0:
            metrics["chaos_stale_hours"] = age
        if nq:
            metrics["chaos_quarantined"] = float(nq)
        decision = ProvisioningDecision(
            pool=pool, trace=trace, alpha=alpha,
            wall_seconds=self.provisioner.timer() - t0,
            excluded_offerings=excluded, metrics=metrics)
        if mkey is not None:
            self.decision_memo.store(mkey, decision)
        return decision


__all__ = ["DEFAULT_LADDER", "GuardConfig", "HardenedPolicy",
           "backoff_schedule", "check_decision", "decision_available",
           "quarantine_mask", "safe_pool"]
