"""Deterministic control-plane fault models (DESIGN.md §16).

The scenario engine's determinism contract (DESIGN.md §9) — same seed ⇒
byte-identical trace, replay RNG-free — must survive fault injection, so
every fault here is a *pure function* of scenario-declared parameters and
the refresh/decision coordinates at which it fires.  No fault consumes an
RNG stream: where a fault needs randomness (per-field drift, corrupted-row
choice), it builds a fresh ``np.random.default_rng`` keyed on
``(fault.seed, state_idx, fault_index)`` — the same stream-free idiom as
``Scenario.effective_pods`` — so the standalone engine, the fleet engine,
and trace replay all derive bit-identical fault effects from the same
coordinates.

Fault taxonomy (``Fault.kind``):

``feed_outage``
    The control plane's market feed freezes: the controller keeps seeing
    the last pre-fault ``(spot, t3)`` snapshot, optionally with per-field
    multiplicative drift of amplitude ``magnitude`` (stale caches decay).
    The *world* (interrupt hazards, billing) keeps moving — the engine
    splits the true snapshot from the observed one.
``corrupt_price``
    A ``rate`` fraction of matching rows reports ``spot × magnitude``
    (magnitude < 1 understates — the dangerous direction: the optimizer
    chases phantom bargains billed at true prices; > 1 spikes).
``corrupt_nan``
    A ``rate`` fraction of matching rows reports NaN spot — rows that must
    be quarantined, not solved over (NaN poisons every normalized
    objective coefficient downstream).
``ice``
    Insufficient-capacity errors at launch: each matching offering grants
    at most ``floor(requested × (1 − magnitude))`` nodes of any request
    (offering-level capacity caps; magnitude 1.0 = full rejection).
``solver_error``
    The first ``int(magnitude)`` solve attempts of any decision inside the
    window raise (injected backend exceptions).
``solver_deadline``
    Every solve attempt inside the window overruns by ``magnitude``
    *simulated* seconds, charged against the guard's decision deadline.
``region_brownout``
    A whole region degrades at once (DESIGN.md §17): the regional market
    overlay thins the region's TRUE T3 capacity by ``magnitude`` and
    spikes its spot prices, while launches into the region grant at most
    ``floor(requested × (1 − magnitude))`` nodes.  The feed stays
    truthful — policies *see* the brownout.  ``selector`` is the exact
    region name.
``region_outage``
    The region is gone: TRUE T3 drops to zero region-wide (the overlay's
    doing — candidates vanish from ``preprocess`` for every policy) and
    launches into the region grant nothing.
``region_partition``
    The control plane is partitioned *from* the region: the observed feed
    freezes at the last pre-window values for the region's rows (the
    snapshot is tainted) and launches grant zero, but the TRUE world keeps
    moving — the feed looks healthy while every launch fails, the trap the
    hardened policy's region rung exists for.

Fault windows are half-open ``[time, time + duration)`` and should be
aligned to scenario tick boundaries (the storm factories use multiples of
the step); windows covering t = 0 cannot freeze a feed that was never
fresh — the first refresh is always treated as fresh.

This module deliberately imports nothing from ``repro_torch.sim`` (the scenario
layer imports *us*); the controller reports fault activation transitions
as plain tuples and the engine wraps them in trace records.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_EPS = 1e-9

#: kinds that correlate failure across a whole region's offerings
#: (DESIGN.md §17); ``selector`` is the exact region name for these
REGION_KINDS = ("region_brownout", "region_outage", "region_partition")

FAULT_KINDS = ("feed_outage", "corrupt_price", "corrupt_nan", "ice",
               "solver_error", "solver_deadline") + REGION_KINDS

#: kinds that taint the controller's view of the market feed (the guard's
#: healthy-path test): everything except launch-time ICE and solver faults
FEED_KINDS = ("feed_outage", "corrupt_price", "corrupt_nan")
SOLVER_KINDS = ("solver_error", "solver_deadline")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declarative fault window (see module doc for kind semantics)."""

    kind: str
    time: float
    duration: float
    selector: str = ""        # substring match on offering_id ("" = all)
    magnitude: float = 1.0
    rate: float = 1.0         # fraction of matching rows hit per refresh
    seed: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {FAULT_KINDS})")
        if self.kind in REGION_KINDS and not self.selector:
            raise ValueError(f"{self.kind} faults need a region selector")
        # float-normalize so Scenario round-trips through JSON byte-exactly
        object.__setattr__(self, "time", float(self.time))
        object.__setattr__(self, "duration", float(self.duration))
        object.__setattr__(self, "magnitude", float(self.magnitude))
        object.__setattr__(self, "rate", float(self.rate))
        object.__setattr__(self, "seed", int(self.seed))
        object.__setattr__(self, "selector", str(self.selector))

    def active(self, time: float) -> bool:
        """Half-open activation window ``[time, time + duration)``."""
        return (self.time - _EPS) <= time < (self.time + self.duration
                                             - _EPS)


class ChaosController:
    """Deterministic fault oracle for one simulation run.

    One controller is built per run from ``scenario.faults`` and driven by
    the engine in exact refresh order — the identical call sequence in
    ``ClusterSim``, ``FleetSim``, and replay is what makes fault effects
    reproduce bit-exactly everywhere.  The controller is the *injection*
    side only; the hardened response lives in :mod:`repro_torch.chaos.guard`
    (which reads, never mutates, the controller).

    State: the last *fresh* ``(spot, t3)`` pair and its timestamp (for
    feed outages), and the previously-active fault set (for activation
    transition records).  No RNG stream is held.
    """

    def __init__(self, faults: Sequence[Fault],
                 catalog: Sequence) -> None:
        self.faults: Tuple[Fault, ...] = tuple(faults)
        ids = [o.offering_id for o in catalog]
        self._ids = ids
        # per-fault row selectors are static (the catalog is)
        self._sel: Dict[int, np.ndarray] = {
            i: np.array([f.selector in oid for oid in ids], dtype=bool)
            for i, f in enumerate(self.faults)
            if f.kind in ("corrupt_price", "corrupt_nan")}
        regions = [getattr(o, "region", "") for o in catalog]
        self._region_of: Dict[str, str] = dict(zip(ids, regions))
        # region faults match on the exact region tag, not the id substring
        self._rsel: Dict[int, np.ndarray] = {
            i: np.array([r == f.selector for r in regions], dtype=bool)
            for i, f in enumerate(self.faults)
            if f.kind in REGION_KINDS}
        #: any region-kind fault *declared* (not necessarily active) — the
        #: static gate that keeps the hardened policy's region rung
        #: bit-inert on scenarios without regional faults (DESIGN.md §17)
        self.has_region_faults = any(f.kind in REGION_KINDS
                                     for f in self.faults)
        self._last_spot: Optional[np.ndarray] = None
        self._last_t3: Optional[np.ndarray] = None
        self._last_fresh_time = 0.0
        self._active_prev: frozenset = frozenset()
        #: hours since the observed snapshot was last fresh (0 = fresh)
        self.stale_age = 0.0
        #: True when the *current* observed snapshot went through any
        #: feed-affecting fault window (outage or corruption) — the guard's
        #: "can I trust what I'm looking at" bit, exact w.r.t. the last
        #: ``observe`` call rather than re-derived from window arithmetic
        self.snapshot_tainted = False

    # -- feed path -----------------------------------------------------------
    def observe(self, state_idx: int, time: float, spot: np.ndarray,
                t3: np.ndarray,
                ) -> Tuple[np.ndarray, np.ndarray,
                           List[Tuple[str, str, int]]]:
        """One market refresh seen through the fault plane.

        Returns ``(spot_obs, t3_obs, transitions)`` — the controller-visible
        arrays (the true inputs are never mutated; unfaulted refreshes
        return them by reference) and the fault activation transitions
        ``(kind, phase, fault_index)`` that occurred at this refresh, in
        fault-declaration order, for the engine to trace.
        """
        transitions: List[Tuple[str, str, int]] = []
        act = frozenset(i for i, f in enumerate(self.faults)
                        if f.active(time))
        for i, f in enumerate(self.faults):
            if i in act and i not in self._active_prev:
                transitions.append((f.kind, "begin", i))
            elif i not in act and i in self._active_prev:
                transitions.append((f.kind, "end", i))
        self._active_prev = act

        # the pre-refresh last-fresh feed: region partitions freeze their
        # rows at these values for the whole window (a partition that opens
        # before the first refresh cannot freeze a never-seen feed)
        prev_spot, prev_t3 = self._last_spot, self._last_t3
        partitions = [(i, self.faults[i]) for i in sorted(act)
                      if self.faults[i].kind == "region_partition"]

        outages = [self.faults[i] for i in sorted(act)
                   if self.faults[i].kind == "feed_outage"]
        if outages and self._last_spot is not None:
            f = outages[0]
            spot_obs = self._last_spot.copy()
            t3_obs = self._last_t3.copy()
            if f.magnitude > 0.0:
                rng = np.random.default_rng((f.seed & 0xFFFFFFFF,
                                             int(state_idx), 0xFEED))
                drift = 1.0 + f.magnitude * (2.0 * rng.random(len(spot_obs))
                                             - 1.0)
                spot_obs = np.maximum(spot_obs * drift, 1e-12)
            self.stale_age = time - self._last_fresh_time
            tainted = True
        else:
            # fresh refresh (or an outage window starting before the first
            # refresh, which cannot freeze a never-seen feed)
            self._last_spot = np.array(spot, dtype=np.float64, copy=True)
            self._last_t3 = np.array(t3, copy=True)
            self._last_fresh_time = time
            self.stale_age = 0.0
            spot_obs, t3_obs = spot, t3
            tainted = False
            if partitions and prev_spot is not None:
                # partitioned rows never refresh: pin their last-fresh
                # values at the pre-window feed so the frozen view does
                # not silently advance during the window
                for i, _ in partitions:
                    mask = self._rsel[i]
                    self._last_spot[mask] = prev_spot[mask]
                    self._last_t3[mask] = prev_t3[mask]

        for i in sorted(act):
            f = self.faults[i]
            if f.kind not in ("corrupt_price", "corrupt_nan"):
                continue
            tainted = True
            rng = np.random.default_rng((f.seed & 0xFFFFFFFF,
                                         int(state_idx), i))
            pick = self._sel[i] & (rng.random(len(self._ids)) < f.rate)
            if not pick.any():
                continue
            if spot_obs is spot:        # copy-on-write: never mutate truth
                spot_obs = np.array(spot, dtype=np.float64, copy=True)
            if f.kind == "corrupt_price":
                spot_obs[pick] = spot_obs[pick] * f.magnitude
            else:
                spot_obs[pick] = np.nan
        if partitions and prev_spot is not None:
            for i, _ in partitions:
                mask = self._rsel[i]
                if not mask.any():
                    continue
                tainted = True
                if spot_obs is spot:    # copy-on-write, as above
                    spot_obs = np.array(spot, dtype=np.float64, copy=True)
                if t3_obs is t3:
                    t3_obs = np.array(t3, copy=True)
                spot_obs[mask] = self._last_spot[mask]
                t3_obs[mask] = self._last_t3[mask]
        self.snapshot_tainted = tainted
        return spot_obs, t3_obs, transitions

    # -- launch path ---------------------------------------------------------
    def ice_caps(self, time: float,
                 requested: Dict[str, int]) -> Optional[Dict[str, int]]:
        """Offering-level grant caps for a launch at ``time`` under active
        ICE faults, or None when no ICE window is active.  Caps are a pure
        function of the *requested* counts, so re-applying them to already
        clipped grants is the identity — which is what keeps replayed
        fulfillment records byte-identical.  Region faults correlate the
        launch failure across every offering of the selected region:
        brownouts thin grants by ``magnitude``, outages and partitions
        grant nothing."""
        active = [f for f in self.faults if f.active(time)
                  and f.kind in ("ice",) + REGION_KINDS]
        if not active:
            return None
        caps: Dict[str, int] = {}
        for oid, c in requested.items():
            cap = int(c)
            for f in active:
                if f.kind == "ice":
                    if f.selector in oid:
                        cap = min(cap,
                                  int(math.floor(c * (1.0 - f.magnitude))))
                elif self._region_of.get(oid, "") == f.selector:
                    if f.kind == "region_brownout":
                        cap = min(cap,
                                  int(math.floor(c * (1.0 - f.magnitude))))
                    else:            # outage / partition: region is dark
                        cap = 0
            caps[oid] = max(cap, 0)
        return caps

    # -- region path ---------------------------------------------------------
    def region_fault_regions(self, time: float) -> Tuple[str, ...]:
        """Regions under an *active* region-kind fault at ``time``, sorted —
        the quarantine set the hardened policy's region rung excludes and
        re-weights demand away from (DESIGN.md §17).  Reading the
        controller here is the same precedent as ``snapshot_tainted`` /
        ``solver_faulted``: the guard reads the injection oracle's state,
        never mutates it."""
        return tuple(sorted({f.selector for f in self.faults
                             if f.kind in REGION_KINDS and f.active(time)}))

    # -- solver path ---------------------------------------------------------
    def solver_faulted(self, time: float) -> Optional[Fault]:
        """The first active solver fault at ``time`` (declaration order)."""
        for f in self.faults:
            if f.kind in SOLVER_KINDS and f.active(time):
                return f
        return None

    def attempt_outcome(self, time: float, attempt_index: int) -> str:
        """What happens to solve attempt ``attempt_index`` (0-based, counted
        across the whole decision) at ``time``: ``"ok"``, ``"error"``
        (injected exception), or ``"overrun"`` (deadline blowout of
        :meth:`attempt_cost_s` simulated seconds)."""
        f = self.solver_faulted(time)
        if f is None:
            return "ok"
        if f.kind == "solver_error":
            return "error" if attempt_index < int(f.magnitude) else "ok"
        return "overrun"

    def attempt_cost_s(self, time: float) -> float:
        """Simulated seconds a solve attempt costs beyond the solve itself
        (non-zero only inside a ``solver_deadline`` window)."""
        f = self.solver_faulted(time)
        if f is not None and f.kind == "solver_deadline":
            return f.magnitude
        return 0.0


def fault_storm(name: str, scale: float = 1.0) -> Tuple[Fault, ...]:
    """Named fault-storm presets, laid out for a 48 h / 3 h-step horizon
    (``scale`` compresses or stretches every window; keep windows aligned
    to tick boundaries).  These are the storms ``bench_chaos`` sweeps and
    ``examples/run_scenario.py --faults`` exposes:

    * ``feed``     — understatement corruption, then a feed outage, then a
      NaN burst: the full price-feed failure surface.
    * ``ice``      — a long partial-fulfillment window.
    * ``solver``   — injected solve errors, then deadline overruns.
    * ``combined`` — all of the above (the acceptance-gate storm).
    """
    def s(t: float) -> float:
        return t * scale

    feed = (
        Fault(kind="corrupt_price", time=s(6.0), duration=s(9.0),
              magnitude=0.01, rate=0.5, seed=101),
        Fault(kind="feed_outage", time=s(18.0), duration=s(9.0),
              magnitude=0.02, seed=102),
        Fault(kind="corrupt_nan", time=s(30.0), duration=s(6.0),
              rate=0.4, seed=103),
    )
    ice = (
        Fault(kind="ice", time=s(9.0), duration=s(15.0), magnitude=0.7,
              seed=104),
    )
    solver = (
        Fault(kind="solver_error", time=s(36.0), duration=s(6.0),
              magnitude=3.0, seed=105),
        Fault(kind="solver_deadline", time=s(42.0), duration=s(3.0),
              magnitude=10.0, seed=106),
    )
    storms = {"feed": feed, "ice": ice, "solver": solver,
              "combined": feed + ice + solver}
    if name not in storms:
        raise ValueError(f"unknown fault storm {name!r} "
                         f"(expected one of {sorted(storms)})")
    return storms[name]


def region_storm(region: str, scale: float = 1.0) -> Tuple[Fault, ...]:
    """The correlated regional failure sequence ``bench_region`` sweeps,
    laid out for a 48 h / 3 h-step horizon like :func:`fault_storm`: the
    selected region browns out (thinned capacity, spiked prices, partial
    grants), then goes dark entirely, then partitions away from the
    control plane while its feed keeps showing the last pre-partition
    snapshot."""
    def s(t: float) -> float:
        return t * scale

    return (
        Fault(kind="region_brownout", time=s(6.0), duration=s(9.0),
              magnitude=0.6, selector=region, seed=107),
        Fault(kind="region_outage", time=s(18.0), duration=s(9.0),
              magnitude=1.0, selector=region, seed=108),
        Fault(kind="region_partition", time=s(33.0), duration=s(9.0),
              magnitude=1.0, selector=region, seed=109),
    )


__all__ = ["FAULT_KINDS", "FEED_KINDS", "REGION_KINDS", "SOLVER_KINDS",
           "ChaosController", "Fault", "fault_storm", "region_storm"]
