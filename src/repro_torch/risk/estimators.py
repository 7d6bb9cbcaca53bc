"""Vectorized online estimators over the offering catalog (DESIGN.md §10).

Three signals, each one flat numpy vector indexed by catalog position and
updated from the scenario engine's event stream (live run, trace replay, or
the offline :mod:`repro_torch.risk.backtest` record walker — all three feed the
identical observation sequence, which is what makes risk-aware decisions
replayable):

* **spot-price drift** — EWMA of the per-hour relative price change of each
  offering, time-decayed with constant ``tau_price`` hours:
  ``d_i ← β·d_i + (1−β)·(p_t/p_{t−Δ} − 1)/Δ`` with ``β = exp(−Δ/τ_p)``.
* **interrupt hazard** — per-offering exponential hazard rate λ_i (events
  per node-hour), the ratio of two exponentially-forgotten accumulators:
  discounted interrupt counts over discounted node-hours of exposure.  The
  prior is the SpotLake pressure law at zero pressure
  (``0.01 + 0.015·IF_i`` per hour, see
  :func:`repro_torch.core.market.pressure_interrupt_probability`) carried by
  ``prior_exposure_hours`` pseudo node-hours, so a cold-start estimator
  reproduces the static IF-band signal and observed interrupts sharpen it
  per offering.
* **fulfillment shortfall** — exponentially-forgotten requested/granted
  node counts from fulfillment grants; ``shortfall_i = 1 − granted/requested``.

Determinism contract: estimator state is a pure function of the observed
event sequence — no RNG, no wall clock.  Updating from a live run and from
replaying its trace yields bit-identical state because trace floats
round-trip exactly (DESIGN.md §9) and numpy arithmetic is deterministic.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.market import Offering

#: hazard prior at zero pool pressure — the pressure law's intercept + IF term
_HAZARD_BASE = 0.01
_HAZARD_PER_IF = 0.015


@dataclasses.dataclass(frozen=True)
class RiskParams:
    """Tuning constants of the estimators and the E_risk objective.

    All defaults are deliberately mild: the subsystem should refine the
    static KubePACS inputs, not overwhelm them.
    """

    tau_price_hours: float = 12.0      # price/drift EWMA time constant
    tau_hazard_hours: float = 72.0     # hazard accumulator forgetting constant
    prior_exposure_hours: float = 8.0  # pseudo node-hours carrying the prior
    fulfillment_decay: float = 0.8     # per-event forgetting of grant counts
    prior_requests: float = 4.0        # pseudo requested=granted nodes
    drift_clip: float = 0.25           # |per-hour drift| cap in E_risk
    # node-hours of work one interruption destroys: half a market step of
    # expected mid-interval downtime (the engine's delivered-work accounting
    # at the default 6 h step) plus recovery/restart overhead
    reprovision_hours: float = 3.25


class RiskEstimators:
    """Online (drift, hazard, shortfall) state over one offering catalog."""

    def __init__(self, catalog: Sequence[Offering],
                 params: Optional[RiskParams] = None):
        self.params = params or RiskParams()
        self.catalog = list(catalog)
        self.index: Dict[str, int] = {o.offering_id: i
                                      for i, o in enumerate(self.catalog)}
        n = len(self.catalog)
        p = self.params
        # price drift
        self._prev_spot = np.array([o.spot_price for o in self.catalog],
                                   dtype=np.float64)
        self._drift = np.zeros(n, dtype=np.float64)
        self._last_market_time: Optional[float] = None
        # hazard: exponentially-forgotten events over exposure, seeded with
        # the IF-band prior so hazard(0 data) == the static pressure law
        if_band = np.array([o.interruption_freq for o in self.catalog],
                           dtype=np.float64)
        self._hazard_prior = _HAZARD_BASE + _HAZARD_PER_IF * if_band
        self._exposure = np.full(n, p.prior_exposure_hours, dtype=np.float64)
        self._events = self._hazard_prior * self._exposure
        # fulfillment shortfall
        self._requested = np.full(n, p.prior_requests, dtype=np.float64)
        self._granted = np.full(n, p.prior_requests, dtype=np.float64)

    # -- observation hooks (the engine's observer protocol) -----------------
    def on_market_state(self, time: float, spot: np.ndarray,
                        t3: np.ndarray) -> None:
        """EWMA drift update from a live (spot, t3) refresh.

        A refresh at unchanged simulation time (the t=0 initial state, a
        same-instant shock) only re-anchors the price level: attributing an
        instantaneous jump to a *rate* would divide by Δt = 0.
        """
        del t3  # capacity enters via hazard exposure, not price drift
        spot = np.asarray(spot, dtype=np.float64)
        if self._last_market_time is not None:
            dt = time - self._last_market_time
            if dt > 0:
                with np.errstate(divide="ignore", invalid="ignore"):
                    rate = (spot / self._prev_spot - 1.0) / dt
                rate = np.where(np.isfinite(rate), rate, 0.0)
                beta = math.exp(-dt / self.params.tau_price_hours)
                self._drift = beta * self._drift + (1.0 - beta) * rate
        self._prev_spot = spot.copy()
        self._last_market_time = time

    def on_interrupts(self, time: float, dt: float, pool: Dict[str, int],
                      notices: Sequence) -> None:
        """Hazard update: decay, then add this tick's exposure and events.

        ``pool`` is the allocation that was exposed over the last ``dt``
        hours (pre-loss); ``notices`` are the sampled interrupt notices
        (advisory rebalance recommendations included — they are reclaims,
        just announced early).
        """
        del time
        if dt > 0:
            gamma = math.exp(-dt / self.params.tau_hazard_hours)
            self._exposure *= gamma
            self._events *= gamma
            # forgetting must not decay below the prior's evidence weight,
            # or a long calm run would drift hazard toward 0/0
            floor = self.params.prior_exposure_hours
            thin = self._exposure < floor
            if np.any(thin):
                self._events[thin] += self._hazard_prior[thin] * (
                    floor - self._exposure[thin])
                self._exposure[thin] = floor
            for oid, count in pool.items():
                i = self.index.get(oid)
                if i is not None and count > 0:
                    self._exposure[i] += count * dt
        for n in notices:
            i = self.index.get(n.offering_id)
            if i is not None:
                self._events[i] += n.count

    def on_fulfillment(self, time: float, requested: Dict[str, int],
                       grants: Dict[str, int]) -> None:
        """Shortfall update from one fulfillment round (requested vs granted)."""
        del time
        rho = self.params.fulfillment_decay
        for oid, req in requested.items():
            i = self.index.get(oid)
            if i is None or req <= 0:
                continue
            self._requested[i] = rho * self._requested[i] + req
            self._granted[i] = rho * self._granted[i] + min(
                req, grants.get(oid, 0))

    # -- estimates ----------------------------------------------------------
    def hazard(self) -> np.ndarray:
        """Per-offering exponential hazard rate λ_i (interrupts/node-hour)."""
        return self._events / self._exposure

    def drift(self) -> np.ndarray:
        """Per-offering EWMA relative price drift (1/hour)."""
        return self._drift.copy()

    def shortfall(self) -> np.ndarray:
        """Per-offering expected fulfillment shortfall fraction ∈ [0, 1)."""
        return np.clip(1.0 - self._granted / self._requested, 0.0, 1.0)

    def gather(self, offering_ids: Sequence[str]) -> np.ndarray:
        """Catalog indices for a list of offering_ids (e.g. candidate items)."""
        return np.array([self.index[oid] for oid in offering_ids],
                        dtype=np.int64)

    def digest(self) -> str:
        """Deterministic fingerprint of the full estimator state, used as
        the risk policy's contribution to the fleet decision-memo key
        (DESIGN.md §11): replicas with bit-identical estimator state (and
        identical market snapshot / request / excluded set) provably share
        one risk-adjusted solve.  Hashes the raw float64 buffers, so any
        single-bit state divergence changes the digest."""
        h = hashlib.blake2b(digest_size=16)
        for arr in (self._prev_spot, self._drift, self._exposure,
                    self._events, self._requested, self._granted):
            h.update(arr.tobytes())
        h.update(repr(self._last_market_time).encode())
        return h.hexdigest()

    # -- (de)serialization — deterministic state snapshots ------------------
    def state_dict(self) -> Dict:
        return {
            "prev_spot": self._prev_spot.tolist(),
            "drift": self._drift.tolist(),
            "exposure": self._exposure.tolist(),
            "events": self._events.tolist(),
            "requested": self._requested.tolist(),
            "granted": self._granted.tolist(),
            "last_market_time": self._last_market_time,
        }

    def load_state_dict(self, state: Dict) -> None:
        self._prev_spot = np.array(state["prev_spot"], dtype=np.float64)
        self._drift = np.array(state["drift"], dtype=np.float64)
        self._exposure = np.array(state["exposure"], dtype=np.float64)
        self._events = np.array(state["events"], dtype=np.float64)
        self._requested = np.array(state["requested"], dtype=np.float64)
        self._granted = np.array(state["granted"], dtype=np.float64)
        self._last_market_time = state["last_market_time"]


def replay_observations(estimators: RiskEstimators,
                        records: Sequence[Dict]) -> RiskEstimators:
    """Drive estimators from raw trace records (offline/backtest path).

    Feeds ``market_state`` and ``fulfillment`` records directly.  Hazard
    exposure needs the live pool, which raw records do not carry — use the
    engine replay with an observer (``repro_torch.risk.backtest``) when hazard
    learning matters; this walker is the light-weight path for price/
    fulfillment state.
    """
    for rec in records:
        if rec["type"] == "market_state":
            estimators.on_market_state(rec["time"],
                                       np.array(rec["spot"]),
                                       np.array(rec["t3"]))
        elif rec["type"] == "fulfillment":
            grants = rec["grants"]
            estimators.on_fulfillment(rec["time"], dict(grants), grants)
    return estimators
