"""Pluggable interruption models behind one interface (DESIGN.md §9).

The paper samples interruptions from pool pressure + the SpotLake IF band;
real spot markets also interrupt when the spot price crosses a user bid
(classic EC2 spot semantics) and issue advance *rebalance recommendations*
before reclaiming capacity.  The scenario engine treats all three as
interchangeable :class:`InterruptModel` implementations so a scenario picks
its interruption physics by spec string:

    "none"                           no interruptions
    "pressure"                       the pressure/IF sampler (own RNG stream)
    "price_crossing:<bid_factor>"    fire iff live spot > bid_factor × spot₀
    "rebalance:<lead_hours>:<inner>" wrap <inner>, stamping a warning lead
                                     time; capacity is reclaimed lead_hours
                                     after the (advisory) notice

Models see the *live snapshot* (offerings carry current SP_i/T3_i) and the
current pool; they never touch the market's price RNG, so the market path
and the interruption stream are independently seeded and a recorded trace
replays without any RNG at all.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..core.market import (Offering, pressure_interrupt_probability,
                           pressure_interrupt_probability_batch)
from .events import InterruptNotice


class InterruptModel:
    """Interface: seeded reset + a pure-given-RNG-state sampling step."""

    spec: str = "none"

    def reset(self, catalog: Sequence[Offering], seed: int) -> None:
        """Bind the model to a scenario run (catalog at t=0, RNG seed)."""

    def set_hazard_scale(self, scale_by_id: Dict[str, float]) -> None:
        """Install per-offering regional hazard scales (DESIGN.md §17).

        Base models ignore the regime — only the pressure sampler's law is
        hazard-shaped; deterministic models (price crossing) are not."""

    def sample(self, offerings: Dict[str, Offering], pool: Dict[str, int],
               hours: float, now: float) -> List[InterruptNotice]:
        """Interrupt notices for ``pool`` over the last ``hours``.

        ``offerings`` maps offering_id → live Offering (current spot/t3).
        """
        raise NotImplementedError


class NullInterruptModel(InterruptModel):
    spec = "none"

    def sample(self, offerings, pool, hours, now):
        return []


class PressureInterruptModel(InterruptModel):
    """The paper's sampler: P(interrupt) rises with pool pressure and IF.

    Identical law to ``SpotMarketSimulator.interrupts_for_pool`` (shared
    via :func:`pressure_interrupt_probability`) but on a dedicated RNG
    stream keyed by the scenario's ``interrupt_seed``.

    The per-tick draw is one vectorized binomial over the pool's live
    entries (DESIGN.md §11): numpy's ``Generator.binomial`` fills array
    outputs by iterating the scalar sampler in C order against the same
    bit stream, so the batched call consumes the RNG byte-identically to
    the seed implementation's per-entry Python loop — same seed, same
    trace, one RNG call per tick.  :meth:`draw_lost_counts` exposes the
    batched draw to the fleet engine, which gathers the probabilities
    from a fleet-wide hazard matrix instead of recomputing them per
    replica.
    """

    spec = "pressure"

    def __init__(self) -> None:
        self._rng = np.random.default_rng(0)
        self._hazard_scale: Dict[str, float] = {}

    def reset(self, catalog, seed):
        self._rng = np.random.default_rng(seed)

    def set_hazard_scale(self, scale_by_id):
        self._hazard_scale = dict(scale_by_id)

    def draw_lost_counts(self, counts: np.ndarray,
                         probs: np.ndarray) -> np.ndarray:
        """One batched binomial draw on this model's stream — ``probs``
        must come from the shared pressure law (scalar or batch; the two
        are bitwise-identical) evaluated in pool-entry order."""
        if len(counts) == 0:
            return np.zeros(0, dtype=np.int64)
        return self._rng.binomial(counts, probs)

    def sample(self, offerings, pool, hours, now):
        entries = [(offering_id, count, offerings.get(offering_id))
                   for offering_id, count in pool.items()]
        entries = [(oid, c, o) for oid, c, o in entries
                   if o is not None and c > 0]
        if not entries:
            return []
        probs = pressure_interrupt_probability_batch(
            np.array([c for _, c, _ in entries], dtype=np.int64),
            np.array([float(o.t3) for _, _, o in entries]),
            np.array([o.interruption_freq for _, _, o in entries]),
            hours)
        if self._hazard_scale:
            from ..region.market import apply_hazard_scale
            probs = apply_hazard_scale(
                probs, np.array([self._hazard_scale.get(oid, 1.0)
                                 for oid, _, _ in entries], dtype=np.float64))
        lost = self.draw_lost_counts(
            np.array([c for _, c, _ in entries], dtype=np.int64), probs)
        return [InterruptNotice(time=now, offering_id=oid, count=int(k))
                for (oid, _, _), k in zip(entries, lost) if k > 0]


class PriceCrossingInterruptModel(InterruptModel):
    """EC2-classic bid semantics: all nodes of an offering are interrupted
    iff its live spot price exceeds the bid (bid_factor × the t=0 spot
    price).  Deterministic — no RNG."""

    def __init__(self, bid_factor: float = 1.25) -> None:
        self.bid_factor = float(bid_factor)
        self.spec = f"price_crossing:{bid_factor:g}"
        self._bids: Dict[str, float] = {}

    def reset(self, catalog, seed):
        self._bids = {o.offering_id: self.bid_factor * o.spot_price
                      for o in catalog}

    def crossed_ids(self, offerings: Dict[str, Offering]) -> set:
        """The offerings whose live spot strictly exceeds their bid — the
        single definition of the crossing rule, shared by :meth:`sample`
        and the fleet engine's one-mask-per-tick batched path."""
        crossed = set()
        for oid, o in offerings.items():
            bid = self._bids.get(oid)
            if bid is not None and o.spot_price > bid:
                crossed.add(oid)
        return crossed

    def sample(self, offerings, pool, hours, now):
        crossed = self.crossed_ids(offerings)
        return [InterruptNotice(time=now, offering_id=offering_id,
                                count=count, reason="price-crossing")
                for offering_id, count in pool.items()
                if count > 0 and offering_id in crossed]


class RebalanceRecommendationModel(InterruptModel):
    """Advance-warning wrapper: inner-model notices become advisory
    recommendations with a configurable lead time; the engine reclaims the
    capacity only once ``lead_hours`` have elapsed (effective_time)."""

    def __init__(self, inner: InterruptModel, lead_hours: float = 2.0) -> None:
        self.inner = inner
        self.lead_hours = float(lead_hours)
        self.spec = f"rebalance:{lead_hours:g}:{inner.spec}"

    def reset(self, catalog, seed):
        self.inner.reset(catalog, seed)

    def set_hazard_scale(self, scale_by_id):
        self.inner.set_hazard_scale(scale_by_id)

    def wrap(self, notices: Sequence[InterruptNotice],
             ) -> List[InterruptNotice]:
        """Stamp the advisory lead onto inner-model notices — the single
        definition of the wrapper semantics, shared by :meth:`sample` and
        the fleet engine (which draws the inner notices batched)."""
        return [InterruptNotice(time=n.time, offering_id=n.offering_id,
                                count=n.count,
                                reason=f"rebalance-recommendation:{n.reason}",
                                lead_hours=self.lead_hours)
                for n in notices]

    def sample(self, offerings, pool, hours, now):
        return self.wrap(self.inner.sample(offerings, pool, hours, now))


def make_interrupt_model(spec: str) -> InterruptModel:
    """Parse a scenario's interrupt-model spec string (see module doc)."""
    if spec == "none":
        return NullInterruptModel()
    if spec == "pressure":
        return PressureInterruptModel()
    if spec.startswith("price_crossing"):
        parts = spec.split(":")
        return PriceCrossingInterruptModel(
            float(parts[1]) if len(parts) > 1 else 1.25)
    if spec.startswith("rebalance:"):
        _, lead, inner = spec.split(":", 2)
        return RebalanceRecommendationModel(make_interrupt_model(inner),
                                            lead_hours=float(lead))
    raise ValueError(f"unknown interrupt-model spec {spec!r}")
