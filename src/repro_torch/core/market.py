"""Spot-market data model, synthetic SpotLake-like catalog, and market simulator.

The paper consumes the SpotLake archive (spot price, on-demand price, CoreMark
benchmark score, single-node SPS, multi-node SPS/T3, interruption frequency) for
731 instance types across 4 AWS regions.  Offline we reproduce the *structure*
and the paper's qualitative marginals (Fig. 1, Fig. 2, Fig. 9):

  * on-demand price correlates with hardware spec; spot price is decoupled,
  * newer generations deliver higher benchmark scores at similar spot prices,
  * network-/disk-specialized variants raise on-demand price, not CoreMark,
  * T3 (multi-node SPS capacity) shrinks with instance size and fluctuates,
  * single-node SPS is a poor predictor of multi-node fulfillment.

Everything here is plain Python/numpy: the control plane deliberately stays off
the device path (the paper runs inside the Karpenter controller at <194 MB /
1.55% CPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Offerings
# ---------------------------------------------------------------------------

REGIONS = ("us-east-1", "us-west-2", "eu-west-1", "ap-northeast-1")
AZS_PER_REGION = 3

#: family letter -> (GiB memory per vCPU, on-demand $ per vCPU-hour at gen 6)
FAMILY_SPECS = {
    "m": (4.0, 0.0480),   # general purpose
    "c": (2.0, 0.0425),   # compute optimized
    "r": (8.0, 0.0630),   # memory optimized
}

#: specialization suffix -> (on-demand price multiplier, kind)
SPECIALIZATIONS = {
    "": (1.00, "general"),
    "n": (1.35, "network"),
    "d": (1.25, "disk"),
    "dn": (1.55, "network+disk"),
}

#: vendor suffix -> (per-core CoreMark multiplier, price multiplier)
VENDORS = {"i": (1.00, 1.00), "a": (0.97, 0.90), "g": (0.90, 0.80)}

GENERATIONS = (5, 6, 7, 8)
#: instance size name -> vCPU count
SIZES = {
    "large": 2, "xlarge": 4, "2xlarge": 8, "4xlarge": 16,
    "8xlarge": 32, "12xlarge": 48, "16xlarge": 64, "24xlarge": 96,
}

GEN6_CORE_SCORE = 23_000.0       # per-core CoreMark anchor (gen 6 intel)
GEN_SCORE_STEP = 0.09            # +9% per generation
GEN_PRICE_STEP = 0.045           # +4.5% od price per generation


@dataclasses.dataclass(frozen=True)
class Offering:
    """One instance type in one availability zone (the ILP's ``I_i``)."""

    offering_id: str             # e.g. "c7in.4xlarge@us-east-1a"
    instance_type: str           # e.g. "c7in.4xlarge"
    family: str                  # "c"
    generation: int              # 7
    vendor: str                  # "i" | "a" | "g"
    specialization: str          # "general" | "network" | "disk" | "network+disk"
    size: str                    # "4xlarge"
    region: str
    az: str
    vcpus: int                   # CPU_i
    mem_gib: float               # Mem_i
    od_price: float              # OP_i   ($/hour)
    spot_price: float            # SP_i   ($/hour)
    bs_core: float               # BS_i   (single-core CoreMark, Table 1)
    sps_single: int              # single-node SPS in {1,2,3}
    t3: int                      # T3_i: max simultaneous nodes at SPS 3
    interruption_freq: int       # IF band in {0..4} (SpotVerse input)

    @property
    def base_instance_type(self) -> str:
        """The general-purpose sibling used as OP_base in Eq. 8."""
        return f"{self.family}{self.generation}{self.vendor}.{self.size}"


def _mk_offering(rng: np.random.Generator, family: str, gen: int, vendor: str,
                 spec_suffix: str, size: str, region: str, az: str,
                 od_base_per_vcpu: float) -> Offering:
    vcpus = SIZES[size]
    mem_per_vcpu, _ = FAMILY_SPECS[family]
    spec_mult, spec_kind = SPECIALIZATIONS[spec_suffix]
    vendor_score, vendor_price = VENDORS[vendor]

    od = (od_base_per_vcpu * vcpus * spec_mult * vendor_price
          * (1.0 + GEN_PRICE_STEP * (gen - 6)))
    # Spot discount decoupled from performance (Fig. 1), with the real
    # market's structure: small sizes are contested (shallow discounts),
    # large unpopular sizes carry deep discounts, and specialized variants'
    # spot prices do NOT carry the full on-demand premium (Fig. 1b/1c —
    # lower spot demand for n/d/dn hardware) — which is what makes the
    # Eq. 8 boost decisive under a matching workload intent.
    size_frac = math.log2(vcpus / 2.0) / math.log2(48.0)     # 0 (large) .. 1 (24xl)
    discount = float(np.clip(rng.beta(5.0, 2.5) * (0.68 + 0.42 * size_frac),
                             0.25, 0.93))
    # specialized variants' spot carries only part of the od premium
    # (lower spot demand for n/d/dn hardware): divide by a slack factor so
    # the spot premium (e.g. 1.29x for "n") sits below the od premium
    # (1.35x) that Eq. 8 credits back under a matching intent.
    spec_slack = 1.0 + 0.40 * (spec_mult - 1.0)
    spot = od * (1.0 - discount) / spec_slack

    # CoreMark per core: generation/vendor driven, *not* specialization driven
    # (Fig. 1b/1c: specialized hardware raises price, not compute score).
    bs_core = (GEN6_CORE_SCORE * vendor_score
               * (1.0 + GEN_SCORE_STEP * (gen - 6))
               * float(rng.normal(1.0, 0.015)))

    # Multi-node capacity: larger instances have lower availability [39];
    # newer generations are scarcer on the spot market.
    t3_mean = 42.0 / math.sqrt(vcpus / 2.0) * (1.0 - 0.08 * (gen - 5))
    t3 = int(np.clip(rng.poisson(max(t3_mean, 0.5)), 0, 50))
    # Single-node SPS is often high even when multi-node capacity is thin
    # (Fig. 2's trap): draw it nearly independently.
    sps_single = int(rng.choice([1, 2, 3], p=[0.15, 0.25, 0.60]))
    if t3 >= 25:
        sps_single = 3
    interruption_freq = int(np.clip(4 - t3 // 10 + rng.integers(-1, 2), 0, 4))

    itype = f"{family}{gen}{vendor}{spec_suffix}.{size}"
    return Offering(
        offering_id=f"{itype}@{az}",
        instance_type=itype,
        family=family,
        generation=gen,
        vendor=vendor,
        specialization=spec_kind,
        size=size,
        region=region,
        az=az,
        vcpus=vcpus,
        mem_gib=mem_per_vcpu * vcpus,
        od_price=round(od, 4),
        spot_price=round(max(spot, 0.001), 4),
        bs_core=round(bs_core, 1),
        sps_single=sps_single,
        t3=t3,
        interruption_freq=interruption_freq,
    )


def generate_catalog(seed: int = 0,
                     regions: Sequence[str] = REGIONS,
                     families: Sequence[str] = ("m", "c", "r"),
                     generations: Sequence[int] = GENERATIONS,
                     sizes: Optional[Sequence[str]] = None,
                     max_offerings: Optional[int] = None) -> List[Offering]:
    """Build a seeded synthetic catalog mirroring the SpotLake archive shape.

    Default scope: 3 families x 4 gens x {i,a,g} vendors x 4 specializations
    x 8 sizes x 4 regions x 3 AZs; graviton has no specialized variants and
    gen-5 has no "dn", matching AWS's real sparsity -> ~700+ instance types.
    """
    rng = np.random.default_rng(seed)
    sizes = tuple(sizes or SIZES.keys())
    out: List[Offering] = []
    for region in regions:
        for family in families:
            _, od_vcpu = FAMILY_SPECS[family]
            for gen in generations:
                for vendor in VENDORS:
                    specs = [""] if vendor == "g" else (
                        ["", "n", "d"] if gen == 5 else ["", "n", "d", "dn"])
                    for spec_suffix in specs:
                        for size in sizes:
                            for az_i in range(AZS_PER_REGION):
                                az = f"{region}{chr(ord('a') + az_i)}"
                                out.append(_mk_offering(
                                    rng, family, gen, vendor, spec_suffix,
                                    size, region, az, od_vcpu))
    if max_offerings is not None and len(out) > max_offerings:
        idx = rng.choice(len(out), size=max_offerings, replace=False)
        out = [out[i] for i in sorted(idx)]
    return out


def restrict(catalog: Iterable[Offering], *,
             instance_types: Optional[Sequence[str]] = None,
             regions: Optional[Sequence[str]] = None,
             families: Optional[Sequence[str]] = None) -> List[Offering]:
    """User-preference candidate filtering (Section 3: category / region)."""
    out = []
    for o in catalog:
        if instance_types is not None and o.instance_type not in instance_types:
            continue
        if regions is not None and o.region not in regions:
            continue
        if families is not None and o.family not in families:
            continue
        out.append(o)
    return out


# ---------------------------------------------------------------------------
# Interrupt events + market simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InterruptEvent:
    """A spot interruption notice (the 2-minute warning) for ``count`` nodes."""

    time: float                  # simulator hours
    offering_id: str
    count: int
    reason: str = "capacity-reclaim"


def snapshot_with(catalog: Sequence[Offering], spot: np.ndarray,
                  t3: np.ndarray) -> List[Offering]:
    """Materialize a market snapshot: the static catalog with live SP_i/T3_i.

    Shared by :meth:`SpotMarketSimulator.snapshot` and the scenario engine's
    replay path (``repro.sim``), which reconstructs snapshots from recorded
    ``market_state`` trace records instead of a live simulator.
    """
    return [dataclasses.replace(o, spot_price=float(spot[i]), t3=int(t3[i]))
            for i, o in enumerate(catalog)]


def pressure_interrupt_probability(count: int, t3: float,
                                   interruption_freq: int,
                                   hours: float) -> float:
    """Per-request interrupt probability of the pressure/IF model.

    Rises as the allocation approaches/exceeds the pool's live T3 capacity
    and with the SpotLake IF band.  Shared by the simulator's built-in
    sampler and ``repro.sim.interrupts.PressureInterruptModel`` (which runs
    the same law on its own RNG stream so scenario traces replay without
    touching the market's price RNG).
    """
    pressure = count / max(t3, 0.5)
    p = float(np.clip(0.01 + 0.10 * max(0.0, pressure - 0.8)
                      + 0.015 * interruption_freq, 0.0, 0.9))
    return 1.0 - (1.0 - p) ** hours


def pressure_interrupt_probability_batch(counts: np.ndarray, t3: np.ndarray,
                                         interruption_freq: np.ndarray,
                                         hours: float) -> np.ndarray:
    """Vectorized :func:`pressure_interrupt_probability` over any shape.

    Elementwise bitwise-identical to the scalar law (same IEEE-754 ops in
    the same order), so the batched samplers in ``repro.sim.interrupts``
    and the fleet engine (``repro.sim.fleet``) draw from probabilities that
    exactly match the per-node scalar path — the byte-identical-trace
    contract survives the vectorization (DESIGN.md §11).
    """
    counts = np.asarray(counts, dtype=np.float64)
    pressure = counts / np.maximum(np.asarray(t3, dtype=np.float64), 0.5)
    p = np.clip(0.01 + 0.10 * np.maximum(0.0, pressure - 0.8)
                + 0.015 * np.asarray(interruption_freq, dtype=np.float64),
                0.0, 0.9)
    return 1.0 - (1.0 - p) ** hours


class SpotMarketSimulator:
    """Time-stepped market: OU spot prices, drifting T3, interruptions.

    The simulator is the offline stand-in for AWS: the provisioner only ever
    sees `snapshot()` (a list of Offerings) and the event stream, exactly the
    interface the paper's Karpenter fork has against EC2.
    """

    def __init__(self, catalog: Sequence[Offering], seed: int = 0,
                 price_vol: float = 0.06, t3_vol: float = 1.6):
        self._rng = np.random.default_rng(seed)
        self._base = list(catalog)
        self._spot = np.array([o.spot_price for o in catalog])
        self._anchor = self._spot.copy()
        self._t3 = np.array([o.t3 for o in catalog], dtype=np.int64)
        self._od = np.array([o.od_price for o in catalog])
        self._price_vol = price_vol
        self._t3_vol = t3_vol
        self.time = 0.0
        self._index = {o.offering_id: i for i, o in enumerate(catalog)}

    # -- market state ------------------------------------------------------
    @property
    def catalog(self) -> List[Offering]:
        """The static offering universe this market evolves (t=0 prices)."""
        return list(self._base)

    def snapshot(self) -> List[Offering]:
        return snapshot_with(self._base, self._spot, self._t3)

    def state_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Copies of the live (spot, t3) vectors — the scenario engine's
        trace hook: these two arrays fully determine ``snapshot()``."""
        return self._spot.copy(), self._t3.copy()

    def step(self, hours: float = 1.0) -> None:
        """Advance market state (mean-reverting prices, random-walk T3)."""
        n = len(self._base)
        z = self._rng.normal(0.0, 1.0, size=n)
        self._spot += (0.15 * (self._anchor - self._spot) * hours
                       + self._price_vol * self._anchor * z * math.sqrt(hours))
        self._spot = np.clip(self._spot, 0.03 * self._od, 1.0 * self._od)
        dt3 = self._rng.normal(0.0, self._t3_vol * math.sqrt(hours), size=n)
        self._t3 = np.clip(self._t3 + np.round(dt3).astype(np.int64), 0, 50)
        self.time += hours

    def apply_shock(self, selector: str = "", price_factor: float = 1.0,
                    t3_factor: float = 1.0) -> int:
        """Scale spot prices / T3 capacity of matching offerings (RNG-free).

        ``selector`` is a substring match on ``offering_id`` ("" = whole
        market).  This is the scenario engine's deterministic shock hook
        (supply crunches, price spikes, an AZ losing capacity); the OU
        mean-reversion of :meth:`step` then pulls prices back toward anchor.
        Returns the number of offerings affected.
        """
        mask = np.array([selector in o.offering_id for o in self._base],
                        dtype=bool)
        if price_factor != 1.0:
            self._spot[mask] = np.clip(self._spot[mask] * price_factor,
                                       0.03 * self._od[mask],
                                       1.0 * self._od[mask])
        if t3_factor != 1.0:
            self._t3[mask] = np.clip(
                np.round(self._t3[mask] * t3_factor).astype(np.int64), 0, 50)
        return int(mask.sum())

    # -- provisioning-side interactions -------------------------------------
    def fulfill(self, offering_id: str, count: int,
                multi_node_aware: bool = True) -> int:
        """How many of ``count`` requested nodes actually launch (Fig. 2/9).

        Fulfillment tracks the *multi-node* capacity (T3).  A request sized
        from single-node SPS alone routinely lands on thin pools and gets
        only a few nodes -- the paper's Fig. 2 failure mode.
        """
        i = self._index[offering_id]
        capacity = int(self._t3[i] + max(0.0, self._rng.normal(2.0, 2.0)))
        del multi_node_aware  # the market doesn't care how you chose
        return int(min(count, capacity))

    def interrupts_for_pool(self, pool: Dict[str, int],
                            hours: float = 1.0) -> List[InterruptEvent]:
        """Sample interruption notices for an allocated pool over ``hours``.

        Per-node hourly interrupt probability rises as the allocation
        approaches/exceeds the pool's live T3 capacity and with the IF band.
        """
        events: List[InterruptEvent] = []
        for offering_id, count in pool.items():
            if count <= 0 or offering_id not in self._index:
                continue
            i = self._index[offering_id]
            o = self._base[i]
            p = pressure_interrupt_probability(count, float(self._t3[i]),
                                               o.interruption_freq, hours)
            lost = int(self._rng.binomial(count, p))
            if lost > 0:
                events.append(InterruptEvent(
                    time=self.time, offering_id=offering_id, count=lost))
        return events
