"""Correlated regional market physics (DESIGN.md §17).

The overlay turns the scenario's single OU market into K regional markets
driven by a one-factor correlation model: each refresh at hour ``t``
draws a shared shock ``z0`` and one idiosyncratic shock ``z_r`` per
region, all *pure functions of* ``(shock_seed, region, t)`` — a fresh
``np.random.default_rng`` keyed on those coordinates, never a consumed
stream, the same idiom as ``Scenario.effective_pods``.  The region's
log-price factor is

    g_r(t) = vol · (√rho · z0(t)  +  √(1 − rho) · z_r(t))

applied multiplicatively to the region's spot rows and clipped to the
market simulator's own ``[0.03·od, od]`` band.  Because the draws are
coordinate-pure, the standalone engine, the fleet engine's shared market
path, and RNG-free replay all see bit-identical regional prices — the §9
determinism contract holds verbatim with correlation active.

The overlay is a *view transform*: the underlying ``SpotMarketSimulator``
state is never touched, so the OU mean-reversion never feeds back on the
regional factor.  World-side region fault effects (brownout capacity
thinning + price spikes, outage blackouts) live here too — they modify
TRUE state, while the observed-side effects (partition feed freezes, ICE
caps) stay in :class:`repro_torch.chaos.ChaosController`.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..chaos.faults import Fault, REGION_KINDS
from .config import RegionConfig

#: spot clip band, identical to SpotMarketSimulator's step clamp
_SPOT_FLOOR_OD = 0.03
_SPOT_CEIL_OD = 1.0


def _tag_coord(tag: str) -> int:
    """Stable 32-bit coordinate for a region tag (process-independent)."""
    return int.from_bytes(hashlib.blake2s(tag.encode(), digest_size=4)
                          .digest(), "big")


def region_shock(seed: int, tag: str, t: float) -> float:
    """One standard-normal draw, a pure function of ``(seed, tag, t)``.

    The time coordinate is ``int(round(t * 3600))`` — exact for any tick
    grid down to one second, like the engine's other coordinate-pure
    draws."""
    rng = np.random.default_rng((int(seed) & 0xFFFFFFFF, _tag_coord(tag),
                                 int(round(float(t) * 3600.0))))
    return float(rng.standard_normal())


def regional_price_factors(cfg: RegionConfig, regions: Sequence[str],
                           t: float) -> Dict[str, float]:
    """The multiplicative price factor ``exp(g_r(t))`` per region."""
    if cfg.vol == 0.0:
        return {r: 1.0 for r in regions}
    z0 = region_shock(cfg.shock_seed, "__shared__", t)
    w_shared = math.sqrt(cfg.rho)
    w_own = math.sqrt(1.0 - cfg.rho)
    out: Dict[str, float] = {}
    for r in regions:
        g = cfg.vol * (w_shared * z0
                       + w_own * region_shock(cfg.shock_seed, r, t))
        out[r] = math.exp(g)
    return out


class RegionalMarketOverlay:
    """Pure per-refresh transform of the TRUE ``(spot, t3)`` arrays.

    Built once per run from the (static) catalog, the region config, and
    the scenario's declared region-kind fault windows; :meth:`apply` is a
    pure function of its arguments and the refresh time.  When nothing
    applies at ``t`` the inputs are returned *by reference* — the
    engine-side identity checks (and the inertness contract) rely on
    that."""

    def __init__(self, cfg: RegionConfig, catalog: Sequence,
                 faults: Sequence[Fault] = ()) -> None:
        self.cfg = cfg
        regions = [getattr(o, "region", "") for o in catalog]
        #: region tags present in the catalog, sorted for a stable
        #: factor-evaluation order
        self.regions: Tuple[str, ...] = tuple(sorted(set(regions)))
        self._rows: Dict[str, np.ndarray] = {
            r: np.array([x == r for x in regions], dtype=bool)
            for r in self.regions}
        self._od = np.array([o.od_price for o in catalog], dtype=np.float64)
        # world-side region faults only; partitions are observed-side
        self._faults: List[Fault] = [
            f for f in faults
            if f.kind in ("region_brownout", "region_outage")]

    def apply(self, spot: np.ndarray, t3: np.ndarray, t: float,
              ) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        active = [f for f in self._faults if f.active(t)]
        if cfg.vol == 0.0 and not active:
            return spot, t3          # bit-inert: same objects out
        spot2 = np.array(spot, dtype=np.float64, copy=True)
        t32 = np.array(t3, copy=True)
        if cfg.vol != 0.0:
            factors = regional_price_factors(cfg, self.regions, t)
            for r in self.regions:
                f = factors[r]
                if f != 1.0:
                    rows = self._rows[r]
                    spot2[rows] = spot2[rows] * f
        for f in active:
            rows = self._rows.get(f.selector)
            if rows is None or not rows.any():
                continue
            if f.kind == "region_brownout":
                # thinned capacity + scarcity-spiked prices, feed truthful
                t32[rows] = np.floor(
                    t32[rows].astype(np.float64) * (1.0 - f.magnitude)
                ).astype(t32.dtype)
                spot2[rows] = spot2[rows] * (1.0 + f.magnitude)
            else:                    # region_outage: the region is dark
                t32[rows] = 0
        np.clip(spot2, _SPOT_FLOOR_OD * self._od,
                _SPOT_CEIL_OD * self._od, out=spot2)
        return spot2, t32


def make_overlay(cfg: Optional[RegionConfig], catalog: Sequence,
                 faults: Sequence[Fault] = (),
                 ) -> Optional[RegionalMarketOverlay]:
    """The engines' one overlay-construction rule: an overlay exists iff
    the scenario declares a region config *or* any region-kind fault
    (whose world-side effects live here even without a config).  None
    means the market path is untouched — the inert case costs nothing."""
    has_region_faults = any(f.kind in REGION_KINDS for f in faults)
    if cfg is None and not has_region_faults:
        return None
    return RegionalMarketOverlay(cfg if cfg is not None else RegionConfig(),
                                 catalog, faults)


# -- hazard regimes ----------------------------------------------------------
def hazard_scale_rows(cfg: Optional[RegionConfig],
                      catalog: Sequence) -> Optional[np.ndarray]:
    """Per-offering hazard-scale vector aligned to catalog order, or None
    when the config is absent or every scale is exactly 1 (the law must
    stay bitwise untouched then — ``x ** 1.0`` is not a guaranteed
    no-op)."""
    if cfg is None or not cfg.hazard_scale or cfg.hazard_inert:
        return None
    return np.array([cfg.hazard_of(getattr(o, "region", ""))
                     for o in catalog], dtype=np.float64)


def apply_hazard_scale(p: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """``p' = 1 − (1 − p)**scale`` — the one definition of the regional
    hazard regime, shared by the standalone model and the fleet engine's
    batched path so the two stay bitwise identical."""
    return 1.0 - (1.0 - p) ** scale


# -- data gravity ------------------------------------------------------------
def egress_row_costs(cfg: Optional[RegionConfig],
                     items: Sequence) -> Optional[np.ndarray]:
    """Per-item egress $/node-hour (rate × pods-per-node for every item
    outside the home region), or None when egress is off."""
    if cfg is None or cfg.egress_per_pod_hour == 0.0:
        return None
    home = cfg.home
    return np.array([0.0 if getattr(it.offering, "region", "") == home
                     else cfg.egress_per_pod_hour * it.pods
                     for it in items], dtype=np.float64)


def pool_egress_rate(cfg: RegionConfig, pool) -> float:
    """Egress $/hour a pool accrues: allocated pods placed outside the
    home region, at ``egress_per_pod_hour``."""
    if pool is None or cfg.egress_per_pod_hour == 0.0:
        return 0.0
    home = cfg.home
    total = 0.0
    for it, c in zip(pool.items, pool.counts):
        if c > 0 and getattr(it.offering, "region", "") != home:
            total += cfg.egress_per_pod_hour * it.pods * c
    return total


def region_pool_shares(pool) -> Dict[str, int]:
    """Nodes per region in a pool (empty dict for an empty pool)."""
    shares: Dict[str, int] = {}
    if pool is None:
        return shares
    for it, c in zip(pool.items, pool.counts):
        if c > 0:
            r = getattr(it.offering, "region", "")
            shares[r] = shares.get(r, 0) + int(c)
    return shares


__all__ = ["RegionalMarketOverlay", "apply_hazard_scale", "egress_row_costs",
           "hazard_scale_rows", "make_overlay", "pool_egress_rate",
           "region_pool_shares", "region_shock", "regional_price_factors"]
