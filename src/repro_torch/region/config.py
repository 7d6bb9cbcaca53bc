"""The RegionPlane's declarative knob set (DESIGN.md §17).

A :class:`RegionConfig` attached to a ``Scenario`` turns the single-market
run into one control plane provisioning across K simultaneous regional
markets.  Every field defaults to the *identity*: a config with
``vol=0.0``, no caps, no spread floor, no egress, and unit hazard scales
changes nothing anywhere — that is the single-region-inertness contract
the tests and ``bench_region`` prove bit-exactly.

This module imports only the standard library so the scenario schema can
depend on it without cycles (``region.market`` / ``region.solver`` carry
the numpy machinery).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RegionConfig:
    """Multi-region provisioning knobs; all defaults are bit-inert.

    ``regions``              region tags the scenario's catalog is
                             restricted to (declaration order; ``()`` =
                             full catalog).  ``regions[0]`` is the home
                             region unless ``home_region`` overrides it.
    ``rho``                  shared-factor correlation of the per-region
                             price shocks in [0, 1]: 1 = every region
                             moves together (the dangerous regime), 0 =
                             independent markets.
    ``vol``                  log-volatility of the per-refresh regional
                             shock; 0.0 disables the price overlay
                             entirely (bitwise).
    ``shock_seed``           seed of the pure ``(seed, region, t)`` shock
                             draws — the axis ``run_fleet_paths`` sweeps.
    ``hazard_scale``         per-region interruption-hazard multipliers
                             ``((region, scale), ...)``; the per-node law
                             becomes ``1 − (1 − p)**scale``.  Unit scales
                             are skipped entirely.
    ``caps``                 per-region node caps ``((region, nodes), ...)``
                             entering the solver as post-solve repair via
                             the exclusion-mask path.
    ``min_spread``           minimum number of distinct regions any pool
                             must span (N+1 redundancy); 0 disables.
    ``home_region``          where the data lives; egress is charged on
                             pods placed anywhere else ("" = regions[0]).
    ``egress_per_pod_hour``  data-gravity cost in $ per pod-hour outside
                             the home region, charged via ``reweight_items``
                             at solve time and accrued into billing.
    """

    regions: Tuple[str, ...] = ()
    rho: float = 0.6
    vol: float = 0.0
    shock_seed: int = 0
    hazard_scale: Tuple[Tuple[str, float], ...] = ()
    caps: Tuple[Tuple[str, int], ...] = ()
    min_spread: int = 0
    home_region: str = ""
    egress_per_pod_hour: float = 0.0

    def __post_init__(self):
        # normalize so Scenario round-trips through JSON byte-exactly
        object.__setattr__(self, "regions",
                           tuple(str(r) for r in self.regions))
        object.__setattr__(self, "rho", float(self.rho))
        object.__setattr__(self, "vol", float(self.vol))
        object.__setattr__(self, "shock_seed", int(self.shock_seed))
        object.__setattr__(self, "hazard_scale", tuple(
            (str(r), float(s)) for r, s in self.hazard_scale))
        object.__setattr__(self, "caps", tuple(
            (str(r), int(c)) for r, c in self.caps))
        object.__setattr__(self, "min_spread", int(self.min_spread))
        object.__setattr__(self, "home_region", str(self.home_region))
        object.__setattr__(self, "egress_per_pod_hour",
                           float(self.egress_per_pod_hour))
        if not 0.0 <= self.rho <= 1.0:
            raise ValueError(f"rho must be in [0, 1], got {self.rho}")
        if self.vol < 0.0:
            raise ValueError(f"vol must be >= 0, got {self.vol}")

    # -- identity probes (each mechanism gates on its own knob) --------------
    @property
    def price_inert(self) -> bool:
        """True when the correlated price overlay is disabled bitwise."""
        return self.vol == 0.0

    @property
    def hazard_inert(self) -> bool:
        """True when every hazard scale is exactly 1 (law untouched)."""
        return all(s == 1.0 for _, s in self.hazard_scale)

    @property
    def solver_inert(self) -> bool:
        """True when no side-constraint enters the solve path."""
        return (not self.caps and self.min_spread <= 1
                and self.egress_per_pod_hour == 0.0)

    # -- accessors -----------------------------------------------------------
    @property
    def home(self) -> str:
        return self.home_region or (self.regions[0] if self.regions else "")

    def cap_of(self, region: str) -> Optional[int]:
        for r, c in self.caps:
            if r == region:
                return c
        return None

    def hazard_of(self, region: str) -> float:
        for r, s in self.hazard_scale:
            if r == region:
                return s
        return 1.0

    # -- serialization (mirrors Scenario.to_dict / from_dict) ----------------
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["regions"] = list(self.regions)
        d["hazard_scale"] = [list(p) for p in self.hazard_scale]
        d["caps"] = [list(p) for p in self.caps]
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "RegionConfig":
        d = dict(d)
        d["regions"] = tuple(d.get("regions", ()))
        d["hazard_scale"] = tuple(
            (r, s) for r, s in d.get("hazard_scale", ()))
        d["caps"] = tuple((r, c) for r, c in d.get("caps", ()))
        return cls(**d)


__all__ = ["RegionConfig"]
