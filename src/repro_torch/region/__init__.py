"""RegionPlane: multi-region fleet arbitration (DESIGN.md §17).

Layered to stay cycle-free with the rest of the package:

- :mod:`repro_torch.region.config` — the declarative :class:`RegionConfig`
  (standard library only; the scenario schema imports it).
- :mod:`repro_torch.region.market` — the correlated shock overlay, hazard
  regimes, and data-gravity helpers (core + chaos.faults only).
- :mod:`repro_torch.region.solver` — region side-constraints wrapped around the
  unchanged GSS × ILP stack.
- :mod:`repro_torch.region.policy` — the region-aware policies; imported lazily
  (PEP 562) because it depends on :mod:`repro_torch.sim.policy`, which reaches
  back here via the scenario schema.
"""

from .config import RegionConfig
from .market import (RegionalMarketOverlay, apply_hazard_scale,
                     egress_row_costs, hazard_scale_rows, make_overlay,
                     pool_egress_rate, region_pool_shares, region_shock,
                     regional_price_factors)
from .solver import solve_with_regions

_POLICY_SYMBOLS = ("RegionAwarePolicy", "RegionPinnedPolicy")

__all__ = ["RegionConfig", "RegionalMarketOverlay", "apply_hazard_scale",
           "egress_row_costs", "hazard_scale_rows", "make_overlay",
           "pool_egress_rate", "region_pool_shares", "region_shock",
           "regional_price_factors", "solve_with_regions", *_POLICY_SYMBOLS]


def __getattr__(name):
    if name in _POLICY_SYMBOLS:
        from . import policy
        return getattr(policy, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
