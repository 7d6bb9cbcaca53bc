"""Region-aware provisioning policies (DESIGN.md §17).

Both policies ride :class:`repro_torch.sim.policy._BaselinePolicy`'s §4.1
plumbing (TTL exclusion cache, shortfall protocol, decision-memo hooks)
and solve *inline*: ``set_solve_batch`` stays the base-class no-op, so
the fleet engine's cross-decision fused batches never see a
side-constrained solve — the host declines them by construction,
mirroring the approx-tier split.

``kubepacs_region``
    The KubePACS objective with the scenario ``RegionConfig``'s
    side-constraints (per-region caps, minimum spread, egress pricing)
    applied through :func:`repro_torch.region.solver.solve_with_regions`.
``region_pinned:<R>``
    The single-market strawman — only region R's offerings are feasible
    (their complement is ORed into the §4.1 exclusion mask).  This is
    the comparator ``bench_region`` measures the hardened policy's
    cross-region failover against.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from ..core.efficiency import CandidateItem, NodePool
from ..core.gss import bracketed_gss
from ..sim.policy import Precompiled, _BaselinePolicy
from .config import RegionConfig
from .solver import solve_with_regions


class RegionPinnedPolicy(_BaselinePolicy):
    """Provision exclusively inside one region."""

    def __init__(self, pin_region: str, tolerance: float = 0.01,
                 ttl_hours: float = 2.0,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        super().__init__(ttl_hours, clock)
        self.pin_region = str(pin_region)
        self.tolerance = float(tolerance)
        self.name = f"region_pinned:{self.pin_region}"

    def _extra_mask(self, items: List[CandidateItem]) -> Optional[np.ndarray]:
        mask = np.array([getattr(it.offering, "region", "")
                         != self.pin_region for it in items], dtype=bool)
        return mask if mask.any() else None

    def _solve(self, items, req_pods, exclude, precompiled):
        market = precompiled[1] if precompiled is not None else None
        pool, _ = bracketed_gss(items, req_pods, self.tolerance,
                                market=market, exclude=exclude,
                                timer=self.clock)
        if pool is None:         # the pinned region cannot cover demand
            return NodePool(items=[], counts=[]), None
        return pool, pool.alpha


class RegionAwarePolicy(_BaselinePolicy):
    """KubePACS objective + RegionConfig side-constraints, solved inline."""

    name = "kubepacs_region"

    def __init__(self, region: Optional[RegionConfig],
                 tolerance: float = 0.01, ttl_hours: float = 2.0,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        super().__init__(ttl_hours, clock)
        # without a config the policy degrades to plain guarded GSS — a
        # solver-inert config and no config decide identically
        self.region = region if region is not None else RegionConfig()
        self.tolerance = float(tolerance)
        #: cumulative side-constraint repair work, for the examples /
        #: benches to report (``region_*`` keys, like the guard's
        #: ``chaos_*`` counters)
        self.stats: Dict[str, int] = {"region_cap_repairs": 0,
                                      "region_spread_forced": 0,
                                      "region_egress_solves": 0}

    def _solve(self, items, req_pods, exclude, precompiled):
        market = precompiled[1] if precompiled is not None else None
        pool, _, info = solve_with_regions(
            items, req_pods, self.region, market=market,
            tolerance=self.tolerance, exclude=exclude, timer=self.clock)
        self.stats["region_cap_repairs"] += info["cap_repairs"]
        self.stats["region_spread_forced"] += info["spread_forced"]
        self.stats["region_egress_solves"] += int(info["egress_reweighted"])
        if pool is None:
            return NodePool(items=[], counts=[]), None
        return pool, pool.alpha


__all__ = ["RegionAwarePolicy", "RegionPinnedPolicy"]
