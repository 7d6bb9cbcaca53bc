"""Region side-constraints over the unchanged GSS × ILP stack (§17).

Three constraints enter ``solve_ilp`` *without touching the solver*:

- **Data-gravity / egress costs** ride the O(n) objective-reweight path
  (``reweight_items`` + ``reweight_market``): every candidate outside the
  home region is priced at ``SP_i + egress_per_pod_hour · Pod_i`` for the
  solve, and the returned counts are mapped back onto the true-priced
  items (the risk subsystem's pattern) so billing stays on TRUE prices.
- **Per-region capacity caps** are a deterministic post-solve repair: a
  violating region is trimmed to its cap (best perf-per-dollar nodes
  kept), joins the at-cap set, and the residual demand is re-solved with
  the at-cap regions' rows OR-ed into the §4.1 exclusion mask.  Regions
  only ever *enter* the at-cap set, so the loop terminates in ≤ K rounds.
- **Minimum region spread** (N+1 redundancy) force-places one
  availability-first node (lowest IF, then cheapest per pod — the safe
  rung's ordering) in each missing region after the solve.

Because the side-constraints wrap the solve rather than extend it, the
fused device backend is reused unchanged for the inner solves — and
region-aware policies deliberately solve *inline* (``set_solve_batch`` is
a no-op for them), so the cross-decision fused batch path never sees a
side-constrained solve: the host handles them, mirroring the
approx-tier split.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.efficiency import NodePool, pool_metric_arrays, reweight_items
from ..core.gss import bracketed_gss
from ..core.ilp import CompiledMarket, compile_market, reweight_market
from ..core.provisioner import merge_pools
from .config import RegionConfig
from .market import egress_row_costs, region_pool_shares


def _region_of(item) -> str:
    return getattr(item.offering, "region", "")


def _real_pool(pool: Optional[NodePool],
               items: Sequence) -> Optional[NodePool]:
    """Map a pool solved over reweighted items back onto the true-priced
    candidates (counts are positional over offering_id)."""
    if pool is None:
        return None
    real = {it.offering.offering_id: it for it in items}
    return NodePool(items=[real[it.offering.offering_id]
                           for it in pool.items],
                    counts=list(pool.counts), alpha=pool.alpha,
                    request=pool.request)


def _region_rows(items: Sequence, regions) -> np.ndarray:
    rs = set(regions)
    return np.array([_region_of(it) in rs for it in items], dtype=bool)


def _or_mask(base: Optional[np.ndarray],
             extra: np.ndarray) -> Optional[np.ndarray]:
    if not extra.any():
        return base
    return extra if base is None else (base | extra)


def solve_with_regions(items: Sequence, req_pods: int, cfg: RegionConfig,
                       *, market: Optional[CompiledMarket] = None,
                       tolerance: float = 0.01,
                       exclude: Optional[np.ndarray] = None,
                       timer: Callable[[], float] = time.perf_counter,
                       backend=None, coarsening=None,
                       ) -> Tuple[Optional[NodePool], object, Dict]:
    """Guarded GSS with the region side-constraints applied around it.

    Returns ``(pool, gss_trace, info)`` where ``info`` counts the repair
    work (``cap_repairs``, ``spread_forced``, ``egress_reweighted``).
    With a solver-inert config this is exactly ``bracketed_gss`` — same
    arguments, same result."""
    info: Dict = {"cap_repairs": 0, "spread_forced": 0,
                  "egress_reweighted": False}
    items = list(items)
    if market is None:
        market = compile_market(items)

    solve_items, solve_market = items, market
    egress = egress_row_costs(cfg, items)
    if egress is not None and egress.any():
        perf, price, _ = pool_metric_arrays(items)
        priced = price + egress
        solve_items = reweight_items(items, perf, priced)
        solve_market = reweight_market(market, perf, priced,
                                       items=solve_items)
        info["egress_reweighted"] = True

    def _solve(pods: int, mask: Optional[np.ndarray]):
        pool, trace = bracketed_gss(solve_items, pods, tolerance,
                                    market=solve_market, exclude=mask,
                                    timer=timer, backend=backend,
                                    coarsening=coarsening)
        return _real_pool(pool, items), trace

    pool, trace = _solve(int(req_pods), exclude)
    if pool is None:
        return None, trace, info

    if cfg.caps:
        pool = _repair_caps(pool, items, req_pods, cfg, exclude, _solve,
                            info)
    if cfg.min_spread > 1:
        pool = _force_spread(pool, items, cfg, exclude, info)
    return pool, trace, info


def _repair_caps(pool: NodePool, items: Sequence, req_pods: int,
                 cfg: RegionConfig, exclude: Optional[np.ndarray],
                 solve: Callable, info: Dict) -> NodePool:
    at_cap: set = set()
    for _ in range(len(cfg.caps) + 1):
        shares = region_pool_shares(pool)
        viol = [(r, c) for r, c in cfg.caps if shares.get(r, 0) > c]
        if not viol:
            break
        region, cap = viol[0]        # caps declaration order: deterministic
        info["cap_repairs"] += 1
        at_cap.add(region)
        # trim the region to its cap, best perf-per-dollar nodes first
        entries = [(i, it, c) for i, (it, c)
                   in enumerate(zip(pool.items, pool.counts))
                   if c > 0 and _region_of(it) == region]
        entries.sort(key=lambda e: (-(e[1].perf / e[1].spot_price),
                                    e[1].offering.offering_id))
        counts = list(pool.counts)
        budget = cap
        for i, it, c in entries:
            take = min(int(c), budget)
            counts[i] = take
            budget -= take
        pool = NodePool(items=list(pool.items), counts=counts,
                        alpha=pool.alpha, request=pool.request)
        deficit = int(req_pods) - pool.total_pods
        if deficit > 0:
            mask = _or_mask(exclude, _region_rows(items, at_cap))
            extra, _ = solve(deficit, mask)
            if extra is not None:
                pool = merge_pools(pool, extra)
    return pool


def _force_spread(pool: NodePool, items: Sequence, cfg: RegionConfig,
                  exclude: Optional[np.ndarray], info: Dict) -> NodePool:
    shares = region_pool_shares(pool)
    used = {r for r, n in shares.items() if n > 0}
    rows_ok = (np.ones(len(items), dtype=bool) if exclude is None
               else ~np.asarray(exclude, dtype=bool))
    available = sorted({_region_of(it) for i, it in enumerate(items)
                        if rows_ok[i]})
    for region in available:
        if len(used) >= cfg.min_spread:
            break
        if region in used:
            continue
        cap = cfg.cap_of(region)
        if cap is not None and shares.get(region, 0) + 1 > cap:
            continue
        cands = [it for i, it in enumerate(items)
                 if rows_ok[i] and _region_of(it) == region and it.t3 >= 1]
        if not cands:
            continue
        best = min(cands, key=lambda it: (it.offering.interruption_freq,
                                          it.spot_price / it.pods,
                                          it.offering.offering_id))
        pool = merge_pools(pool, NodePool(items=[best], counts=[1],
                                          alpha=pool.alpha,
                                          request=pool.request))
        used.add(region)
        info["spread_forced"] += 1
    return pool


__all__ = ["solve_with_regions"]
