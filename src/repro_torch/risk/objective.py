"""The risk-adjusted provisioning objective E_risk (DESIGN.md §10).

KubePACS maximizes ``E_Total = E_PerfCost × E_OverPods`` over static
(Perf_i, SP_i).  E_risk is the same functional over *adjusted* vectors:

    Perf̂_i = Perf_i · U_i(H) · (1 − s_i)           (uptime & fulfillment)
    SP̂_i   = SP_i · max(1 + clip(d_i)·H/2, floor)   (drifted mean price)
             + SP_i · c · P_i(H) / H                 (re-provision charge)

where ``U_i(H)`` is the expected-uptime fraction and ``P_i(H)`` the
interrupt probability from :mod:`repro_torch.risk.survival`, ``s_i`` the
fulfillment-shortfall rate, ``d_i`` the clipped EWMA price drift, and
``c = reprovision_hours`` the node-hours of spend one interruption wastes
(checkpoint restore + replacement startup, amortized per hour of horizon).

Because the adjustment only substitutes the two objective vectors — the
constraint structure (Pod_i, T3_i) is untouched — the existing batched
solver stack is reused verbatim: :func:`reweight_candidates` produces
adjusted ``CandidateItem``s for GSS scoring and a reweighted
``CompiledMarket`` for the ILP via the core entry points
(:func:`repro_torch.core.efficiency.reweight_items`,
:func:`repro_torch.core.ilp.reweight_market`).

Exact reductions (property-tested): with horizon ≤ 0 the adjustment is the
identity, and with zero hazard, zero drift, and zero shortfall it is the
identity at any horizon — so E_risk degrades to E_Total exactly when the
estimators carry no risk signal.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.efficiency import (CandidateItem, NodePool, e_total,
                               reweight_items)
from ..core.ilp import CompiledMarket, reweight_market
from .estimators import RiskEstimators, RiskParams
from .survival import expected_uptime_fraction, interrupt_probability

#: lowest multiple of SP_i the drift term may produce — a crashing price
#: must not drive the effective price to zero (the ILP needs SP̂ > 0)
_PRICE_FLOOR = 0.05


@dataclasses.dataclass(frozen=True)
class RiskAdjustment:
    """The adjusted (Perf̂, SP̂) vectors for one candidate set + horizon."""

    perf: np.ndarray          # (m,) uptime/fulfillment-discounted Perf_i
    price: np.ndarray         # (m,) drift + re-provision adjusted SP_i
    hazard: np.ndarray        # (m,) per-item hazard used (diagnostics)
    horizon: float


def risk_adjustment(items: Sequence[CandidateItem],
                    estimators: RiskEstimators, horizon: float,
                    ) -> RiskAdjustment:
    """Compute (Perf̂_i, SP̂_i) for preprocessed candidates in one pass."""
    perf = np.array([it.perf for it in items], dtype=np.float64)
    price = np.array([it.spot_price for it in items], dtype=np.float64)
    if horizon <= 0 or not items:
        return RiskAdjustment(perf=perf, price=price,
                              hazard=np.zeros(len(items)), horizon=horizon)
    p: RiskParams = estimators.params
    idx = estimators.gather([it.offering.offering_id for it in items])
    hazard = estimators.hazard()[idx]
    drift = np.clip(estimators.drift()[idx], -p.drift_clip, p.drift_clip)
    short = estimators.shortfall()[idx]

    uptime = expected_uptime_fraction(hazard, horizon)
    p_int = interrupt_probability(hazard, horizon)
    perf_adj = perf * uptime * (1.0 - short)
    price_adj = (price * np.maximum(1.0 + 0.5 * drift * horizon, _PRICE_FLOOR)
                 + price * p.reprovision_hours * p_int / horizon)
    return RiskAdjustment(perf=perf_adj, price=price_adj, hazard=hazard,
                          horizon=horizon)


def serving_risk_adjustment(adj: RiskAdjustment, serve_perf: np.ndarray,
                            base_perf: np.ndarray) -> RiskAdjustment:
    """SLO-aware reweighting hook (DESIGN.md §15): carry a risk
    adjustment's multiplicative perf discount — uptime × fulfillment,
    i.e. ``adj.perf / base_perf`` — over to a *serving-rate* objective
    vector (QPS/pod · Pod_i from the serving perf model), keeping the
    price adjustment as-is.  The serving policy then optimizes expected
    *served* QPS per risk-adjusted dollar through the unchanged solver
    stack.  Exact reduction: at horizon ≤ 0 (or no risk signal)
    ``adj.perf == base_perf``, so the result is exactly ``serve_perf`` —
    pure serving reweighting with no risk term."""
    serve_perf = np.asarray(serve_perf, dtype=np.float64)
    base_perf = np.asarray(base_perf, dtype=np.float64)
    if serve_perf.shape != base_perf.shape or \
            serve_perf.shape != adj.perf.shape:
        raise ValueError("serve_perf/base_perf must match the adjustment")
    factor = np.where(base_perf > 0,
                      adj.perf / np.maximum(base_perf, 1e-300), 0.0)
    return dataclasses.replace(adj, perf=serve_perf * factor)


def reweight_candidates(items: Sequence[CandidateItem],
                        adj: RiskAdjustment,
                        market: Optional[CompiledMarket] = None,
                        ) -> Tuple[List[CandidateItem],
                                   Optional[CompiledMarket]]:
    """Adjusted candidates (+ reweighted compiled market when one is given)
    ready for the unchanged GSS × ILP stack."""
    items_adj = reweight_items(items, adj.perf, adj.price)
    market_adj = (None if market is None
                  else reweight_market(market, adj.perf, adj.price,
                                       items=items_adj))
    return items_adj, market_adj


def e_risk(pool: NodePool, req_pods: int, items_adj: Sequence[CandidateItem],
           ) -> float:
    """E_risk of a pool expressed over the *real* items: score its counts
    against the adjusted candidates (same order/filtering as the solve)."""
    by_id = {it.offering.offering_id: it for it in items_adj}
    mapped = NodePool(items=[by_id[it.offering.offering_id]
                             for it in pool.items],
                      counts=list(pool.counts))
    return e_total(mapped, req_pods)
