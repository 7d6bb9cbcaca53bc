"""Batched exponential survival model over per-offering hazard rates.

Under a constant hazard λ_i (events per node-hour, from
:class:`repro_torch.risk.estimators.RiskEstimators`), a node of offering i
survives h hours with probability ``S_i(h) = exp(−λ_i·h)``.  Everything the
risk-adjusted objective needs follows in closed form and vectorizes over
the whole catalog:

* survival curves ``S_i(h)`` over a horizon grid — (n, H) in one call,
* interrupt probability over a horizon ``P_i(H) = 1 − exp(−λ_i·H)``,
* expected-uptime fraction
  ``U_i(H) = (1/H)·∫₀ᴴ S_i(t) dt = (1 − exp(−λ_i·H)) / (λ_i·H)``,
  the factor E_risk multiplies into Perf_i (→ 1 as λ·H → 0).

All functions use ``−expm1(−x)`` for 1 − e^(−x) and switch to the exact
limit below ``_SMALL`` so the hazard → 0 / horizon → 0 reductions of
DESIGN.md §10 hold bitwise, not just approximately.
"""

from __future__ import annotations

import numpy as np

_SMALL = 1e-12


def survival_curve(hazard: np.ndarray, hours: np.ndarray) -> np.ndarray:
    """S_i(h) = exp(−λ_i·h) as an (n_offerings, n_hours) matrix."""
    hazard = np.asarray(hazard, dtype=np.float64).reshape(-1, 1)
    hours = np.asarray(hours, dtype=np.float64).reshape(1, -1)
    return np.exp(-hazard * hours)


def interrupt_probability(hazard: np.ndarray, horizon: float) -> np.ndarray:
    """P_i(H) = 1 − exp(−λ_i·H): chance a node is reclaimed within H hours."""
    hazard = np.asarray(hazard, dtype=np.float64)
    if horizon <= 0:
        return np.zeros_like(hazard)
    return -np.expm1(-hazard * horizon)


def expected_uptime_fraction(hazard: np.ndarray,
                             horizon: float) -> np.ndarray:
    """U_i(H) = (1 − exp(−λ_i·H)) / (λ_i·H), exactly 1 in the λ·H → 0 limit.

    The fraction of the next ``horizon`` hours a freshly-launched node of
    offering i is expected to be alive — the uptime discount E_risk applies
    to Perf_i.
    """
    hazard = np.asarray(hazard, dtype=np.float64)
    if horizon <= 0:
        return np.ones_like(hazard)
    x = hazard * horizon
    with np.errstate(divide="ignore", invalid="ignore"):
        u = -np.expm1(-x) / x
    return np.where(x < _SMALL, 1.0, u)


def expected_interrupted_nodes(hazard: np.ndarray, counts: np.ndarray,
                               hours: float) -> np.ndarray:
    """E[nodes lost] = x_i·(1 − exp(−λ_i·h)) — the calibration forecast the
    backtest compares against realized interrupt counts."""
    return np.asarray(counts, dtype=np.float64) * interrupt_probability(
        hazard, hours)
