"""Availability forecasting and risk-adjusted provisioning (DESIGN.md §10).

A learning layer between market data and the solver: online estimators
(:mod:`~repro_torch.risk.estimators`) turn the scenario engine's event stream
into per-offering hazard / price-drift / fulfillment-shortfall signals; a
survival model (:mod:`~repro_torch.risk.survival`) converts hazard into expected
uptime over a provisioning horizon; and the risk-adjusted objective
(:mod:`~repro_torch.risk.objective`) folds both into adjusted (Perf̂, SP̂)
vectors that the unchanged GSS × ILP stack consumes — the
``kubepacs_risk[:horizon]`` policy in ``repro_torch.sim.policy``.

:mod:`~repro_torch.risk.backtest` replays recorded traces to score forecast
calibration and compare risk-aware vs static provisioning on perf-per-
dollar net of interruption losses.  (Import it as ``repro_torch.risk.backtest``;
it depends on ``repro_torch.sim``, which itself imports the modules above, so the
package root stays cycle-free by not re-exporting it.)
"""

from .estimators import RiskEstimators, RiskParams, replay_observations
from .objective import (RiskAdjustment, e_risk, reweight_candidates,
                        risk_adjustment)
from .survival import (expected_interrupted_nodes, expected_uptime_fraction,
                       interrupt_probability, survival_curve)

__all__ = [
    "RiskEstimators", "RiskParams", "replay_observations",
    "RiskAdjustment", "risk_adjustment", "reweight_candidates", "e_risk",
    "survival_curve", "interrupt_probability", "expected_uptime_fraction",
    "expected_interrupted_nodes",
]
