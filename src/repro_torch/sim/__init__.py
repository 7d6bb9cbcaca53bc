"""Trace-driven scenario engine for spot-cluster simulation (DESIGN.md §9).

Scenarios are declarative specs (``Scenario``); ``ClusterSim`` runs them
through a discrete-event loop over market ticks, shocks, demand changes,
and pluggable interruption models, recording a replayable JSONL trace.
``FleetSim`` advances many seeds in lockstep; its batched solves (and every
inline ``ClusterSim`` solve under the process default) run on the card
unless given ``"torch:cpu"`` / ``"torch:fused:cpu"`` or ``"numpy"``.
"""

from .events import InterruptNotice, TRACE_VERSION
from .interrupts import (InterruptModel, NullInterruptModel,
                         PressureInterruptModel, PriceCrossingInterruptModel,
                         RebalanceRecommendationModel, make_interrupt_model)
from .policy import (FixedAlphaPolicy, KarpenterLikePolicy, KubePACSPolicy,
                     KubePACSRiskPolicy, Policy, ServingSLOPolicy,
                     make_policy)
from .scenario import (Scenario, Shock, heterogeneous_demand_scenario,
                       high_demand_scenario, serving_scenario)
from .trace import TraceRecorder, load_trace, loads_trace
from .engine import (ClusterSim, LiveMarketSource, ReplaySource,
                     ScriptedMarketSource, SimResult, SimRound, run_replicas,
                     script_market_states)
from .fleet import FleetSim, run_fleet, run_fleet_paths
from .convert import scenario_from_reference

__all__ = [
    "InterruptNotice", "TRACE_VERSION", "InterruptModel",
    "NullInterruptModel", "PressureInterruptModel",
    "PriceCrossingInterruptModel", "RebalanceRecommendationModel",
    "make_interrupt_model", "Policy", "KubePACSPolicy", "KubePACSRiskPolicy",
    "KarpenterLikePolicy",
    "FixedAlphaPolicy", "ServingSLOPolicy", "make_policy", "Scenario",
    "Shock",
    "heterogeneous_demand_scenario", "high_demand_scenario",
    "serving_scenario",
    "TraceRecorder",
    "load_trace", "loads_trace", "ClusterSim", "LiveMarketSource",
    "ReplaySource", "ScriptedMarketSource", "SimResult", "SimRound",
    "run_replicas", "script_market_states", "FleetSim", "run_fleet",
    "run_fleet_paths", "scenario_from_reference",
]
