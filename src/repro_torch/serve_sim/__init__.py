"""ServeSim: SLO-driven serving co-simulation (DESIGN.md §15).

Connects the ML stack (roofline perf model over ``serving.py`` decode
cells) to the provisioning plane (ClusterSim + the ``serving_slo``
policy): deterministic request-rate traces, per-offering QPS/latency
tables, square-root-staffed pod demand, latency-SLO feasibility masks,
and interruption → recovery QPS accounting.

Import layering: ``workload`` and ``perf_model`` are leaf modules
(``repro_torch.sim`` imports them), while ``sim`` imports ``repro_torch.sim`` — the
runner names below are therefore exposed lazily via ``__getattr__`` to
keep the package importable from either direction without a cycle.
"""

from __future__ import annotations

from .perf_model import (ServingProfile, ServingTable, analytic_token_s,
                         cache_stats, clear_caches, default_profile,
                         default_slo_ms, reference_qps_per_pod,
                         reference_token_s, serving_table)
from .workload import (DEFAULT_STAFFING_BETA, WorkloadSpec,
                       demand_schedule_from_trace, staffed_pods,
                       trace_digest)

_SIM_NAMES = ("DEFAULT_RECOVERY_HOURS", "PoolTimeline", "ServeReport",
              "ServeScenario", "build_serve_scenario", "evaluate_serving",
              "run_serving")


def __getattr__(name: str):
    if name in _SIM_NAMES:
        from . import sim
        return getattr(sim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DEFAULT_RECOVERY_HOURS", "DEFAULT_STAFFING_BETA", "PoolTimeline",
    "ServeReport", "ServeScenario", "ServingProfile", "ServingTable",
    "WorkloadSpec", "analytic_token_s", "build_serve_scenario",
    "cache_stats", "clear_caches", "default_profile", "default_slo_ms",
    "demand_schedule_from_trace", "evaluate_serving",
    "reference_qps_per_pod", "reference_token_s", "run_serving",
    "serving_table", "staffed_pods", "trace_digest",
]
