"""Serving co-simulation benchmark: served QPS per dollar under SLO
(DESIGN.md §15).

Returns (and with ``--json`` writes) the fig-style policy comparison for
the serving scenario family:

  * per workload (``diurnal`` headline; ``bursty`` / ``flash`` in the
    full run) every policy provisions the *same* square-root-staffed pod
    demand, and the report integrates served / SLO-served QPS-hours
    against each policy's capacity timeline (recovery warm-up charged);
  * ``headline.serve_qps_per_dollar_ratio`` — serving_slo over
    karpenter_like on SLO-served QPS-hours per dollar, diurnal — must
    meet ``TARGET_SLO_QPS_RATIO`` at equal-or-better SLO attainment;
  * before timing anything the bench re-proves the determinism contract
    (same seed ⇒ identical workload trace digest AND an identical serving
    report on a re-run) and asserts **zero SLO-mask infeasibilities** for
    serving_slo on the pinned market — a comparison against an infeasible
    or non-reproducible run would be meaningless, so these raise.

``gate_measurement()`` is the :mod:`.perf_gate` entry point: it pins the
*analytic* perf-model mode (via the ``KUBEPACS_SERVE_PERF`` env override)
so the gated ratio does not depend on where it runs; the main comparison
deliberately runs in the ambient mode instead (``"auto"``: the roofline
mode, the cost model counted on ``meta``).

The policies' solves run inline in ``ClusterSim`` on the process-default
backend (``KUBEPACS_SOLVER_BACKEND``, the card's ``torch`` unless set).

Usage:
  python -m repro_torch.benchmarks.bench_serve [--smoke] [--json PATH]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import platform
import time
from typing import List, Optional

import numpy as np

from ..serve_sim import (WorkloadSpec, build_serve_scenario, clear_caches,
                         run_serving, trace_digest)
from ..serve_sim.perf_model import ENV_MODE

#: acceptance bar: serving_slo ≥ 1.2× SLO-served QPS-hours per
#: dollar over karpenter_like on the diurnal scenario, at equal-or-better
#: SLO attainment
TARGET_SLO_QPS_RATIO = 1.2

POLICIES = ("serving_slo", "karpenter_like", "kubepacs",
            "fixed_alpha:0.5", "kubepacs_risk")
#: the workloads of the full run (``diurnal`` alone at ``--smoke``) and
#: the horizon of a run
KINDS = ("diurnal", "bursty", "flash")
DURATION_HOURS = 24.0
SMOKE_DURATION_HOURS = 12.0

#: ratio denominators are floored so one pathological karpenter run (zero
#: SLO-served traffic) reports a huge finite ratio instead of inf/NaN
_DENOM_FLOOR = 1e-9


@contextlib.contextmanager
def _pinned_mode(mode: str):
    """Temporarily pin the perf-model mode (policy + staffing + report all
    resolve ``default_profile`` → the env override)."""
    old = os.environ.get(ENV_MODE)
    os.environ[ENV_MODE] = mode
    clear_caches()           # tables keyed by mode-inclusive digest anyway;
    try:                     # cleared so counters reflect this block only
        yield
    finally:
        if old is None:
            del os.environ[ENV_MODE]
        else:
            os.environ[ENV_MODE] = old


def _run_policy(kind: str, policy: str, duration_hours: float) -> tuple:
    ss = build_serve_scenario(kind, policy=policy,
                              duration_hours=duration_hours)
    t0 = time.perf_counter()
    report = run_serving(ss, clock=lambda: 0.0)
    return report, time.perf_counter() - t0


def _determinism_check(duration_hours: float) -> bool:
    """Same seed ⇒ byte-identical trace digest; same scenario ⇒ identical
    serving report (policies are replay-RNG-free, the table is digest-
    cached, and the integration is exact)."""
    spec = WorkloadSpec(kind="diurnal", seed=123)
    if trace_digest(spec) != trace_digest(WorkloadSpec(kind="diurnal",
                                                       seed=123)):
        return False
    a, _ = _run_policy("diurnal", "serving_slo", duration_hours)
    b, _ = _run_policy("diurnal", "serving_slo", duration_hours)
    return a.as_dict() == b.as_dict()


def _compare(kind: str, policies, duration_hours: float) -> dict:
    rows = {}
    for policy in policies:
        report, wall = _run_policy(kind, policy, duration_hours)
        d = report.as_dict()
        d["wall_s"] = round(wall, 3)
        rows[policy] = d
    return rows


def run(smoke: bool = False, json_path: Optional[str] = None) -> dict:
    duration = SMOKE_DURATION_HOURS if smoke else DURATION_HOURS
    kinds = ("diurnal",) if smoke else KINDS

    if not _determinism_check(duration):
        raise AssertionError(
            "serving co-sim is not deterministic: same seed produced a "
            "different trace digest or serving report — refusing to "
            "benchmark a non-reproducible run")

    comparisons = {kind: _compare(kind, POLICIES, duration)
                   for kind in kinds}

    slo = comparisons["diurnal"]["serving_slo"]
    karp = comparisons["diurnal"]["karpenter_like"]
    if slo["infeasible_decisions"]:
        raise AssertionError(
            f"serving_slo hit {slo['infeasible_decisions']} SLO-mask "
            "infeasibilities on the pinned market — the mask is "
            "over-constraining the ILP (acceptance: zero)")
    ratio = slo["slo_qps_hours_per_dollar"] / max(
        karp["slo_qps_hours_per_dollar"], _DENOM_FLOOR)
    attainment_ok = slo["slo_attainment"] >= karp["slo_attainment"] - 1e-9

    out = {
        "benchmark": "bench_serve",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "perf_mode": slo["perf_mode"],
        "duration_hours": duration,
        "slo_ms": slo["slo_ms"],
        "workload_digest": slo["workload_digest"],
        "determinism_checked": True,
        "target_slo_qps_ratio": TARGET_SLO_QPS_RATIO,
        "comparisons": comparisons,
        "headline": {
            "serve_qps_per_dollar_ratio": round(ratio, 3),
            "serving_slo_attainment": round(slo["slo_attainment"], 4),
            "karpenter_attainment": round(karp["slo_attainment"], 4),
            "attainment_ok": attainment_ok,
            "serving_slo_qps_per_dollar":
                round(slo["slo_qps_hours_per_dollar"], 2),
            "karpenter_slo_qps_per_dollar":
                round(karp["slo_qps_hours_per_dollar"], 2),
            "infeasible_decisions": slo["infeasible_decisions"],
            "meets_target": (ratio >= TARGET_SLO_QPS_RATIO
                             and attainment_ok),
        },
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def gate_measurement(repeat: int = 1) -> dict:
    """The :mod:`.perf_gate` metrics, pinned to the analytic perf-model
    mode so the ratio does not depend on where it runs (mode changes pod
    counts and absolute latencies; the gate must not see that as a
    regression).  ``repeat`` is accepted for signature parity
    with the other gate measurements — the serving ratio is exact
    (integral of deterministic step functions), not a timing, so one run
    suffices."""
    with _pinned_mode("analytic"):
        determinism_ok = _determinism_check(SMOKE_DURATION_HOURS)
        rows = _compare("diurnal", ("serving_slo", "karpenter_like"),
                        SMOKE_DURATION_HOURS)
    slo, karp = rows["serving_slo"], rows["karpenter_like"]
    ratio = slo["slo_qps_hours_per_dollar"] / max(
        karp["slo_qps_hours_per_dollar"], _DENOM_FLOOR)
    return {
        "serve_qps_per_dollar_ratio": round(ratio, 3),
        "attainment_ok": (slo["slo_attainment"]
                          >= karp["slo_attainment"] - 1e-9),
        "infeasible_free": slo["infeasible_decisions"] == 0,
        "determinism_ok": determinism_ok,
        "serving_slo_attainment": round(slo["slo_attainment"], 4),
    }


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="diurnal only, 12 h horizon (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, json_path=args.json or None)
    h = out["headline"]
    detail = (f"mode={out['perf_mode']}"
              f";slo_qps_ratio={h['serve_qps_per_dollar_ratio']}x"
              f";att={h['serving_slo_attainment']}"
              f"vs{h['karpenter_attainment']}"
              f";infeasible={h['infeasible_decisions']}"
              f";target>={out['target_slo_qps_ratio']}x:"
              f"{'met' if h['meets_target'] else 'MISSED'}")
    wall = out["comparisons"]["diurnal"]["serving_slo"]["wall_s"]
    print(f"bench_serve,{round(wall * 1e6)},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
