"""Minimal performance regression gate (the ReFrame pattern): re-run the
cheap backend-bench config, compare each metric against the checked-in
reference numbers in ``PERF_REFERENCE_torch.json`` with per-metric
tolerance bands, fail on regression, and append the measurement to a
trajectory file (``PERF_trajectory_torch.jsonl``) so drift is inspectable
across commits.  Both files sit at the repository root and are the
port's own: the reference package's gate keeps ``PERF_REFERENCE.json``
and ``PERF_trajectory.jsonl``.

Only *ratio* metrics are gated — speedups of one engine over another
measured interleaved in the same process — because absolute wall times
track the machine, not the code.  Correctness flags (selection equality,
zero fused fallbacks) are hard assertions, not bands.  The device legs
(``torch`` and ``torch:fused``) always run: on the card, or on the CPU
when the process default is ``torch:cpu`` / ``torch:fused:cpu``.  A
reference written with ``--update`` records the card it was measured on
(``device``: the ``nvidia-smi`` name and power limit, or ``"cpu"``).

Usage:
  python -m repro_torch.benchmarks.perf_gate            # gate
  python -m repro_torch.benchmarks.perf_gate --update   # refresh reference
  python -m repro_torch.benchmarks.perf_gate --smoke    # fewer decisions
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import platform
import sys
from typing import List, Optional

from .bench_backend import bench_tick
from .bench_chaos import gate_measurement as chaos_measurement
from .bench_region import gate_measurement as region_measurement
from .bench_scale import gate_measurement as scale_measurement
from .bench_serve import gate_measurement as serve_measurement

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
REFERENCE_PATH = os.path.join(ROOT, "PERF_REFERENCE_torch.json")
TRAJECTORY_PATH = os.path.join(ROOT, "PERF_trajectory_torch.jsonl")

#: gate config: the FleetSim-shaped fleet tick (100 items × 1 k pods) —
#: cheap enough for every run, and the regime the fused plane is built for
GATE_ITEMS = 100
GATE_PODS = 1000


def measure(n_dec: int, repeat: int = 3) -> dict:
    """One gate measurement: the ratio metrics + correctness flags."""
    rec = bench_tick(GATE_ITEMS, GATE_PODS, n_dec, repeat=repeat)
    metrics = {
        "batched_numpy_speedup_vs_pr1":
            rec["speedups_vs_pr1"]["batched_numpy"],
        "fused_vs_batched_numpy": rec["fused_vs_batched_numpy"],
        "fused_vs_per_dispatch_torch": round(
            rec["batched_torch_wall_s"] / rec["fused_torch_wall_s"], 2),
    }
    checks = {"pr1_equality": rec["equality_checked"],
              "fused_selections_equal_numpy":
                  rec["fused_torch_selections_equal_numpy"],
              "torch_selections_equal_numpy":
                  rec["batched_torch_selections_equal_numpy"],
              "fused_zero_fallbacks": rec["fused_fallback_solves"] == 0}
    # demand-coarsening ladder (DESIGN.md §14): the 1M-vs-5k decision-wall
    # ratio is the only lower-is-better metric in the gate (its reference
    # carries a *bounded* upper_tol) and the gcd tier must stay bitwise
    scale = scale_measurement(repeat=repeat)
    metrics["scale_1m_vs_5k_ratio"] = scale["ratio"]
    checks["scale_gcd_tier_bitwise"] = scale["gcd_bitwise_ok"]
    # serving co-simulation (DESIGN.md §15): SLO-served QPS-hours per
    # dollar, serving_slo over karpenter_like, pinned to the analytic
    # perf-model mode so the value does not depend on where it runs.  This
    # one is a *cost-efficiency* ratio, not a timing — it gates the
    # decision quality of the SLO-mask path, and its attainment/
    # infeasibility/determinism flags are hard correctness checks
    serve = serve_measurement(repeat=repeat)
    metrics["serve_qps_per_dollar_ratio"] = serve["serve_qps_per_dollar_ratio"]
    checks["serve_slo_attainment_ok"] = serve["attainment_ok"]
    checks["serve_zero_infeasible"] = serve["infeasible_free"]
    checks["serve_determinism"] = serve["determinism_ok"]
    # chaos hardening (DESIGN.md §16): SLO perf-per-dollar of the hardened
    # plane over the naive plane under the combined fault storm — another
    # cost-efficiency ratio (backend-bitwise).  Its availability/
    # determinism/inertness flags are hard correctness checks: a hardening
    # layer that drops decision cycles, breaks the trace contract, or
    # perturbs the fault-free path is a bug regardless of the ratio
    chaos = chaos_measurement(repeat=repeat)
    metrics["chaos_hardened_vs_naive_ratio"] = \
        chaos["chaos_hardened_vs_naive_ratio"]
    checks["chaos_availability_ok"] = chaos["availability_ok"]
    checks["chaos_determinism"] = chaos["determinism_ok"]
    checks["chaos_inert_when_healthy"] = chaos["inert_ok"]
    # multi-region failover (DESIGN.md §17): SLO perf-per-dollar of the
    # hardened plane with cross-region failover over the region-pinned
    # strawman through the correlated regional storm.  Its determinism
    # and single-region/identity-config inertness flags are hard checks:
    # a region layer that moves any bit of a region-free (or K=1, or
    # identity-config) run breaks the §9 contract regardless of the ratio
    region = region_measurement(repeat=repeat)
    metrics["region_failover_vs_pinned_ratio"] = \
        region["region_failover_vs_pinned_ratio"]
    checks["region_determinism"] = region["determinism_ok"]
    checks["region_single_region_inert"] = region["single_region_inert"]
    checks["region_identity_config_inert"] = \
        region["identity_config_inert"]
    raw = {k: v for k, v in rec.items()
           if k.endswith(("_wall_s", "_compile_s", "_ms_per_decision"))}
    raw["scale_wall_5k_s"] = scale["wall_5k_s"]
    raw["scale_wall_1m_s"] = scale["wall_1m_s"]
    raw["serve_slo_attainment"] = serve["serving_slo_attainment"]
    raw["chaos_hardened_availability"] = chaos["hardened_availability"]
    raw["region_hardened_demand_coverage"] = \
        region["hardened_demand_coverage"]
    return {"config": {"n_items": GATE_ITEMS, "base_pods": GATE_PODS,
                       "n_decisions": n_dec},
            "backend": rec["backend"], "device": rec["device"],
            "metrics": metrics, "checks": checks, "raw": raw}


def gate(measured: dict, reference: dict) -> List[str]:
    """ReFrame-style check: each measured metric must sit inside
    ``ref * (1 - lower_tol) .. ref * (1 + upper_tol)`` (upper_tol null =
    unbounded — being faster is never a regression).  Returns the list of
    failures (empty = pass)."""
    failures: List[str] = []
    for name, ok in measured["checks"].items():
        if not ok:
            failures.append(f"correctness check failed: {name}")
    for name, ref in reference["metrics"].items():
        got = measured["metrics"].get(name)
        if got is None:
            failures.append(f"metric missing from measurement: {name}")
            continue
        lo = ref["value"] * (1.0 - ref["lower_tol"])
        hi = (float("inf") if ref.get("upper_tol") is None
              else ref["value"] * (1.0 + ref["upper_tol"]))
        if not (lo <= got <= hi):
            failures.append(
                f"{name}: measured {got} outside "
                f"[{round(lo, 2)}, {round(hi, 2) if hi != float('inf') else 'inf'}] "
                f"(reference {ref['value']} -{ref['lower_tol'] * 100:.0f}%)")
    return failures


#: metrics where *larger* is the regression (everything else is a
#: higher-is-better speedup/efficiency ratio).  Explicit by name — a
#: suffix heuristic breaks on a higher-is-better ``*_ratio`` metric
#: (serve_qps_per_dollar_ratio)
LOWER_IS_BETTER = frozenset({"scale_1m_vs_5k_ratio"})


def _default_reference(measured: dict) -> dict:
    """References from a fresh measurement.  Bands are deliberately wide
    (-50 % on every speedup): the gate exists to catch the engine falling
    off a cliff (a lost device cache, a host round-trip creeping back into
    the golden loop), not to police scheduler noise on shared hosts.

    Higher-is-better metrics (speedups, QPS-per-dollar ratios) get
    upper_tol None (being faster/cheaper is never a regression).
    :data:`LOWER_IS_BETTER` metrics (the 1M-vs-5k scale ratio) get a
    *bounded* upper_tol instead — the ratio doubling over its reference
    means the coarsening ladder stopped absorbing the demand scale — and
    an unbounded lower side via lower_tol 1.0 (a cheaper 1M decision is
    never a regression)."""
    return {
        "benchmark": "perf_gate",
        "config": measured["config"],
        "machine": platform.machine(),
        "backend": measured["backend"],
        "device": measured["device"],
        "metrics": {
            name: ({"value": value, "lower_tol": 1.0, "upper_tol": 1.0}
                   if name in LOWER_IS_BETTER
                   else {"value": value, "lower_tol": 0.5,
                         "upper_tol": None})
            for name, value in measured["metrics"].items()
        },
    }


def run(update: bool = False, smoke: bool = False,
        repeat: int = 3) -> int:
    # references are only ever written under an explicit --update: a gate
    # that auto-refreshes on a missing reference is a silent no-op pass
    # (a deleted or unshipped reference would mask every regression), so
    # gate mode fails fast — before the measurement — when the file is
    # absent
    if not update and not os.path.exists(REFERENCE_PATH):
        print(f"perf_gate: FAILED — reference file missing: "
              f"{REFERENCE_PATH}")
        print("perf_gate: a gate without references cannot detect "
              "regressions; run `python -m repro_torch.benchmarks.perf_gate "
              "--update` on the card and commit the refreshed "
              "PERF_REFERENCE_torch.json")
        return 1
    n_dec = 4 if smoke else 8
    measured = measure(n_dec, repeat=repeat)
    entry = {
        "timestamp": datetime.datetime.now(
            datetime.timezone.utc).isoformat(timespec="seconds"),
        "python": platform.python_version(),
        **measured,
    }
    with open(TRAJECTORY_PATH, "a") as f:
        f.write(json.dumps(entry) + "\n")
    if update:
        with open(REFERENCE_PATH, "w") as f:
            json.dump(_default_reference(measured), f, indent=2)
        print(f"perf_gate: reference refreshed → {REFERENCE_PATH}")
        print(json.dumps(measured["metrics"], indent=2))
        return 0
    with open(REFERENCE_PATH) as f:
        reference = json.load(f)
    failures = gate(measured, reference)
    print(f"perf_gate: measured on {measured['device']} "
          f"({measured['backend']}); reference on "
          f"{reference.get('device', 'unknown')}")
    for name, value in sorted(measured["metrics"].items()):
        ref = reference["metrics"].get(name, {}).get("value")
        print(f"perf_gate: {name} = {value} (reference {ref})")
    for name, ok in sorted(measured["checks"].items()):
        print(f"perf_gate: check {name}: {'ok' if ok else 'FAILED'}")
    if failures:
        print("perf_gate: REGRESSION")
        for fail in failures:
            print(f"  - {fail}")
        return 1
    print("perf_gate: pass")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true",
                    help="refresh PERF_REFERENCE_torch.json from this run")
    ap.add_argument("--smoke", action="store_true",
                    help="fewer decisions")
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv if argv is not None else [])
    return run(update=args.update, smoke=args.smoke, repeat=args.repeat)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
