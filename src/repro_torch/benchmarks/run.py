"""One function per paper table/figure. Prints ``name,us_per_call,derived`` CSV.

Usage:
  python -m repro_torch.benchmarks.run                    # full sweep
  python -m repro_torch.benchmarks.run --only fig7_tolerance
  python -m repro_torch.benchmarks.run --only bench_solver --json out.json

Every solve runs on the process-default backend
(``KUBEPACS_SOLVER_BACKEND``, the card's ``torch`` unless set; on a host
without a card name ``torch:cpu``, ``torch:fused:cpu`` or ``numpy``).
``--json`` writes every driver's returned record to PATH, beside the
backend's spec (``backend``) and the card it ran on (``device``: the
``nvidia-smi --query-gpu=name,power.limit`` line, or ``"cpu"``).
bench_backend's and bench_scale's device legs and elastic_training's
model follow the process default's device (the CPU under ``torch:cpu``
/ ``torch:fused:cpu``, the card otherwise).
"""
import argparse
import json
import sys
import traceback

from ..core import get_backend
from . import (bench_backend, bench_chaos, bench_fleet, bench_region,
               bench_risk, bench_scale, bench_serve, bench_solver,
               elastic_training, fig5_sota, fig5c_spotkube, fig6_alpha,
               fig6b_cross_provider, fig7_tolerance, fig8_preferences,
               fig9_t3_fulfillment, fig12_interrupts, roofline_report,
               table2_fixed_alpha, table3_perf_dollar)
from .common import device_line

ALL = [
    ("fig5_sota", fig5_sota),
    ("fig5c_spotkube", fig5c_spotkube),
    ("fig6_alpha", fig6_alpha),
    ("fig6b_cross_provider", fig6b_cross_provider),
    ("table2_fixed_alpha", table2_fixed_alpha),
    ("fig7_tolerance", fig7_tolerance),
    ("fig8_preferences", fig8_preferences),
    ("fig9_t3_fulfillment", fig9_t3_fulfillment),
    ("fig12_interrupts", fig12_interrupts),
    ("table3_perf_dollar", table3_perf_dollar),
    ("bench_solver", bench_solver),
    ("bench_backend", bench_backend),
    ("bench_scale", bench_scale),
    ("bench_risk", bench_risk),
    ("bench_fleet", bench_fleet),
    ("bench_serve", bench_serve),
    ("bench_chaos", bench_chaos),
    ("bench_region", bench_region),
    ("elastic_training", elastic_training),
    ("roofline_report", roofline_report),
]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--only", default=None, metavar="NAME",
                    help="run a single figure/table/benchmark by name")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write every driver's returned record to PATH")
    args = ap.parse_args(argv)

    selected = ALL
    if args.only is not None:
        selected = [(n, m) for n, m in ALL if n == args.only]
        if not selected:
            names = ", ".join(n for n, _ in ALL)
            print(f"unknown benchmark {args.only!r}; choose from: {names}",
                  file=sys.stderr)
            sys.exit(2)

    print("name,us_per_call,derived")
    records = {}
    failures = 0
    for name, mod in selected:
        try:
            records[name] = mod.main()
        except Exception:                      # noqa: BLE001
            failures += 1
            traceback.print_exc()
            print(f"{name},0,FAILED")
            records[name] = {"status": "failed"}
    if args.json:
        backend = get_backend()
        records["backend"] = backend.name
        records["device"] = device_line(backend)
        with open(args.json, "w") as f:
            json.dump(records, f, indent=2, default=str)
    if failures:
        sys.exit(1)


if __name__ == "__main__":
    main()
