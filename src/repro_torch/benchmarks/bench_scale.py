"""Demand-scale sweep: one provisioning decision from 5 k to 1 M pods
through the coarsening ladder (DESIGN.md §14).

The market is the ``high_demand_scenario`` shape — a generated catalog
with quarter-vCPU / quarter-GiB pods, so every offering's pod count is
``4·vCPU`` and the compiled market's ``pods_gcd`` is 8 — grown to 1600
offerings (≈1.64 M pod capacity) so the 1 M-pod row is feasible.  Each
row times a *full bracketed-GSS decision* (9-α prescan + golden
refinement, the paper's decision unit) with the default
:class:`~repro_torch.core.CoarseningConfig`, which lands on

  * the **exact** tier below the 8192-pod residual threshold (every row
    at 5 k demand — byte-identical to the uncoarsened engine),
  * the **gcd** tier while ``residual/8 ≤ max_rows`` (provably exact),
  * the certified **approx** tier above that (greedy rate-order prefix +
    exact DP over the boundary residual window, a-posteriori LP gap
    certificate, automatic exact fallback on violation).

Honesty rails baked into the record:

  * *in-bench verification* — at every scale where the exact engine is
    still cheap (≤ ``VERIFY_MAX``), each prescan α is re-solved with
    coarsening disabled: exact/gcd rows must match **bitwise** and
    approx rows must sit inside their own certificate (and inside
    ``rel_gap`` of the true optimum).  The sweep refuses to time an
    unverified ladder.  These per-α solves, and the tier column, run on
    the process-default backend (``KUBEPACS_SOLVER_BACKEND``, the card's
    ``torch`` unless set), handed to ``solve_ilp`` explicitly;
  * the *exact-engine wall* is recorded alongside at the overlapping
    scales, so the speedup column is measured, not extrapolated (the
    1 M exact decision is only timed under ``--full-exact``);
  * the fused device plane (``torch:fused`` on the card, or
    ``torch:fused:cpu`` under ``device="cpu"`` / ``--device cpu``; with
    no device named it follows the process default) is always timed: it
    accepts exact/gcd-regime batches on the device and *declines*
    approx-regime batches to its per-dispatch path by design.  The record
    names it (``backend``) and where it ran (``device``).

Headline: ``scale_ratio_1m_vs_5k`` — the 1 M-pod decision wall over the
5 k-pod wall on the best backend.  The acceptance bar is ≤ 2.0.

Usage:
  python -m repro_torch.benchmarks.bench_scale [--smoke] [--json PATH]
      [--repeat N] [--full-exact] [--device cuda|cpu]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import (CoarseningConfig, DEFAULT_COARSENING, NumpyBackend,
                    Request, bracketed_gss_many, compile_market,
                    generate_catalog, get_backend, make_backend, preprocess,
                    solve_ilp)
from .common import device_line, device_specs

#: acceptance bar: the 1M-pod decision within 2x of the 5k wall
TARGET_RATIO = 2.0
SCALES = (5_000, 20_000, 50_000, 200_000, 1_000_000)
SMOKE_SCALES = (5_000, 20_000, 1_000_000)
#: largest demand the exact engine is re-run at for in-bench verification
#: and the measured (not extrapolated) exact-wall column
VERIFY_MAX = 50_000
PRESCAN_GRID = tuple(i / 8 for i in range(9))
EXACT = CoarseningConfig(enabled=False)
TOLERANCE = 0.01

_fake_timer = lambda: 0.0                                  # noqa: E731


#: the high-demand pod: a quarter vCPU and a quarter GiB, so every
#: offering's pod count is ``4·vCPU`` and ``pods_gcd`` is 8
POD_SHAPE = dict(cpu_per_pod=0.25, mem_per_pod=0.25)


def build_catalog(max_offerings: int = 1600, seed: int = 17):
    """The generated catalog the market is cut from."""
    return generate_catalog(seed=seed, max_offerings=max_offerings)


def build_market(max_offerings: int = 1600, seed: int = 17):
    """The high-demand market family at benchmark size: quarter-vCPU
    pods (pods_gcd = 8) over a generated catalog big enough that the
    1 M-pod row is feasible."""
    items = preprocess(build_catalog(max_offerings, seed),
                       Request(pods=5_000, **POD_SHAPE))
    return items, compile_market(items)


# ---------------------------------------------------------------------------
# In-bench verification: the ladder against the exact engine
# ---------------------------------------------------------------------------

def verify_scale(market, demand: int,
                 alphas: Sequence[float] = PRESCAN_GRID,
                 backend=None) -> Dict:
    """Cross-validate every coarse tier against the uncoarsened engine at
    one demand: exact/gcd/fallback rows bitwise-identical, approx rows
    inside their own a-posteriori certificate *and* inside ``rel_gap`` of
    the true optimum.  Raises on any violation — the sweep must not time
    a ladder it cannot verify.  Solves on ``backend`` (``None``: the
    process default)."""
    backend = backend or get_backend()
    tiers: Dict[str, int] = {}
    max_true_gap = 0.0
    for alpha in alphas:
        pc, sc = solve_ilp(market.items, demand, alpha, return_stats=True,
                           market=market, backend=backend,
                           coarsening=DEFAULT_COARSENING)
        pe, se = solve_ilp(market.items, demand, alpha, return_stats=True,
                           market=market, backend=backend, coarsening=EXACT)
        assert (pc is None) == (pe is None), (demand, alpha)
        if pc is None:
            tiers["infeasible"] = tiers.get("infeasible", 0) + 1
            continue
        tiers[sc.coarse] = tiers.get(sc.coarse, 0) + 1
        if sc.coarse in ("exact", "gcd", "approx_fallback"):
            if pc != pe:
                raise AssertionError(
                    f"{sc.coarse} tier not bitwise at demand={demand} "
                    f"alpha={alpha}")
        else:                                  # certified approx tier
            true_gap = sc.objective - se.objective
            bound = sc.gap_bound + 1e-6 * max(1.0, abs(se.objective))
            rel = (DEFAULT_COARSENING.rel_gap * max(abs(se.objective), 1e-9)
                   + 1e-9)
            if not (true_gap <= bound and true_gap <= rel):
                raise AssertionError(
                    f"approx certificate violated at demand={demand} "
                    f"alpha={alpha}: true_gap={true_gap} "
                    f"cert={sc.gap_bound} rel_budget={rel}")
            max_true_gap = max(max_true_gap, true_gap)
        covered = sum(int(c) * it.pods
                      for c, it in zip(pc, market.items))
        assert covered >= demand, (demand, alpha, covered)
    return {"demand": demand, "alphas": len(alphas), "tiers": tiers,
            "max_true_gap": round(max_true_gap, 9), "verified": True}


# ---------------------------------------------------------------------------
# Timed sweep
# ---------------------------------------------------------------------------

def _interleaved(fns: Dict[str, callable], repeat: int) -> Dict[str, float]:
    """min-of-N wall per contender, visit order rotated each round (same
    thermal-drift rationale as bench_backend)."""
    names = list(fns)
    best = {k: float("inf") for k in names}
    for r in range(repeat):
        order = names[r % len(names):] + names[: r % len(names)]
        for k in order:
            t0 = time.perf_counter()
            fns[k]()
            best[k] = min(best[k], time.perf_counter() - t0)
    return best


def _gss(items, market, demand: int, backend, cfg) -> Optional[object]:
    out = bracketed_gss_many(items, [demand], tolerance=TOLERANCE,
                             market=market, timer=_fake_timer,
                             backend=backend, coarsening=cfg)
    return out[0][0]


def _tier_column(market, demand: int, backend) -> Dict:
    """Which ladder rung each prescan α lands on (stats only, no timing)."""
    tiers: Dict[str, int] = {}
    max_cert = 0.0
    for alpha in PRESCAN_GRID:
        _, st = solve_ilp(market.items, demand, alpha, return_stats=True,
                          market=market, backend=backend,
                          coarsening=DEFAULT_COARSENING)
        tiers[st.coarse] = tiers.get(st.coarse, 0) + 1
        max_cert = max(max_cert, st.gap_bound)
    return {"tiers": tiers, "max_gap_certificate": round(max_cert, 9)}


def bench_scales(scales: Sequence[int] = SCALES, *, repeat: int = 3,
                 full_exact: bool = False,
                 max_offerings: int = 1600,
                 device=None) -> Tuple[List[Dict], Dict, Dict]:
    """The sweep: per scale, one full bracketed-GSS decision timed
    interleaved per backend under the default ladder; the exact engine
    timed alongside up to ``VERIFY_MAX`` (or everywhere with
    ``full_exact``); verification run before any timing.  Returns the
    rows, the market's description and the fused leg's (its spec, the
    device it ran on, its fused records and fallback solves)."""
    items, market = build_market(max_offerings=max_offerings)
    backend = get_backend()
    numpy_be = NumpyBackend()
    fused_be = make_backend(device_specs(device)[1])

    rows: List[Dict] = []
    for demand in scales:
        row: Dict = {"pods": demand, **_tier_column(market, demand, backend)}
        if demand <= VERIFY_MAX:
            row["verify"] = verify_scale(market, demand, backend=backend)
        # equality gate across backends before timing
        pool_n = _gss(items, market, demand, numpy_be, DEFAULT_COARSENING)
        fns = {"numpy": lambda: _gss(items, market, demand, numpy_be,
                                     DEFAULT_COARSENING)}
        pool_f = _gss(items, market, demand, fused_be,
                      DEFAULT_COARSENING)          # warm (library, upload)
        row["fused_selection_equal_numpy"] = (
            (pool_n is None) == (pool_f is None)
            and (pool_n is None or pool_n.as_dict() == pool_f.as_dict()))
        if not row["fused_selection_equal_numpy"]:
            raise AssertionError(
                f"fused selection diverged at demand={demand}")
        fns["fused"] = lambda: _gss(items, market, demand, fused_be,
                                    DEFAULT_COARSENING)
        if full_exact or demand <= VERIFY_MAX:
            fns["exact_numpy"] = lambda: _gss(items, market, demand,
                                              numpy_be, EXACT)
        best = _interleaved(fns, repeat)
        for name, wall in best.items():
            row[f"{name}_wall_s"] = round(wall, 4)
        row["best_wall_s"] = round(
            min(w for k, w in best.items() if k != "exact_numpy"), 4)
        if "exact_numpy" in best:
            row["coarse_speedup_vs_exact"] = round(
                best["exact_numpy"] / row["best_wall_s"], 2)
        rows.append(row)

    meta = {"n_items": market.n, "pods_gcd": int(market.pods_gcd),
            "capacity_pods": int(np.sum(market.pods * market.bound)),
            "max_offerings": max_offerings,
            "coarsening": {"threshold": DEFAULT_COARSENING.threshold,
                           "max_rows": DEFAULT_COARSENING.max_rows,
                           "window": DEFAULT_COARSENING.approx_rows,
                           "rel_gap": DEFAULT_COARSENING.rel_gap}}
    fused = {"backend": fused_be.name, "device": device_line(fused_be),
             "fused_records": fused_be.fused_records,
             "fused_fallback_solves":
                 fused_be.device_cache_info()["fallback_solves"]}
    return rows, meta, fused


def gate_measurement(repeat: int = 3) -> Dict:
    """The cheap perf-gate slice: the 1 M vs 5 k decision-wall ratio on
    the host engine plus a bitwise gcd-tier spot check on the process
    default (:mod:`.perf_gate` gates the ratio inside a tolerance band)."""
    items, market = build_market()
    numpy_be = NumpyBackend()
    gcd_ok = True
    try:
        verify_scale(market, 20_000, alphas=(0.0, 0.125))
    except AssertionError:
        gcd_ok = False
    best = _interleaved(
        {"w5k": lambda: _gss(items, market, 5_000, numpy_be,
                             DEFAULT_COARSENING),
         "w1m": lambda: _gss(items, market, 1_000_000, numpy_be,
                             DEFAULT_COARSENING)}, repeat)
    return {"ratio": round(best["w1m"] / best["w5k"], 2),
            "wall_5k_s": round(best["w5k"], 4),
            "wall_1m_s": round(best["w1m"], 4),
            "gcd_bitwise_ok": gcd_ok}


def run(smoke: bool = False, json_path: Optional[str] = None,
        repeat: Optional[int] = None, full_exact: bool = False,
        device=None) -> Dict:
    scales = SMOKE_SCALES if smoke else SCALES
    rows, meta, fused = bench_scales(
        scales, repeat=repeat or (1 if smoke else 3), full_exact=full_exact,
        device=device)
    by_pods = {r["pods"]: r for r in rows}
    ratio = round(by_pods[1_000_000]["best_wall_s"]
                  / by_pods[5_000]["best_wall_s"], 2)
    verified = [r["pods"] for r in rows if r.get("verify")]
    out = {
        "benchmark": "bench_scale",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "market": meta,
        **fused,
        "scales": rows,
        "headline": {
            "scale_ratio_1m_vs_5k": ratio,
            "meets_2x_target": ratio <= TARGET_RATIO,
            "verified_scales": verified,
            "coarse_speedup_vs_exact_50k":
                by_pods.get(50_000, {}).get("coarse_speedup_vs_exact"),
        },
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="3 scales, 1 timing round (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    ap.add_argument("--repeat", type=int, default=None,
                    help="interleaved timing rounds (default 3; 1 smoke)")
    ap.add_argument("--full-exact", action="store_true",
                    help="also time the exact engine above VERIFY_MAX "
                         "(the 1M exact decision takes minutes)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the fused leg runs (default: the process "
                         "default backend's device, else the card)")
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, json_path=args.json or None,
              repeat=args.repeat, full_exact=args.full_exact,
              device=args.device)
    h = out["headline"]
    w1m = next(r for r in out["scales"] if r["pods"] == 1_000_000)
    detail = (f"ratio_1m_vs_5k:{h['scale_ratio_1m_vs_5k']}x"
              f";meets_2x:{h['meets_2x_target']}"
              f";verified:{h['verified_scales']}"
              f";1m_best:{w1m['best_wall_s']}s")
    print(f"bench_scale,{round(w1m['best_wall_s'] * 1e6)},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
