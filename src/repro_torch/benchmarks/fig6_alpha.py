"""Fig. 6: E_Total(α) landscape + GSS exploration across independent runs.

Claims: concave rise-then-step-down; optimizing α beats the α=0 cost-only
baseline (paper: avg +6%, up to +81%).  The 21-point landscape per snapshot
is one :func:`solve_ilp_batch` vectorized DP against a market compiled once
and shared with the guarded GSS (DESIGN.md §8)."""

import numpy as np

from ..core import (Request, SpotMarketSimulator, compile_market, e_total,
                    get_backend, preprocess, score_counts_batch,
                    solve_ilp_batch)
from ..core.gss import bracketed_gss

from . import common


def run(cat=None, runs: int = 8):
    cat = cat or common.catalog()
    sim = SpotMarketSimulator(cat, seed=0)
    req = Request(pods=100, cpu_per_pod=2, mem_per_pod=2)
    gains, peak_alphas, wall = [], [], 0.0
    grid = [i / 20 for i in range(21)]
    curves = []
    backend = get_backend()
    for _ in range(runs):
        snap = sim.snapshot()
        items = preprocess(snap, req)
        market = compile_market(items)
        batch = solve_ilp_batch(items, req.pods, grid, market=market,
                                backend=backend)
        curve = score_counts_batch(items, batch, req.pods,
                                   arrays=market.metric_arrays)
        curves.append(curve)
        pool, trace = bracketed_gss(items, req.pods, tolerance=0.01,
                                    market=market, backend=backend)
        wall += trace.wall_seconds
        e_star = e_total(pool, req.pods)
        gains.append(e_star / max(curve[0], 1e-12) - 1)
        peak_alphas.append(pool.alpha)
        sim.step(6.0)
    curves = np.array(curves)
    # step-down check: the mean curve's tail is far below its peak
    mean_curve = curves.mean(axis=0)
    return {
        "avg_gain_over_alpha0_pct": 100 * float(np.mean(gains)),
        "max_gain_over_alpha0_pct": 100 * float(np.max(gains)),
        "mean_peak_alpha": float(np.mean(peak_alphas)),
        "tail_over_peak": float(mean_curve[-1] / mean_curve.max()),
        "us_per_call": wall / runs * 1e6,
    }


def main():
    out = run()
    print(f"fig6_alpha,{out['us_per_call']:.0f},"
          f"gain_over_alpha0_avg=+{out['avg_gain_over_alpha0_pct']:.1f}%;"
          f"max=+{out['max_gain_over_alpha0_pct']:.1f}%;"
          f"peak_alpha={out['mean_peak_alpha']:.3f};"
          f"tail/peak={out['tail_over_peak']:.4f}")
    return out


if __name__ == "__main__":
    main()
