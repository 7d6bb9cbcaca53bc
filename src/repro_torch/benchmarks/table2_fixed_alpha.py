"""Table 2: normalized E_Total of Greedy / fixed α ∈ {0, 0.5, 1} vs GSS.

The three fixed-α solves ride one :func:`solve_ilp_batch` pass on a market
compiled once per scenario and shared with the guarded GSS."""

import numpy as np

from ..core import (Request, compile_market, e_total, get_backend,
                    kubepacs_greedy, preprocess, score_counts_batch,
                    solve_ilp_batch)
from ..core.gss import bracketed_gss

from . import common

FIXED_ALPHAS = (0.0, 0.5, 1.0)


def run(cat=None):
    cat = cat or common.catalog()
    rows = []
    wall = 0.0
    backend = get_backend()
    for pods, cpu, mem in [(50, 1, 2), (100, 2, 2), (400, 1, 4)]:
        req = Request(pods=pods, cpu_per_pod=cpu, mem_per_pod=mem)
        items = preprocess(cat, req)
        market = compile_market(items)
        pool, trace = bracketed_gss(items, req.pods, tolerance=0.01,
                                    market=market, backend=backend)
        wall += trace.wall_seconds
        base = e_total(pool, req.pods)
        row = {"ours": 1.0,
               "greedy": e_total(kubepacs_greedy(items, pods), pods) / base}
        batch = solve_ilp_batch(items, pods, FIXED_ALPHAS, market=market,
                                backend=backend)
        fixed_scores = score_counts_batch(items, batch, pods,
                                          arrays=market.metric_arrays)
        for a, score in zip(FIXED_ALPHAS, fixed_scores):
            row[f"alpha_{a}"] = score / base
        rows.append(row)
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    mean["us_per_call"] = wall / 3 * 1e6
    return mean


def main():
    out = run()
    print(f"table2_fixed_alpha,{out['us_per_call']:.0f},"
          f"greedy={out['greedy']:.4f};alpha0={out['alpha_0.0']:.4f};"
          f"alpha0.5={out['alpha_0.5']:.6f};alpha1={out['alpha_1.0']:.6f};"
          f"ours={out['ours']:.1f}")
    return out


if __name__ == "__main__":
    main()
