"""Fig. 6b: cross-provider generalization — the same ILP×GSS pipeline on an
Azure-like market (different price anchors, sparser SPS coverage: the paper
reports only 17.9% of Azure candidates kept consistently-valid SPS and
~15% lower absolute E_Total; the concave α landscape is preserved)."""

import numpy as np

from ..core import (Request, compile_market, e_total, generate_catalog,
                    get_backend, preprocess, score_counts_batch,
                    solve_ilp_batch)
from ..core.gss import bracketed_gss


def azure_like_catalog(seed: int = 42):
    """Azure-flavoured market: different od anchors, ~18% SPS coverage."""
    cat = generate_catalog(seed=seed, regions=("eastus", "westeurope"))
    rng = np.random.default_rng(seed)
    out = []
    for o in cat:
        keep_sps = rng.random() < 0.179       # paper: 17.9% valid SPS
        out.append(o.__class__(**{
            **o.__dict__,
            "od_price": round(o.od_price * 1.07, 4),   # Azure od premium
            "t3": o.t3 if keep_sps else 0,             # invalid SPS -> unusable
        }))
    return out


def run():
    req = Request(pods=100, cpu_per_pod=2, mem_per_pod=2)
    results = {}
    backend = get_backend()
    for name, cat in (("aws", generate_catalog(seed=42)),
                      ("azure", azure_like_catalog(seed=42))):
        items = preprocess(cat, req)
        market = compile_market(items)
        pool, trace = bracketed_gss(items, req.pods, tolerance=0.01,
                                    market=market, backend=backend)
        grid = [i / 10 for i in range(11)]
        batch = solve_ilp_batch(items, req.pods, grid, market=market,
                                backend=backend)
        curve = score_counts_batch(items, batch, req.pods,
                                   arrays=market.metric_arrays)
        peak = int(np.argmax(curve))
        results[name] = {
            "e_total": e_total(pool, req.pods),
            "candidates": len(items),
            "concave": bool(curve[peak] >= curve[0] - 1e-9
                            and curve[-1] < 0.05 * max(curve[peak], 1e-9)),
            "wall_s": trace.wall_seconds,
        }
    results["azure_over_aws"] = (results["azure"]["e_total"]
                                 / results["aws"]["e_total"])
    results["us_per_call"] = results["aws"]["wall_s"] * 1e6
    return results


def main():
    out = run()
    print(f"fig6b_cross_provider,{out['us_per_call']:.0f},"
          f"aws_candidates={out['aws']['candidates']};"
          f"azure_candidates={out['azure']['candidates']};"
          f"both_concave={out['aws']['concave'] and out['azure']['concave']};"
          f"azure/aws_E={out['azure_over_aws']:.3f}")
    return out


if __name__ == "__main__":
    main()
