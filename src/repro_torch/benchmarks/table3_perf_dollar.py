"""Table 3 + Fig. 11: performance-per-dollar of the selected instances on
compute-bound applications (compilation / video encoding / graph analytics),
where measured throughput scales with the CoreMark score — KubePACS picks
newer-generation hardware at slightly higher price, netting perf/$ gains."""

from ..core import (KubePACSProvisioner, Request, get_backend,
                    karpenter_like, preprocess)

from . import common

#: requests/min per unit of (BS_core·pods); calibrated so a c5.xlarge-class
#: node serves ~9 compile jobs/min, ~31 video encodes/min (Table 3)
APP_THROUGHPUT = {"compilation": 9 / 20_000.0, "video_enc": 31 / 20_000.0,
                  "pagerank": 2 / 20_000.0}


def _pool_stats(pool):
    perf = sum(it.bs * it.pods * c for it, c in zip(pool.items, pool.counts))
    cost = pool.hourly_cost
    return perf, cost


def run(cat=None):
    cat = cat or common.catalog()
    req = Request(pods=12, cpu_per_pod=4, mem_per_pod=8)   # one pod/instance
    items = preprocess(cat, req)
    prov = KubePACSProvisioner(backend=get_backend())
    ours = prov.provision(req, cat).pool
    karp = karpenter_like(items, req.pods)
    p_ours, c_ours = _pool_stats(ours)
    p_karp, c_karp = _pool_stats(karp)
    # the paper's currency: price per processed request = cost / throughput;
    # throughput scales with the pool's aggregate benchmark score
    out = {"us_per_call": 0.0}
    for app, k in APP_THROUGHPUT.items():
        rpm_ours = k * p_ours / max(ours.total_pods, 1) * req.pods
        rpm_karp = k * p_karp / max(karp.total_pods, 1) * req.pods
        ppr_ours = c_ours / max(rpm_ours * 60, 1e-9)
        ppr_karp = c_karp / max(rpm_karp * 60, 1e-9)
        out[app] = {
            "req_per_min_gain_pct": 100 * (rpm_ours / rpm_karp - 1),
            "price_per_req_reduction_pct": 100 * (1 - ppr_ours / ppr_karp),
        }
    out["perf_per_dollar_gain_pct"] = 100 * (
        (p_ours / c_ours) / (p_karp / c_karp) - 1)
    out["price_increase_pct"] = 100 * (c_ours / c_karp - 1)
    return out


def main():
    out = run()
    ve = out["video_enc"]
    print(f"table3_perf_dollar,0,"
          f"perf_per_dollar=+{out['perf_per_dollar_gain_pct']:.1f}%;"
          f"price_delta={out['price_increase_pct']:+.1f}%;"
          f"video_enc_price_per_req=-{ve['price_per_req_reduction_pct']:.1f}%;"
          f"compile_price_per_req=-"
          f"{out['compilation']['price_per_req_reduction_pct']:.1f}%")
    return out


if __name__ == "__main__":
    main()
