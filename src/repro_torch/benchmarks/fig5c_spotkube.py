"""Fig. 5c: small-scale comparison vs SpotKube (NSGA-II, fixed 4 nodes per
selected type) on its original setup: pods 1–50 of (1 vCPU, 1 GiB), candidate
pool restricted to four instance types."""

import numpy as np

from ..core import (KubePACSProvisioner, Request, e_total, get_backend,
                    preprocess, restrict, spotkube)

from . import common


def run(cat=None):
    cat = cat or common.catalog()
    types = sorted({o.instance_type for o in cat
                    if o.vcpus <= 8})[:4]          # small types, like t3/c6a/...
    small = restrict(cat, instance_types=types)
    prov = KubePACSProvisioner(backend=get_backend())
    ratios, wall = [], 0.0
    for pods in (1, 5, 10, 20, 35, 50):
        req = Request(pods=pods, cpu_per_pod=1, mem_per_pod=1)
        items = preprocess(small, req)
        d = prov.provision(req, small)
        wall += d.wall_seconds
        sk = spotkube(items, pods, seed=0, population=32, generations=50)
        e_sk = e_total(sk, pods)
        if e_sk > 0:
            ratios.append(d.metrics["e_total"] / e_sk)
    return {"mean_ratio_vs_spotkube": float(np.mean(ratios)),
            "improvement_pct": 100 * (float(np.mean(ratios)) - 1),
            "us_per_call": wall / 6 * 1e6}


def main():
    out = run()
    print(f"fig5c_spotkube,{out['us_per_call']:.0f},"
          f"kubepacs_over_spotkube=+{out['improvement_pct']:.1f}%")
    return out


if __name__ == "__main__":
    main()
