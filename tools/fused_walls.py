#!/usr/bin/env python3
"""Host walls of the fused decision plane's main path on one card, for
timing two trees in turns.

Times, through ``torch:fused`` as ``chip_smoke.py`` phase 6 drives them,
``provision()`` at 1000 and 5000 pods on the full catalog (one provisioner
a size, as phase 6 keeps one) and the two fleet ticks of phase 4 (100
items x 1000 pods and 250 items x 5000 pods, 32 decisions of +-15%, a fresh
``SolveBatch`` a call), each ``--reps`` times after one warm-up call, with
``gc.collect()`` before each metric. Prints each metric's walls and
median, and, last, one JSON line of the medians.

``--tree DIR`` imports the package of another checkout (its ``src/``), so
that one copy of this script times a parent and a change in turns, each
tree building its own kernels into its own ``build/kernels/``:

    python3 tools/fused_walls.py --tree build/parent
    python3 tools/fused_walls.py --tree .

Needs one CUDA card and ``nvcc``; exits 2 without CUDA.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np


def fake_timer() -> float:
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="checkout whose src/ to time")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("fused_walls: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    from repro_torch.core import (KubePACSProvisioner, Request, SolveBatch,
                                  compile_market, cuda_lib, generate_catalog,
                                  make_backend, preprocess)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    cuda_lib.library()
    catalog = generate_catalog(seed=0)
    big = generate_catalog(seed=0, max_offerings=2000)

    def tick(items, market, demands):
        prov = KubePACSProvisioner(timer=fake_timer)
        prov.solve_batch = SolveBatch("torch:fused")
        toks = [prov.provision(Request(pods=r, cpu_per_pod=2, mem_per_pod=2),
                               big, precompiled=(items, market))
                for r in demands]
        prov.solve_batch.execute()
        return [t.resolve() for t in toks]

    metrics = {}
    for pods in (1000, 5000):
        req = Request(pods=pods, cpu_per_pod=2, mem_per_pod=2,
                      workload={"network"})
        prov = KubePACSProvisioner(timer=fake_timer,
                                   backend=make_backend("torch:fused"))
        metrics[f"provision {pods}"] = (
            lambda p=prov, r=req: p.provision(r, catalog))
    for n_items, base in ((100, 1000), (250, 5000)):
        items = preprocess(big, Request(pods=base, cpu_per_pod=2,
                                        mem_per_pod=2))[:n_items]
        market = compile_market(items)
        jr = np.random.default_rng(0)
        demands = [int(base * (1 + 0.15 * (2 * jr.random() - 1)))
                   for _ in range(32)]
        metrics[f"fleet tick {n_items}x{base}"] = (
            lambda a=(items, market, demands): tick(*a))
    medians = {}
    for name, fn in metrics.items():
        fn()                                            # warm-up
        gc.collect()
        walls = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        medians[name] = float(np.median(walls))
        print(f"fused_walls {name}: median {medians[name]:.3f} ms of "
              + " ".join(f"{w:.3f}" for w in walls))
    print(json.dumps({"tree": args.tree, "medians_ms": medians}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
