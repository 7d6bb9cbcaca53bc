"""Quickstart: provision a performant/available/cost-efficient spot node pool
with KubePACS and inspect the decision.

    PYTHONPATH=src python -m repro_torch.examples.quickstart

The solves run on the process-default backend: the card unless
``KUBEPACS_SOLVER_BACKEND`` names another (``torch:cpu`` on a host).
"""

import argparse

from ..core import (KubePACSProvisioner, Request, e_total, generate_catalog,
                    kubepacs_greedy, preprocess, spotverse)


def main(argv=None):
    argparse.ArgumentParser().parse_args(argv)      # no options

    # 1. market snapshot (offline stand-in for the SpotLake archive)
    catalog = generate_catalog(seed=0)
    print(f"catalog: {len(catalog)} offerings "
          f"({len({o.instance_type for o in catalog})} instance types, "
          f"{len({o.region for o in catalog})} regions)")

    # 2. the workload: 100 pods of 2 vCPU / 2 GiB, network-heavy
    request = Request(pods=100, cpu_per_pod=2, mem_per_pod=2,
                      workload={"network"})

    # 3. KubePACS: preprocessing -> ILP x GSS -> node pool
    provisioner = KubePACSProvisioner(tolerance=0.01)
    decision = provisioner.provision(request, catalog)
    pool = decision.pool
    print(f"\nKubePACS decision (alpha*={decision.alpha:.4f}, "
          f"{decision.trace.ilp_solves} ILP solves, "
          f"{decision.wall_seconds:.2f}s):")
    print(f"  nodes={pool.total_nodes}  pods={pool.total_pods} "
          f"(requested {request.pods})  cost=${pool.hourly_cost:.3f}/h")
    print(f"  E_PerfCost={decision.metrics['e_perf_cost']:.3e}  "
          f"E_OverPods={decision.metrics['e_over_pods']:.3f}  "
          f"E_Total={decision.metrics['e_total']:.3e}")
    for it, c in sorted(zip(pool.items, pool.counts),
                        key=lambda ic: -ic[1])[:8]:
        o = it.offering
        print(f"    {c:3d} x {o.instance_type:<18s} @{o.az}  "
              f"spot=${o.spot_price:.4f}  T3={o.t3}  {o.specialization}")

    # 4. the baselines it beats (Fig. 5)
    items = preprocess(catalog, request)
    for name, p in (("greedy", kubepacs_greedy(items, request.pods)),
                    ("spotverse-node", spotverse(items, request.pods, "node"))):
        print(f"  vs {name:15s}: E_Total ratio "
              f"{e_total(p, request.pods) / decision.metrics['e_total']:.3f}")


if __name__ == "__main__":
    main()
