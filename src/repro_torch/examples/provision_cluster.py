"""Long-horizon provisioning session: a KubePACS-managed pool tracked over a
simulated spot market with interruptions, re-optimizations, and the
workload-intent heuristic — an hour-by-hour operations log, driven by the
scenario engine (one declarative Scenario instead of a hand-rolled loop).

    PYTHONPATH=src python -m repro_torch.examples.provision_cluster --hours 48

Every inline solve runs on the process-default backend: the card unless
``KUBEPACS_SOLVER_BACKEND`` names another (``torch:cpu`` on a host).
"""

import argparse

from ..sim import ClusterSim, Scenario


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hours", type=int, default=48)
    ap.add_argument("--pods", type=int, default=200)
    ap.add_argument("--intent", default="network",
                    choices=["none", "network", "disk", "both"])
    args = ap.parse_args(argv)

    intent = {"none": (), "network": ("network",), "disk": ("disk",),
              "both": ("network", "disk")}[args.intent]
    scenario = Scenario(
        name="provision_cluster",
        duration_hours=float(args.hours), step_hours=1.0,
        pods=args.pods, cpu_per_pod=2, mem_per_pod=4, workload=intent,
        interrupt_model="pressure", policy="kubepacs", ttl_hours=3.0,
        catalog_seed=11, max_offerings=2000,
        market_seed=11, interrupt_seed=11,
    )
    sim = ClusterSim(scenario)
    res = sim.run()

    _, d0 = res.decisions[0]
    print(f"t=0h  provisioned {d0.pool.total_nodes} nodes / "
          f"{d0.pool.total_pods} pods @ ${d0.pool.hourly_cost:.2f}/h  "
          f"(alpha*={d0.alpha:.3f}, {d0.wall_seconds:.2f}s)")
    for rd in res.rounds:
        if not rd.effective:
            continue
        repl = rd.decision
        if repl is not None and repl.pool.total_nodes:
            print(f"t={rd.time:.0f}h  lost {rd.lost_nodes} nodes "
                  f"({rd.lost_pods} pods) -> replaced with "
                  f"{repl.pool.total_nodes} nodes in "
                  f"{repl.wall_seconds:.2f}s; "
                  f"{len(repl.excluded_offerings)} excluded offerings")

    print(f"\n{args.hours}h summary: ${res.total_cost:.2f} spent, "
          f"{res.interrupted_nodes} node interruptions absorbed, "
          f"final pool {res.pool.total_nodes} nodes / "
          f"{res.pool.total_pods} pods "
          f"({len(res.records)} trace records)")


if __name__ == "__main__":
    main()
