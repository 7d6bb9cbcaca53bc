"""Fig. 8: workload-aware scaling — fraction of specialized instances chosen
under each declared intent (paper: 74.5% network / 84.7% disk / 72.9% both;
general workloads pick specialized types only opportunistically)."""

from ..core import (KubePACSProvisioner, Request, SpotMarketSimulator,
                    get_backend)

from . import common


def _fractions(pool):
    total = max(pool.total_nodes, 1)
    by = {"general": 0, "network": 0, "disk": 0, "network+disk": 0}
    for it, c in zip(pool.items, pool.counts):
        by[it.offering.specialization] += c
    return {k: v / total for k, v in by.items()}


def run(cat=None, snapshots: int = 8):
    """Aggregate node fractions over several market snapshots (the paper's
    Fig. 8 aggregates a multi-day collection period — a single provisioning
    decision has only 3–6 instance types, too few for a stable fraction)."""
    cat = cat or common.catalog()
    sim = SpotMarketSimulator(cat, seed=0)
    prov = KubePACSProvisioner(backend=get_backend())
    counts = {name: {"hit": 0, "total": 0} for name in
              ("general", "network", "disk", "disk+network")}
    wall = 0.0
    for _ in range(snapshots):
        snap = sim.snapshot()
        for name, intent in (("general", frozenset()),
                             ("network", frozenset({"network"})),
                             ("disk", frozenset({"disk"})),
                             ("disk+network", frozenset({"disk", "network"}))):
            req = Request(pods=200, cpu_per_pod=2, mem_per_pod=2,
                          workload=intent)
            d = prov.provision(req, snap)
            wall += d.wall_seconds
            for it, c in zip(d.pool.items, d.pool.counts):
                spec = it.offering.specialization
                counts[name]["total"] += c
                if name == "general":
                    counts[name]["hit"] += c if spec == "general" else 0
                elif name == "network":
                    counts[name]["hit"] += c if spec in (
                        "network", "network+disk") else 0
                elif name == "disk":
                    counts[name]["hit"] += c if spec in (
                        "disk", "network+disk") else 0
                else:
                    counts[name]["hit"] += c if spec != "general" else 0
        sim.step(6.0)
    out = {name: v["hit"] / max(v["total"], 1) for name, v in counts.items()}
    out["us_per_call"] = wall / (4 * snapshots) * 1e6
    return out


def main():
    out = run()
    print(f"fig8_preferences,{out['us_per_call']:.0f},"
          f"general_general={out['general']:.1%};"
          f"network_adherence={out['network']:.1%};"
          f"disk_adherence={out['disk']:.1%};"
          f"both_adherence={out['disk+network']:.1%}")
    return out


if __name__ == "__main__":
    main()
