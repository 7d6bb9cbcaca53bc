"""Fig. 9: 50-node requests against offerings bucketed by T3 — fulfillment
rises monotonically with the multi-node score (and Fig. 2's single-node-SPS
trap fulfills poorly).

Re-derived through the scenario engine's fulfillment layer: a zero-duration
scenario whose per-offering probes go through ``ClusterSim.probe_fulfillment``
and are therefore recorded to the replayable JSONL trace."""

import numpy as np

from ..sim import ClusterSim, Scenario

from . import common

REQUEST_NODES = 50


def scenario(max_offerings: int = 2000) -> Scenario:
    return Scenario(name="fig9_t3_fulfillment", duration_hours=0.0,
                    interrupt_model="none", apply_fulfillment=True,
                    catalog_seed=0, max_offerings=max_offerings,
                    market_seed=0)


def run(cat=None):
    cat = cat or common.catalog()
    sim = ClusterSim(scenario(max_offerings=len(cat)), catalog=cat)
    snap = sim.current_snapshot()
    buckets = [(0, 5), (5, 15), (15, 30), (30, 51)]
    rows = []
    for lo, hi in buckets:
        offers = [o for o in snap if lo <= o.t3 < hi][:40]
        ful = [sim.probe_fulfillment(o.offering_id, REQUEST_NODES)
               for o in offers]
        rows.append({"t3_bucket": f"[{lo},{hi})",
                     "mean_fulfilled": float(np.mean(ful)) if ful else 0.0,
                     "n": len(offers)})
    trap = [o for o in snap if o.sps_single == 3 and o.t3 <= 3][:40]
    trap_ful = float(np.mean([sim.probe_fulfillment(o.offering_id,
                                                    REQUEST_NODES)
                              for o in trap])) if trap else 0.0
    means = [r["mean_fulfilled"] for r in rows]
    return {"rows": rows, "monotone": all(a <= b + 1.0 for a, b in
                                          zip(means, means[1:])),
            "single_node_sps3_trap_fulfilled": trap_ful,
            "trace_records": len(sim.recorder.records),
            "us_per_call": 0.0}


def main():
    out = run()
    detail = ";".join(f"{r['t3_bucket']}={r['mean_fulfilled']:.1f}/50"
                      for r in out["rows"])
    print(f"fig9_t3_fulfillment,0,{detail};monotone={out['monotone']};"
          f"sps3_trap={out['single_node_sps3_trap_fulfilled']:.1f}/50")
    return out


if __name__ == "__main__":
    main()
