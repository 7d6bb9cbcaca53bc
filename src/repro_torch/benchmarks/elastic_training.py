"""Framework benchmark: elastic spot training under injected interruptions —
steps/s, recovery latency, and provisioning overhead of the integrated
KubePACS control plane (the paper's <2 s / <194 MB overhead claim, §5.3).

The trainer is driven by the scenario engine's event stream: the market,
interruption sampling, and the replayable trace all live in a
``ClusterSim`` wrapped around the seeded market.  The model trains where
the process default backend solves: on the card (its attention through
the ``flash_attention`` kernel, forward and remat recompute), or on the
CPU under ``torch:cpu`` / ``torch:fused:cpu``.  Its provisioning solves
run on the process default too (``KUBEPACS_SOLVER_BACKEND``, the card's
``torch`` unless set).

Usage:
  python -m repro_torch.benchmarks.elastic_training
"""

import tempfile
import time

import numpy as np

from ..configs import get_config
from ..core import Request, SpotMarketSimulator, generate_catalog
from ..runtime import ElasticConfig, ElasticSpotTrainer
from ..sim import ClusterSim
from .common import default_device


def run(total_steps: int = 40):
    """The benchmark's record; ``total_steps`` defaults to the reference
    driver's and may be cut (a test's shorter run)."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    market = SpotMarketSimulator(generate_catalog(seed=3, max_offerings=400),
                                 seed=3)
    cluster = ClusterSim.from_market(market, interrupt_model="pressure",
                                     interrupt_seed=3,
                                     name="elastic_training")
    req = Request(pods=40, cpu_per_pod=2, mem_per_pod=4)
    with tempfile.TemporaryDirectory() as d:
        tr = ElasticSpotTrainer(cfg, req, cluster, d, ElasticConfig(
            total_steps=total_steps, ckpt_every=10, market_check_every=4,
            market_hours_per_check=6.0, batch_rows=8, seq_len=128),
            device=default_device())
        t0 = time.perf_counter()
        out = tr.run()
        wall = time.perf_counter() - t0
    prov_wall = [e["detail"].get("wall_s", 0.0) for e in out["events"]
                 if e["event"] == "provision"]
    return {
        "steps_per_s": out["steps"] / wall,
        "loss_drop": float(np.mean(out["losses"][:5])
                           - np.mean(out["losses"][-5:])),
        "interrupts_handled": out["interrupts_handled"],
        "mean_recovery_s": float(np.mean(out["recovery_times"]))
        if out["recovery_times"] else 0.0,
        "provision_wall_s": float(np.mean(prov_wall)) if prov_wall else 0.0,
        "trace_records": out["trace_records"],
        "us_per_call": wall / out["steps"] * 1e6,
    }


def main():
    out = run()
    print(f"elastic_training,{out['us_per_call']:.0f},"
          f"steps_per_s={out['steps_per_s']:.2f};"
          f"loss_drop={out['loss_drop']:.3f};"
          f"interrupts={out['interrupts_handled']};"
          f"recovery={out['mean_recovery_s']:.2f}s;"
          f"provision={out['provision_wall_s']:.2f}s;"
          f"trace={out['trace_records']}rec")
    return out


if __name__ == "__main__":
    main()
