"""End-to-end elastic spot training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \
        --steps 100 --pods 64 [--smoke] [--ckpt-dir DIR] [--device cpu]

Runs the full stack: KubePACS provisions the pool from a simulated spot
market (the cover-DP kernel on the card, through the process-default
backend), the trainer runs real train steps, interruptions trigger the
§4.1 recovery loop (emergency checkpoint → Unavailable-Offerings cache →
ILP×GSS re-optimization → restore).  ``--smoke`` (the default) trains the
reduced config; ``--full`` the published one.  Runs on the card unless
``--device cpu`` (the solver backend then follows
``KUBEPACS_SOLVER_BACKEND``, which defaults to the card too).  Prints the
reference's JSON.
"""

import argparse
import json
import tempfile

from ..configs import get_config, list_archs
from ..core import Request, SpotMarketSimulator, generate_catalog
from ..data.pipeline import DataConfig
from ..optim import OptConfig
from ..runtime import ElasticConfig, ElasticSpotTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--pods", type=int, default=64)
    ap.add_argument("--batch-rows", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--market-seed", type=int, default=7)
    ap.add_argument("--intent", default="none",
                    choices=["none", "network", "disk"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    intent = frozenset() if args.intent == "none" else frozenset({args.intent})
    request = Request(pods=args.pods, cpu_per_pod=4, mem_per_pod=8,
                      workload=intent)
    market = SpotMarketSimulator(generate_catalog(seed=args.market_seed),
                                 seed=args.market_seed)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix=f"ckpt_{args.arch}_")

    trainer = ElasticSpotTrainer(
        cfg, request, market, ckpt_dir,
        ElasticConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      market_check_every=10, batch_rows=args.batch_rows,
                      seq_len=args.seq_len),
        opt_cfg=OptConfig(lr=args.lr, warmup_steps=10,
                          total_steps=max(args.steps, 100)),
        dcfg=DataConfig(seed=args.seed), seed=args.seed, device=args.device)
    out = trainer.run()
    print(json.dumps({
        "arch": cfg.name, "steps": out["steps"],
        "first_loss": out["losses"][0], "final_loss": out["final_loss"],
        "interrupts_handled": out["interrupts_handled"],
        "recovery_times_s": out["recovery_times"],
        "ckpt_dir": ckpt_dir,
    }, indent=2))


if __name__ == "__main__":
    main()
