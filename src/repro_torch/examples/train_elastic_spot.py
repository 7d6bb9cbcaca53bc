"""End to end: train a ~100M-param LM for a few hundred steps on a
KubePACS-provisioned spot pool, surviving simulated interruptions
(checkpoint -> re-provision -> restore).

    PYTHONPATH=src python -m repro_torch.examples.train_elastic_spot \\
        [--steps 300] [--device cpu]

Training runs on the card unless ``--device cpu``; the provisioning solves
on the process-default backend (the card unless ``KUBEPACS_SOLVER_BACKEND``
names another: ``torch:cpu`` on a host).
"""

import argparse
import tempfile

from ..configs.base import ModelConfig, dense_layout
from ..core import Request, SpotMarketSimulator, generate_catalog
from ..models.transformer import count_params
from ..runtime import ElasticConfig, ElasticSpotTrainer


def model_100m() -> ModelConfig:
    """~100M params: 12 layers, d_model 768, GQA 12/4, SwiGLU 2048."""
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=4, d_ff=2048, vocab_size=32_000,
        layout=dense_layout(12), scan_period=1, remat_policy="none",
    ).validate()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-rows", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = model_100m()
    print(f"model: {cfg.name}  params={count_params(cfg)/1e6:.1f}M")

    market = SpotMarketSimulator(generate_catalog(seed=7), seed=7)
    request = Request(pods=64, cpu_per_pod=4, mem_per_pod=8)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="kubepacs_ckpt_")
    print(f"checkpoints: {ckpt_dir}")

    trainer = ElasticSpotTrainer(
        cfg, request, market, ckpt_dir,
        ElasticConfig(total_steps=args.steps, ckpt_every=25,
                      market_check_every=10, market_hours_per_check=2.0,
                      batch_rows=args.batch_rows, seq_len=args.seq_len),
        device=args.device)
    out = trainer.run()

    print(f"\ntrained {out['steps']} steps; "
          f"loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f}")
    print(f"interrupt/straggler events handled: {out['interrupts_handled']}"
          f"  (recovery: {[round(r, 2) for r in out['recovery_times']]} s)")
    for e in out["events"]:
        print(f"  step {e['step']:4d}  {e['event']:10s}  {e['detail']}")
    return out


if __name__ == "__main__":
    main()
