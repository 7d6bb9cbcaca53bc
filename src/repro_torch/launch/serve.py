"""Batched serving: a continuous-batching loop over any assigned arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
        --requests 8 --batch 4 --prompt-len 32 --new-tokens 8 [--device cpu]

Requests wait in a queue; the server packs them into fixed-size batches
(a partial last batch is padded: the reference's loop pops one request
too many there and raises), prefills, then decodes greedily with the
KV/SSM caches.  ``main`` serves the reduced (smoke) config as the
reference's ``main`` does; :func:`serve` takes any config and parameters.
Prompts come from ``np.random.default_rng(seed)`` in the reference's order,
so the token ids are the same.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, list_archs
from ..configs.base import ModelConfig
from ..models import init_params
from ..serving import decode_fn, prefill_fn


def _prompts(cfg: ModelConfig, rng: np.random.Generator, B: int, S: int,
             device) -> Dict[str, torch.Tensor]:
    if cfg.input_mode == "audio_codes":
        return {"codes": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, cfg.n_codebooks, S))).to(device)}
    if cfg.input_mode == "vlm":
        tokens = rng.integers(0, cfg.vocab_size, (B, S))
        embeds = rng.normal(size=(B, cfg.vision_prefix, cfg.d_model))
        return {"tokens": torch.from_numpy(tokens).to(device),
                "vision_embeds": torch.from_numpy(embeds).to(
                    device=device, dtype=torch.float32)}
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S))).to(device)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, params, *, requests: int, batch: int,
          prompt_len: int, new_tokens: int, seed: int = 0,
          device=None) -> dict:
    """Serve ``requests`` random prompts of ``prompt_len`` tokens in batches
    of ``batch``, ``new_tokens`` greedy decode steps each.

    Returns the reference loop's summary (``served``, ``wall_s``,
    ``throughput_tok_s``, per-batch ``batches``) plus, per batch, the
    prefill and decode walls, and ``tokens``: each batch's greedy tokens
    for its real requests, ``(n, new_tokens + 1)`` (``(n, new_tokens + 1,
    K)`` for audio codes) on the host; ``all_finite`` says whether every
    logit of the run was finite (read once at the end)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, S, N = batch, prompt_len, new_tokens
    vp = cfg.vision_prefix if cfg.input_mode == "vlm" else 0
    max_len = S + N + vp

    pending, served, stats, tokens = requests, 0, [], []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    while pending:
        n = min(B, pending)
        pending -= n
        inputs = _prompts(cfg, rng, B, S, dev)   # a partial batch is padded
        t_b = time.perf_counter()
        logits, caches = prefill_fn(params, inputs, cfg=cfg, max_len=max_len)
        finite &= torch.isfinite(logits).all()
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        _sync(dev)
        t_p = time.perf_counter()
        out: List[torch.Tensor] = [nxt]
        for i in range(N):
            if cfg.input_mode == "audio_codes":
                step_in = {"codes": nxt.transpose(1, 2)}
            else:
                step_in = {"tokens": nxt.reshape(B, -1)[:, :1]}
            logits, caches = decode_fn(params, caches, step_in, S + vp + i,
                                       cfg=cfg)
            finite &= torch.isfinite(logits).all()
            nxt = torch.argmax(logits[:, -1:], dim=-1)
            out.append(nxt)
        gen = torch.cat(out, dim=1)[:n].cpu().numpy()
        t_d = time.perf_counter()
        served += n
        tokens.append(gen)
        stats.append({"batch": n, "padded": B - n,
                      "latency_s": round(t_d - t_b, 3),
                      "tok_s": round(n * N / (t_d - t_b), 1),
                      "prefill_s": t_p - t_b, "decode_s": t_d - t_p})
    wall = time.perf_counter() - t0
    return {"arch": cfg.name, "served": served, "wall_s": round(wall, 2),
            "throughput_tok_s": round(served * N / wall, 1),
            "batches": stats, "tokens": tokens,
            "all_finite": bool(finite.item())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), dev)
    out = serve(cfg, params, requests=args.requests, batch=args.batch,
                prompt_len=args.prompt_len, new_tokens=args.new_tokens,
                seed=args.seed, device=dev)
    out.pop("tokens")
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
