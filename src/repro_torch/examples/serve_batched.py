"""Batched serving: prefill a batch of prompts, then decode new tokens with
the KV/SSM caches — over any assigned architecture (reduced config).

    PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
        --arch jamba-1.5-large-398b [--device cpu]

Weights come from the port's seeded ``init_params`` (a ``torch.Generator``
on the device, seed 0); prompts from ``np.random.default_rng(0)`` in the
reference's order.  Runs on the card unless ``--device cpu``.
"""

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, list_archs
from ..launch.serve import _prompts, _sync
from ..models import decode_step, init_params, prefill


def make_prompt(cfg, batch: int, prompt_len: int, device):
    """The reference example's prompt for ``cfg`` (``launch.serve``'s, from
    ``np.random.default_rng(0)``): ``(inputs, positions)``, the positions
    counting a VLM's vision prefix."""
    inputs = _prompts(cfg, np.random.default_rng(0), batch, prompt_len,
                      device)
    vision = cfg.vision_prefix if cfg.input_mode == "vlm" else 0
    return inputs, prompt_len + vision


def generate(cfg, params, prompt, new_tokens: int) -> np.ndarray:
    """Prefill ``prompt`` (from :func:`make_prompt`), decode ``new_tokens``
    greedy tokens, print the reference example's lines; returns the
    continuations ``(B, new_tokens)`` (codebook 0 of audio codes)."""
    inputs, S = prompt
    first = next(iter(inputs.values()))
    B, dev = first.shape[0], first.device
    N = new_tokens
    max_len = S + N

    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill(params, cfg, inputs, max_len=max_len)
        _sync(dev)
        print(f"prefill: batch={B} len={S} in "
              f"{time.perf_counter() - t0:.2f}s  "
              f"logits={tuple(logits.shape)}")

        tokens = []
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        t0 = time.perf_counter()
        for i in range(N):
            if cfg.input_mode == "audio_codes":
                inp = {"codes": nxt.transpose(1, 2)}         # (B,K,1)
            else:
                inp = {"tokens": nxt.reshape(B, 1)}
            logits, caches = decode_step(params, cfg, caches, inp, S + i)
            nxt = torch.argmax(logits[:, -1:], dim=-1)
            tokens.append(nxt.reshape(B, -1)[:, 0])
        arr = torch.stack(tokens, dim=1).cpu().numpy()     # synchronises
        dt = time.perf_counter() - t0
    print(f"decoded {N} tokens/seq in {dt:.2f}s "
          f"({B * N / dt:.1f} tok/s batched)")
    print("sampled continuations (greedy):")
    for b in range(B):
        print(f"  seq{b}: {arr[b].tolist()}")
    return arr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)    # reduced config
    if cfg.input_mode != "tokens":
        print(f"note: {args.arch} is {cfg.input_mode}; serving its token "
              f"backbone (modality frontend is a stub per the assignment)")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    return generate(cfg, params, make_prompt(cfg, args.batch,
                                             args.prompt_len, dev),
                    args.new_tokens)


if __name__ == "__main__":
    main()
