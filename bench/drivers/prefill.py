"""Traffic of kind ``prefill``: a closed loop of prefill requests through
the port's ``serving.prefill_fn``, each serving its first token.

Traffic keys: ``batch`` and ``prompt`` (a request's rows and prompt
tokens; token ids uniform over the vocabulary, a new prompt from the seed
every request), ``max_len`` (the caches' length), ``checked_rows`` (how
many rows of the finished requests the check samples, drawn from the
seed).

A request is one ``prefill_fn`` call; its first token is the argmax of
the last position's logits, read back to the host, and no decode step
follows.  The check runs the reference (float32) over each sampled row
and compares, by the worst row:

* ``served_gap``: how far the served token's reference logit lies below
  the reference's best;
* ``logit_gap``: the largest |program's logit - reference's| at the
  served position, over the vocabulary.

The control runs the reference in fp8 over the same prompts in the
program's place: its own first tokens and logits.
"""

from __future__ import annotations

import random

import torch

from .. import harness, weights
from ..ref import model as ref_model
from ..ref.precision import Precision

#: query rows the reference takes at a time (its score block of a 32k row
#: is 16 heads x 2,048 x 32,768 floats)
Q_BLOCK = 2048


def prompt(cell, seed, i, device):
    tr = cell.traffic
    gen = weights.generator(harness.derive(seed, "prompt", i), device)
    return torch.randint(0, cell.config["vocab_size"],
                         (tr["batch"], tr["prompt"]), generator=gen,
                         device=device)


def reference_params(cell, seed, device):
    return {name: t.clone() for name, t in weights.make(
        ref_model.schema(cell.config), harness.derive(seed, "weights"),
        device)}


def last_logits(p, cell, tokens, mode):
    """The reference's logits at the last position of each row, one row at
    a time: ``(B, V)``."""
    with torch.no_grad():
        return torch.cat([ref_model.forward(
            p, cell.config, row[None], Precision(mode), q_block=Q_BLOCK,
            logits_at=-1) for row in tokens])


def numbers(served, logits, ref) -> dict:
    """``served`` ``(R,)``, ``logits`` and ``ref`` ``(R, V)``."""
    picked = torch.gather(ref, 1, served[:, None].to(ref.device))[:, 0]
    return {"served_gap": float((ref.max(dim=1).values - picked).max()),
            "logit_gap": float((logits.to(ref.device).float() - ref)
                               .abs().max())}


class Driver:
    synchronous = True

    def __init__(self, cell, seed, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.pc = harness.program_config(cell.config)
        self.params = harness.program_params(cell.config, self.pc, seed,
                                             device)
        self.served, self.logits = [], []
        self._request(prompt(cell, seed, "warm-up", device))
        self.served, self.logits = [], []

    def _request(self, tokens) -> None:
        from repro_torch import serving

        logits, caches = serving.prefill_fn(
            self.params, {"tokens": tokens}, cfg=self.pc,
            max_len=self.cell.traffic["max_len"])
        last = logits[:, -1].float()
        del logits, caches
        self.served.append(last.argmax(dim=-1).cpu())
        self.logits.append(last)

    def unit(self, i) -> dict:
        tr = self.cell.traffic
        self._request(prompt(self.cell, self.seed, i, self.device))
        return {"tokens": tr["batch"] * tr["prompt"]}

    def free(self) -> None:
        del self.params
        rows = [(i, r) for i in range(len(self.served))
                for r in range(self.cell.traffic["batch"])]
        self.picks = sorted(random.Random(self.seed).sample(
            rows, min(len(rows), self.cell.traffic["checked_rows"])))
        self.logits = torch.stack([self.logits[i][r].cpu()
                                   for i, r in self.picks])

    def check(self, control=False):
        cell, seed, dev = self.cell, self.seed, self.device
        p = reference_params(cell, seed, dev)
        tokens = torch.stack([prompt(cell, seed, i, dev)[r]
                              for i, r in self.picks])
        served = torch.stack([self.served[i][r] for i, r in self.picks])
        ref = last_logits(p, cell, tokens, "float32")
        got = numbers(served, self.logits, ref)
        if not control:
            return got, None
        low = last_logits(p, cell, tokens, "fp8")
        return got, {"fp8": numbers(low.argmax(dim=1), low, ref)}
