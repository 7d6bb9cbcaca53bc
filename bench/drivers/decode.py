"""Traffic of kind ``decode``: greedy decoding, step after step, of long
sessions through the port's ``serving.decode_fn``.

Traffic keys: ``batch`` (sessions), ``context`` (each session's prompt,
token ids uniform over the vocabulary from the seed), ``max_len`` (the
caches' length), ``warmup_steps`` (steps in set-up), ``checked_rows``
(sessions the check samples, drawn from the seed).

The set-up prefills the contexts into caches of ``max_len`` through
``serving.prefill_fn`` and takes each session's first token by argmax.
Each step of the window feeds the last tokens back at the next position;
when the sessions reach ``max_len`` they begin a new answer at position
``context``, from the same first token, over the same context.  The loop
never waits for the device: each step's tokens stay on it.

The check runs the reference (float32) once over each sampled session's
context and the tokens of each of its answers, and compares
``served_gap``: the widest gap, over every served token, by which its
reference logit lies below the reference's best at that position.  The
control reads, at the same positions, the gap of the token that the
reference in fp8 puts first.
"""

from __future__ import annotations

import random

import torch

from .. import harness, weights
from ..ref import model as ref_model
from ..ref.precision import Precision
from .prefill import Q_BLOCK, reference_params


def context(cell, seed, device):
    tr = cell.traffic
    gen = weights.generator(harness.derive(seed, "context"), device)
    return torch.randint(0, cell.config["vocab_size"],
                         (tr["batch"], tr["context"]), generator=gen,
                         device=device)


def gaps(ref, tokens) -> torch.Tensor:
    """How far each token's logit lies below the best: ``ref`` ``(n, V)``,
    ``tokens`` ``(n,)``."""
    picked = torch.gather(ref, 1, tokens[:, None])[:, 0]
    return ref.max(dim=1).values - picked


class Driver:
    synchronous = False

    def __init__(self, cell, seed, device):
        from repro_torch import serving

        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        self.pc = harness.program_config(cell.config)
        self.params = harness.program_params(cell.config, self.pc, seed,
                                             device)
        self.ctx = context(cell, seed, device)
        logits, self.caches = serving.prefill_fn(
            self.params, {"tokens": self.ctx}, cfg=self.pc,
            max_len=tr["max_len"])
        self.first = torch.argmax(logits[:, -1:], dim=-1)          # (B, 1)
        del logits
        self.answers = []
        self._new_answer()
        for _ in range(tr["warmup_steps"]):
            self._step()
        harness.sync(device)

    def _new_answer(self) -> None:
        self.pos = self.cell.traffic["context"]
        self.nxt = self.first
        self.answers.append([self.first])

    def _step(self) -> int:
        from repro_torch import serving

        if self.pos == self.cell.traffic["max_len"]:
            self._new_answer()
        pos = self.pos
        logits, self.caches = serving.decode_fn(
            self.params, self.caches, {"tokens": self.nxt}, pos, cfg=self.pc)
        self.nxt = torch.argmax(logits[:, -1:], dim=-1)
        self.answers[-1].append(self.nxt)
        self.pos += 1
        return pos

    def unit(self, i) -> dict:
        return {"tokens": self.cell.traffic["batch"], "pos": self._step()}

    def free(self) -> None:
        del self.params, self.caches
        self.answers = [torch.cat(a, dim=1).cpu() for a in self.answers]
        self.rows = sorted(random.Random(self.seed).sample(
            range(self.cell.traffic["batch"]),
            self.cell.traffic["checked_rows"]))

    def check(self, control=False):
        cell, dev = self.cell, self.device
        c = cell.traffic["context"]
        p = reference_params(cell, self.seed, dev)
        worst = worst_low = 0.0
        with torch.no_grad():
            for row in self.rows:
                for answer in self.answers:
                    served = answer[row].to(dev)                   # (n,)
                    seq = torch.cat([self.ctx[row], served[:-1]])[None]
                    at = slice(c - 1, c - 1 + served.shape[0])
                    ref = ref_model.forward(p, cell.config, seq,
                                            Precision("float32"),
                                            q_block=Q_BLOCK, logits_at=at)[0]
                    worst = max(worst, float(gaps(ref, served).max()))
                    if control:
                        low = ref_model.forward(p, cell.config, seq,
                                                Precision("fp8"),
                                                q_block=Q_BLOCK,
                                                logits_at=at)[0]
                        worst_low = max(worst_low, float(
                            gaps(ref, low.argmax(dim=1)).max()))
        got = {"served_gap": worst}
        return got, ({"fp8": {"served_gap": worst_low}} if control else None)
