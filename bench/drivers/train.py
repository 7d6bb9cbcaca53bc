"""Traffic of kind ``train``: training steps back to back through the
port's ``train.loop.make_train_step``.

Traffic keys: ``batch`` and ``seq`` (a step's rows and positions; token
ids uniform over the vocabulary, each row's targets its next tokens, a
new batch from the seed every step), ``checked_steps`` (the first steps,
run in set-up through the window's own call and followed by the
reference), ``optimizer`` (AdamW's settings, given to the port's
``OptConfig`` and to the reference) and ``z_loss_weight``.

The set-up builds one step, its parameters and its AdamW state, runs the
checked steps and hands the same objects to the window.  It keeps what
the check compares: each checked step's loss, the first gradient as
AdamW got it (its first moment after one step, over ``1 - b1``) and each
leaf's change after the checked steps.  Once the program is gone, the
reference (:mod:`bench.ref.model`, float32) runs the same steps from the
same weights; the numbers compared, by the worst step or leaf:

* ``loss_gap``: |program's loss - reference's| / reference's;
* ``grad_gap``: |program's gradient norm - reference's| / the larger of
  the reference's and the median leaf's;
* ``change_gap``: the same of each leaf's change, leaving out the leaves
  whose reference gradient is under a thousandth of the median leaf's
  (they move under AdamW by round-off alone).

The control runs the reference in fp8 in the program's place, and the
fault of half the batch left out runs it on the first half of the rows.
"""

from __future__ import annotations

import inspect
import statistics

import torch

from .. import harness, weights
from ..ref import model as ref_model
from ..ref.precision import Precision

#: leaves whose reference gradient is under this share of the median
#: leaf's are left out of ``change_gap``
QUIET_LEAF = 1e-3


class Side:
    """One side's readings: each checked step's loss, each leaf's first
    (clipped) gradient norm and each leaf's change norm."""

    def __init__(self, losses, grads, change):
        self.losses, self.grads, self.change = losses, grads, change


def numbers(prog: Side, ref: Side) -> dict:
    g_med = statistics.median(ref.grads.values())
    keep = [k for k, g in ref.grads.items() if g >= QUIET_LEAF * g_med]
    c_med = statistics.median(ref.change[k] for k in keep)
    return {
        "loss_gap": max(abs(p - r) / abs(r)
                        for p, r in zip(prog.losses, ref.losses)),
        "grad_gap": max(abs(prog.grads[k] - g) / max(g, g_med)
                        for k, g in ref.grads.items()),
        "change_gap": max(abs(prog.change[k] - ref.change[k])
                          / max(ref.change[k], c_med) for k in keep),
    }


def change_norms(current, config, seed, device) -> dict:
    """Each leaf's ``|current - initial|``, the initial weights drawn again
    from the seed."""
    out = {}
    with torch.no_grad():
        for name, p0 in weights.make(ref_model.schema(config),
                                     harness.derive(seed, "weights"), device):
            out[name] = float(torch.linalg.vector_norm(current[name] - p0))
    return out


def batch(cell, seed, i, device, rows=None):
    """Step ``i``'s ``(tokens, targets)``, ``(B, S)`` each."""
    tr = cell.traffic
    gen = weights.generator(harness.derive(seed, "batch", i), device)
    ids = torch.randint(0, cell.config["vocab_size"],
                        (tr["batch"], tr["seq"] + 1), generator=gen,
                        device=device)
    ids = ids[:rows] if rows else ids
    return ids[:, :-1], ids[:, 1:]


def reference_side(cell, seed, device, mode="float32", rows=None) -> Side:
    """The reference's readings, computed in ``mode``, on the first
    ``rows`` rows of each batch (all by default)."""
    tr = cell.traffic
    p = {name: t.clone() for name, t in weights.make(
        ref_model.schema(cell.config), harness.derive(seed, "weights"),
        device)}
    batches = [batch(cell, seed, i, device, rows)
               for i in range(tr["checked_steps"])]
    losses, grads = ref_model.train(p, cell.config, batches, tr["optimizer"],
                                    Precision(mode), tr["z_loss_weight"])
    change = change_norms(p, cell.config, seed, device)
    return Side(losses, grads, change)


class Driver:
    synchronous = True

    def __init__(self, cell, seed, device):
        from repro_torch import optim
        from repro_torch.models import transformer
        from repro_torch.train import loop

        self.cell, self.seed, self.device = cell, seed, device
        tr = cell.traffic
        z_default = inspect.signature(transformer.loss_fn).parameters[
            "z_loss_weight"].default
        if z_default != tr["z_loss_weight"]:
            raise ValueError(f"the port's z-loss weight {z_default} is not "
                             f"the traffic's {tr['z_loss_weight']}")
        pc = harness.program_config(cell.config)
        self.params = harness.program_params(cell.config, pc, seed, device)
        self.opt = optim.init_opt_state(self.params)
        opt_fields = set(inspect.signature(optim.OptConfig).parameters)
        self.step = loop.make_train_step(pc, optim.OptConfig(
            **{k: v for k, v in tr["optimizer"].items() if k in opt_fields}))
        losses, grads = [], None
        for i in range(tr["checked_steps"]):
            losses.append(self._step(i))
            if i == 0:
                b1 = tr["optimizer"]["b1"]
                grads = {k: float(torch.linalg.vector_norm(m)) / (1 - b1)
                         for k, m in self.opt["m"].items()}
        change = change_norms(dict(self.params.named_parameters()),
                              cell.config, seed, device)
        self.side = Side(losses, grads, change)

    def _step(self, i) -> float:
        tokens, targets = batch(self.cell, self.seed, i, self.device)
        self.params, self.opt, m = self.step(
            self.params, self.opt, {"tokens": tokens, "targets": targets})
        return float(m["loss"])

    def unit(self, i) -> dict:
        tr = self.cell.traffic
        self._step(tr["checked_steps"] + i)
        return {"tokens": tr["batch"] * tr["seq"]}

    def free(self) -> None:
        del self.params, self.opt, self.step

    def check(self, control=False):
        cell, seed, dev = self.cell, self.seed, self.device
        ref = reference_side(cell, seed, dev)
        got = numbers(self.side, ref)
        if not control:
            return got, None
        harness.release(dev)
        ctrl = {"fp8": numbers(reference_side(cell, seed, dev, "fp8"), ref)}
        harness.release(dev)
        ctrl["half_batch"] = numbers(reference_side(
            cell, seed, dev, rows=cell.traffic["batch"] // 2), ref)
        return got, ctrl
