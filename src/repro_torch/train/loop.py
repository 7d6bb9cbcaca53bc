"""Train step factory + a minimal state container.

``make_train_step`` returns one step: the loss and its gradients through
autograd (``loss_fn`` → backward), then the AdamW update — the reference's
``train_step_fn``, eager, with no ``torch.compile``.  Parameters (a
``Transformer``) and the optimizer's moments are updated in place; the
step returns them with the reference's metrics.  ``make_sharded_train_step``
is the same step on the active mesh: it lays the parameters, the moments
and the batch out as DTensors under the pspec trees (the parameters and
moments in place), runs the step under the factory's rules and
redistributes the outputs to the out specs — what ``launch/dryrun.py``
counts.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch

from .. import optim, sharding, spans
from ..configs.base import ModelConfig
from ..models import transformer


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _on_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors) as tensors on ``device``;
    DTensors (a batch laid out on a mesh) as they are."""
    from torch.distributed.tensor import DTensor
    return {k: v if isinstance(v, DTensor) else torch.as_tensor(v).to(device)
            for k, v in batch.items()}


def train_step_fn(params: transformer.Transformer, opt_state, batch, *,
                  cfg: ModelConfig, opt_cfg: optim.OptConfig
                  ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """``(params, opt_state, metrics)`` after one step on ``batch``:
    ``loss``, ``z_loss``, ``moe_aux``, ``tokens``, ``lr``, ``grad_norm``
    and ``total_loss``, as 0-d tensors on the parameters' device."""
    with spans.span("train_step"):
        named = optim.leaves(params)
        for p in named.values():
            p.requires_grad_(True)
        dev = next(iter(named.values())).device
        with torch.enable_grad():
            total, metrics = transformer.loss_fn(params, cfg,
                                                 _on_device(batch, dev))
            with spans.span("backward"):
                grads = dict(zip(named, torch.autograd.grad(
                    total, list(named.values()))))
        with spans.span("optimizer"):
            params, opt_state, opt_metrics = optim.adamw_update(
                params, grads, opt_state, opt_cfg,
                ranks=transformer.reference_ranks(cfg))
        metrics = {**{k: v.detach() for k, v in metrics.items()},
                   **opt_metrics, "total_loss": total.detach()}
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    donate: bool = True) -> Callable:
    """The step for ``cfg``.  ``donate`` is accepted for the reference's
    signature and has no effect: the update is in place already."""
    return functools.partial(train_step_fn, cfg=cfg, opt_cfg=opt_cfg)


def make_sharded_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                            rules: sharding.MeshRules, batch_pspecs,
                            donate: bool = True) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``
    on the mesh active when it is built (``sharding.mesh_context``).
    ``donate`` is accepted for the reference's signature: the parameters
    and moments are updated in place either way."""
    ctx = sharding.active()
    if ctx is None:
        raise RuntimeError("make_sharded_train_step: no active mesh "
                           "(enter sharding.mesh_context first)")
    mesh = ctx[0]
    pspecs = transformer.param_pspecs(cfg, rules)
    opt_pspecs = {"m": pspecs, "v": pspecs, "step": sharding.P()}

    def step(params, opt_state, batch):
        with sharding.mesh_context(mesh, rules):
            transformer.distribute_params(params, pspecs, mesh)
            opt_state = sharding.distribute_tree(opt_state, opt_pspecs, mesh)
            batch = sharding.distribute_tree(batch, batch_pspecs, mesh)
            params, opt_state, metrics = train_step_fn(
                params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg)
            opt_state = sharding.distribute_tree(opt_state, opt_pspecs, mesh)
            metrics = {k: sharding.distribute(v, sharding.P(), mesh)
                       for k, v in metrics.items()}
        return params, opt_state, metrics
    return step
