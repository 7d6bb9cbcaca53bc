"""Train step factory + a minimal state container.

``make_train_step`` returns one step: the loss and its gradients through
autograd (``loss_fn`` → backward), then the AdamW update — the reference's
``train_step_fn``, eager, with no ``torch.compile``.  Parameters (a
``Transformer``) and the optimizer's moments are updated in place; the
step returns them with the reference's metrics.  The sharded step
(``make_sharded_train_step``) comes with the port of ``sharding.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Tuple

import torch

from .. import optim
from ..configs.base import ModelConfig
from ..models import transformer


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int = 0


def _on_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_step_fn(params: transformer.Transformer, opt_state, batch, *,
                  cfg: ModelConfig, opt_cfg: optim.OptConfig
                  ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """``(params, opt_state, metrics)`` after one step on ``batch``:
    ``loss``, ``z_loss``, ``moe_aux``, ``tokens``, ``lr``, ``grad_norm``
    and ``total_loss``, as 0-d tensors on the parameters' device."""
    named = optim.leaves(params)
    for p in named.values():
        p.requires_grad_(True)
    dev = next(iter(named.values())).device
    with torch.enable_grad():
        total, metrics = transformer.loss_fn(params, cfg,
                                             _on_device(batch, dev))
        grads = dict(zip(named, torch.autograd.grad(
            total, list(named.values()))))
    params, opt_state, opt_metrics = optim.adamw_update(
        params, grads, opt_state, opt_cfg,
        ranks=transformer.reference_ranks(cfg))
    metrics = {**{k: v.detach() for k, v in metrics.items()}, **opt_metrics,
               "total_loss": total.detach()}
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, opt_cfg: optim.OptConfig,
                    donate: bool = True) -> Callable:
    """The step for ``cfg``.  ``donate`` is accepted for the reference's
    signature and has no effect: the update is in place already."""
    return functools.partial(train_step_fn, cfg=cfg, opt_cfg=opt_cfg)
