"""Serving step factories: batched prefill and decode, on one device or
laid out on a mesh.

``prefill_fn`` / ``decode_fn`` are the model's own ``prefill`` /
``decode_step``.  ``make_sharded_prefill`` / ``make_sharded_decode``
return the same steps on the mesh active when they are built
(``sharding.mesh_context``): the callable lays its inputs out under the
pspec trees as DTensors (the parameters in place,
``transformer.distribute_params``), runs the step with the model's mesh
hooks under the factory's rules, and redistributes the outputs to the out
specs.  A decode step writes the caches in place (``donate`` is accepted
for the reference's signature: the caches are always reused).  On a
1-rank mesh this is still the DTensor path; the dry-run
(``launch/dryrun.py``) counts these callables on abstract tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from . import sharding
from .configs.base import ModelConfig
from .models import transformer


def prefill_fn(params, batch, *, cfg: ModelConfig, max_len: int):
    return transformer.prefill(params, cfg, batch, max_len=max_len)


def decode_fn(params, caches, tokens, pos, *, cfg: ModelConfig):
    return transformer.decode_step(params, cfg, caches, tokens, pos)


def _active_mesh(what: str):
    ctx = sharding.active()
    if ctx is None:
        raise RuntimeError(f"{what}: no active mesh "
                           "(enter sharding.mesh_context first)")
    return ctx[0]


def _logits_spec(cfg: ModelConfig, b_ax, rules: sharding.MeshRules):
    if cfg.input_mode != "audio_codes":
        return sharding.P(b_ax, None, rules.model)
    return sharding.P(b_ax, None, None, rules.model)


def make_sharded_prefill(cfg: ModelConfig, rules: sharding.MeshRules,
                         batch_pspecs: Dict[str, Any], max_len: int
                         ) -> Callable:
    """``step(params, batch) -> (logits, caches)`` on the active mesh."""
    mesh = _active_mesh("make_sharded_prefill")
    pspecs = transformer.param_pspecs(cfg, rules)
    cache_specs = transformer.cache_pspecs(cfg, rules, long_context=False)
    logits_spec = _logits_spec(cfg, rules.batch or None, rules)

    def step(params, batch):
        with sharding.mesh_context(mesh, rules):
            transformer.distribute_params(params, pspecs, mesh)
            batch = sharding.distribute_tree(batch, batch_pspecs, mesh)
            logits, caches = prefill_fn(params, batch, cfg=cfg,
                                        max_len=max_len)
            return (sharding.distribute(logits, logits_spec, mesh),
                    sharding.distribute_tree(caches, cache_specs, mesh))
    return step


def make_sharded_decode(cfg: ModelConfig, rules: sharding.MeshRules,
                        batch_pspecs: Dict[str, Any],
                        long_context: bool = False, donate: bool = True
                        ) -> Callable:
    """``step(params, caches, tokens, pos) -> (logits, caches)`` on the
    active mesh; the caches are written in place."""
    mesh = _active_mesh("make_sharded_decode")
    pspecs = transformer.param_pspecs(cfg, rules)
    cache_specs = transformer.cache_pspecs(cfg, rules,
                                           long_context=long_context)
    b_ax = None if long_context else (rules.batch or None)
    logits_spec = _logits_spec(cfg, b_ax, rules)

    def step(params, caches, tokens, pos):
        with sharding.mesh_context(mesh, rules):
            transformer.distribute_params(params, pspecs, mesh)
            caches = sharding.distribute_tree(caches, cache_specs, mesh)
            tokens = sharding.distribute_tree(tokens, batch_pspecs, mesh)
            logits, caches = decode_fn(params, caches, tokens, int(pos),
                                       cfg=cfg)
            return (sharding.distribute(logits, logits_spec, mesh),
                    sharding.distribute_tree(caches, cache_specs, mesh))
    return step
