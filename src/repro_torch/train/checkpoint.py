"""Fault-tolerant checkpointing: atomic, resumable, retention-managed.

Layout, as the reference's: ``<dir>/step_<k>/params_<host>.npz``,
``opt_<host>.npz`` + ``meta.json``; a step directory is staged as
``.tmp-step_<k>`` and atomically renamed once fully written, so a
preemption mid-save can never corrupt the latest checkpoint (the 2-minute
spot interruption notice triggers an *emergency save* through the same
path).

The files hold the reference's trees: keys are the paths of its pytree
(``body/0/mixer/wq`` stacked over periods, ``m/...``, ``v/...``, ``step``)
and shapes are its own (``models.convert``), so either package restores
what the other wrote.  ``params`` is a ``Transformer`` (its ``cfg`` gives
the layout) and ``opt_state`` the port's AdamW state.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..models import convert
from ..models.layers import ParamDef
from ..models.transformer import Transformer


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for name, sub in tree.items():
        key = f"{prefix}{name}"
        if isinstance(sub, dict):
            out.update(_flatten(sub, key + "/"))
        else:
            out[key] = np.asarray(sub)
    return out


def _unflatten(schema: Dict[str, Any], arrays: Dict[str, np.ndarray],
               prefix: str = "") -> Dict[str, Any]:
    """The tree of ``schema`` (nested :class:`ParamDef`) from the file's
    arrays, each checked against its leaf's shape."""
    out = {}
    for name, sub in schema.items():
        key = f"{prefix}{name}"
        if isinstance(sub, ParamDef):
            arr = arrays[key]
            if tuple(arr.shape) != tuple(sub.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {sub.shape}")
            out[name] = arr
        else:
            out[name] = _unflatten(sub, arrays, key + "/")
    return out


def save_checkpoint(ckpt_dir: str, step: int, params: Transformer,
                    opt_state: Optional[Dict[str, Any]] = None,
                    meta: Optional[Dict[str, Any]] = None,
                    keep: int = 3, host: int = 0) -> str:
    cfg = params.cfg
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, f"params_{host}.npz"),
             **_flatten(convert.params_to_reference(cfg, params)))
    if opt_state is not None:
        np.savez(os.path.join(tmp, f"opt_{host}.npz"),
                 **_flatten(convert.opt_state_to_reference(cfg, opt_state)))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "time": time.time(), **(meta or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def _list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            out.append(int(name.split("_")[1]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, params_template: Transformer,
                       opt_template: Optional[Dict[str, Any]] = None,
                       step: Optional[int] = None, host: int = 0,
                       ) -> Tuple[Transformer, Optional[Dict[str, Any]],
                                  Dict[str, Any]]:
    """New parameters (and optimizer state, when ``opt_template`` is given)
    on the template's device, from the step's files (default: the
    latest)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    cfg = params_template.cfg
    device = next(params_template.parameters()).device
    schema = convert.reference_schema(cfg)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with np.load(os.path.join(d, f"params_{host}.npz")) as z:
        params = convert.params_from_reference(
            cfg, _unflatten(schema, dict(z)), device)
    opt_state = None
    if opt_template is not None:
        with np.load(os.path.join(d, f"opt_{host}.npz")) as z:
            arrays = dict(z)
        opt_state = convert.opt_state_from_reference(cfg, {
            "m": _unflatten(schema, arrays, "m/"),
            "v": _unflatten(schema, arrays, "v/"),
            "step": arrays["step"]}, device)
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    return params, opt_state, meta
