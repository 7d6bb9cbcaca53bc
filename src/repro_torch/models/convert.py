"""Parameters, optimizer state and caches across from the reference's
pytrees.

The reference stacks the ``scan_period`` layers of its body: leaf ``[p]`` of
``body[j]`` is layer ``prefix_layers + p·scan_period + j``; ``prefix[i]`` is
layer ``i``.  These functions take such trees with array leaves (numpy, or
anything ``np.asarray`` reads) and fill the port's unrolled modules,
optimizer moments and per-layer cache dicts, or give the port's back in the
reference's layout as numpy arrays.  Tests hold the two packages to each
other through them, and a checkpoint holds the reference's tree, so that
either package resumes from the other's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from .layers import ParamDef
from .transformer import Caches, Transformer, flat_schema, model_schema


def _tensor(a, like_dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(a)                         # a writable copy
    if arr.dtype.kind != "f" or arr.dtype.itemsize < 4:
        arr = arr.astype(np.float32)          # bfloat16 and friends
    return torch.from_numpy(arr).to(device=device, dtype=like_dtype)


def _layer_source(cfg: ModelConfig, i: int) -> Tuple[str, str, Any]:
    """Where layer ``i`` lives in a reference tree: ``("prefix", "i",
    None)`` or ``("body", "j", p)`` (index ``p`` of each stacked leaf)."""
    if i < cfg.prefix_layers:
        return "prefix", str(i), None
    p, j = divmod(i - cfg.prefix_layers, cfg.scan_period)
    return "body", str(j), p


def _get(tree: Dict[str, Any], path: str):
    for key in path.split("."):
        tree = tree[key]
    return tree


def _source(cfg: ModelConfig, tree: Dict[str, Any], path: str
            ) -> np.ndarray:
    """The reference tree's array for the port leaf at ``path``."""
    parts = path.split(".")
    if parts[0] == "layers":
        where, key, p = _layer_source(cfg, int(parts[1]))
        src = _get(tree[where][key], ".".join(parts[2:]))
        return np.asarray(src) if p is None else np.asarray(src)[p]
    return np.asarray(_get(tree, path))


def _fill(cfg: ModelConfig, tree: Dict[str, Any], targets) -> None:
    """Copy the reference tree's values into ``targets`` (``path`` ->
    tensor of the port leaf's shape)."""
    with torch.no_grad():
        for path, pd in flat_schema(model_schema(cfg)):
            src = _source(cfg, tree, path)
            if tuple(src.shape) != tuple(pd.shape):
                raise ValueError(f"{path}: reference shape {src.shape}, "
                                 f"port shape {pd.shape}")
            if src.dtype.kind != "f" or src.dtype.itemsize < 4:
                src = src.astype(np.float32)  # bfloat16 and friends
            elif not src.flags.writeable:
                src = src.copy()
            targets(path).copy_(torch.from_numpy(src))


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` (``None``: the card) holding
    the reference ``init_params`` tree's values."""
    model = Transformer(cfg, resolve_device(device))
    _fill(cfg, tree, model.get_parameter)
    return model


def reference_schema(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree as nested dicts of :class:`ParamDef`:
    ``embed``, ``prefix/<i>``, ``body/<j>`` (leaves stacked over the
    ``n_periods`` periods), ``final_norm`` and ``unembed``."""
    def nest(tree, keys, pd):
        for k in keys[:-1]:
            tree = tree.setdefault(k, {})
        tree[keys[-1]] = pd

    out: Dict[str, Any] = {"prefix": {}, "body": {}}
    for path, pd in flat_schema(model_schema(cfg)):
        parts = path.split(".")
        if parts[0] != "layers":
            nest(out, parts, pd)
            continue
        where, key, p = _layer_source(cfg, int(parts[1]))
        if p is None:
            nest(out, [where, key] + parts[2:], pd)
        elif p == 0:
            nest(out, [where, key] + parts[2:], ParamDef(
                (cfg.n_periods,) + pd.shape, ("layers",) + pd.axes, pd.init))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype not in (torch.float32, torch.float64, torch.int32,
                       torch.int64):
        t = t.float()                         # bfloat16 and friends
    return t.cpu().numpy()


def _to_reference(cfg: ModelConfig, leaf) -> Dict[str, Any]:
    """The reference tree of the port leaves ``leaf(path)``, as numpy."""
    def value(keys: List[str]) -> np.ndarray:
        rest = ".".join(keys[2:])
        if keys[0] == "prefix":
            return _host(leaf(f"layers.{keys[1]}.{rest}"))
        if keys[0] == "body":
            first = cfg.prefix_layers + int(keys[1])
            return _host(torch.stack([           # stacked on the device
                leaf(f"layers.{first + p * cfg.scan_period}.{rest}")
                for p in range(cfg.n_periods)]))
        return _host(leaf(".".join(keys)))

    def walk(schema: Dict[str, Any], keys: List[str]) -> Dict[str, Any]:
        return {name: value(keys + [name]) if isinstance(sub, ParamDef)
                else walk(sub, keys + [name])
                for name, sub in schema.items()}

    return walk(reference_schema(cfg), [])


def params_to_reference(cfg: ModelConfig, params) -> Dict[str, Any]:
    """The inverse of :func:`params_from_reference`: ``params`` (a
    :class:`Transformer`, or a mapping from its parameter paths to tensors
    such as gradients) in the reference's tree, body layers restacked per
    period, as numpy."""
    leaf = (params.get_parameter if isinstance(params, Transformer)
            else params.__getitem__)
    return _to_reference(cfg, leaf)


def opt_state_to_reference(cfg: ModelConfig, state: Dict[str, Any]
                           ) -> Dict[str, Any]:
    """The port's AdamW state (``optim.init_opt_state``: moments keyed by
    parameter path) as the reference's ``{"m", "v", "step"}`` tree."""
    return {"m": params_to_reference(cfg, state["m"]),
            "v": params_to_reference(cfg, state["v"]),
            "step": np.asarray(int(state["step"]), dtype=np.int32)}


def opt_state_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                             device=None) -> Dict[str, Any]:
    """The port's AdamW state on ``device`` (``None``: the card) from the
    reference's ``{"m", "v", "step"}`` tree."""
    dev = resolve_device(device)
    out: Dict[str, Any] = {}
    for name in ("m", "v"):
        moments = {path: torch.empty(pd.shape, dtype=torch.float32,
                                     device=dev)
                   for path, pd in flat_schema(model_schema(cfg))}
        _fill(cfg, tree[name], moments.__getitem__)
        out[name] = moments
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=dev)
    return out


def caches_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device=None) -> Caches:
    """The port's per-layer cache dicts from a reference cache tree."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    out = []
    for i in range(cfg.n_layers):
        where, key, p = _layer_source(cfg, i)
        sub = tree[where][key]
        layer = {}
        for name, a in sub.items():
            arr = np.asarray(a) if p is None else np.asarray(a)[p]
            src_dt = torch.float32 if arr.dtype == np.float32 else dt
            layer[name] = _tensor(arr, src_dt, dev)
        out.append(layer)
    return out


def caches_to_reference(cfg: ModelConfig, caches: Caches
                        ) -> Dict[str, Dict[str, Dict[str, np.ndarray]]]:
    """The port's caches in the reference's layout, as float32 numpy
    arrays (body leaves stacked over periods)."""
    def host(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    out: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {"prefix": {},
                                                         "body": {}}
    for i in range(cfg.prefix_layers):
        out["prefix"][str(i)] = {k: host(v) for k, v in caches[i].items()}
    for j in range(cfg.scan_period):
        layers: List[Dict[str, torch.Tensor]] = [
            caches[cfg.prefix_layers + p * cfg.scan_period + j]
            for p in range(cfg.n_periods)]
        out["body"][str(j)] = {k: np.stack([host(c[k]) for c in layers])
                               for k in layers[0]}
    return out
