"""Parameters and caches across from the reference's pytrees.

The reference stacks the ``scan_period`` layers of its body: leaf ``[p]`` of
``body[j]`` is layer ``prefix_layers + p·scan_period + j``; ``prefix[i]`` is
layer ``i``.  These functions take such trees with array leaves (numpy, or
anything ``np.asarray`` reads) and fill the port's unrolled modules and
per-layer cache dicts, or give the port's caches back in the reference's
layout as numpy arrays, so that tests can hold the two to each other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
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


def params_from_reference(cfg: ModelConfig, tree: Dict[str, Any],
                          device=None) -> Transformer:
    """A :class:`Transformer` on ``device`` (``None``: the card) holding
    the reference ``init_params`` tree's values."""
    dev = resolve_device(device)
    with torch.no_grad():
        model = Transformer(cfg, dev)
        for path, pd in flat_schema(model_schema(cfg)):
            parts = path.split(".")
            if parts[0] == "layers":
                where, key, p = _layer_source(cfg, int(parts[1]))
                src = _get(tree[where][key], ".".join(parts[2:]))
                src = np.asarray(src) if p is None else np.asarray(src)[p]
            else:
                src = np.asarray(_get(tree, path))
            param = model.get_parameter(path)
            if tuple(src.shape) != tuple(pd.shape):
                raise ValueError(f"{path}: reference shape {src.shape}, "
                                 f"port shape {pd.shape}")
            param.copy_(_tensor(src, param.dtype, dev))
    return model


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
