"""KubePACS on PyTorch and CUDA: the port of the ``repro`` package.

Entry points run on the card unless the caller asks for the CPU:
:func:`resolve_device` is the one place that decides.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device without CUDA raises.  The
    CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or the 'torch:cpu' "
            "backend spec) to run on the host explicitly")
    return dev


from .core import *  # noqa: E402,F401,F403  (the control plane's exports)
from .core import __all__ as _core_all  # noqa: E402

__all__ = ["resolve_device", *_core_all]
