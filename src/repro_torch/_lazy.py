"""Lazy imports that cut the package's import cycles.

``chaos.guard``, ``region.policy`` and ``serve_sim.sim`` import the
simulation layer, which imports their packages back; the reference cuts
those cycles with imports inside functions and PEP 562 ``__getattr__``,
and so does this package.  :func:`import_lazy` is that import, with one
difference: a module this package does not have yet raises an
``ImportError`` that names it, instead of a bare attribute error.
"""

from __future__ import annotations

import importlib
import importlib.util


def import_lazy(name: str, package: str):
    """``importlib.import_module(name, package)``; a module missing from
    this package raises an ``ImportError`` naming it."""
    full = importlib.util.resolve_name(name, package)
    try:
        return importlib.import_module(full)
    except ModuleNotFoundError as exc:
        if exc.name != full:
            raise
        raise ImportError(f"{full} is not ported yet", name=full) from exc
