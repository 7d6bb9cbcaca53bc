"""Process-wide degradation-event registry (DESIGN.md §16).

The reference solver stack degrades in several deliberate ways (backend
fallbacks, kernel self-checks disabling a kernel, the chaos guard's
ladder descents); the port's decision plane has no such fallback and
raises instead.  Each of those used to announce itself with a one-time
``warnings.warn`` and nothing else, which makes degradation invisible in
a fleet run's results: stderr is not a metrics channel.

This module centralizes those events into a tiny counter registry:

* every occurrence is **counted** (``count``), whether or not it warns;
* ``warn_once`` keeps the existing one-warning-per-process contract for
  human eyes while still counting every occurrence;
* the sim engines snapshot the registry at run start and merge the
  *delta* into ``SimResult.cache_stats`` under ``event_*`` keys, so a
  fleet sweep reports "the jax backend silently fell back to NumPy" as
  data, not as a line lost in CI logs.

Counters are process-global and monotonically increasing (like the
warning flags they replace).  They are deliberately **not** part of any
decision, trace record, or metric dict — the determinism contract
(DESIGN.md §9) is untouched; ``cache_stats`` is already exempt from
trace/equality comparisons.  ``reset`` exists for test isolation only.
"""

from __future__ import annotations

import threading
import warnings
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, int] = {}
_warned_keys = set()


def count(name: str, n: int = 1) -> int:
    """Increment counter ``name`` by ``n``; returns the new value."""
    with _lock:
        value = _counters.get(name, 0) + int(n)
        _counters[name] = value
        return value


def warn_once(name: str, message: str, category=RuntimeWarning,
              stacklevel: int = 2) -> bool:
    """Count this occurrence and emit ``message`` the first time only.

    Returns True when the warning was actually emitted (first occurrence
    for this key in the process), False on every repeat — the same
    contract the module-level ``_WARNED`` flags used to provide, minus
    the scattering.
    """
    count(name)
    with _lock:
        if name in _warned_keys:
            return False
        _warned_keys.add(name)
    warnings.warn(message, category, stacklevel=stacklevel + 1)
    return True


def counters() -> Dict[str, int]:
    """A point-in-time copy of every counter."""
    with _lock:
        return dict(_counters)


def snapshot() -> Dict[str, int]:
    """Alias of :func:`counters` that reads as intent at call sites that
    later diff against it with :func:`delta_since`."""
    return counters()


def delta_since(snap: Dict[str, int]) -> Dict[str, int]:
    """Counters that moved since ``snap`` (only non-zero deltas)."""
    now = counters()
    out = {}
    for name, value in now.items():
        moved = value - snap.get(name, 0)
        if moved:
            out[name] = moved
    return out


def reset() -> None:
    """Clear all counters and warn-once keys (test isolation only)."""
    with _lock:
        _counters.clear()
        _warned_keys.clear()


__all__ = ["count", "counters", "delta_since", "reset", "snapshot",
           "warn_once"]
