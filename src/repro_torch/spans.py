"""Spans at the port's layer boundaries, on the profiler's clock.

``with spans.span("forward"):`` marks one call of a layer.  Unless a
``torch.profiler`` is recording, it returns one shared no-op context: no
record, no CUDA event, no allocation.  The profiler that the caller already
runs is the only switch; this module has no exporter and writes no file.

While a profiler records, a span

* opens a ``RecordFunctionFast`` range named ``repro_torch.<name>``: a host
  op on the trace's timeline, on the device trace's clock.  It is not a
  user annotation (``record_function``'s), which kineto would mirror onto
  the device timeline as an event of its own;
* appends a :class:`Record` to an in-memory store: its name, its parent
  (the innermost span open in the process, not in the thread: on CUDA the
  caller waits in ``torch.autograd.grad`` while autograd's own thread runs
  the backward, so the remat recompute nests under ``backward``), its
  top-level span, and its host start and end (``time.perf_counter_ns``);
* where CUDA is initialised, records a pair of timing events on the current
  stream: :attr:`Record.device_ms`, read when asked for.  Elsewhere the
  device time is None.

The store keeps the records of the last :data:`KEEP` top-level spans.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import time
from typing import Deque, List, Optional

import torch

PREFIX = "repro_torch."
#: top-level spans whose records the store keeps
KEEP = 64

_enabled = torch.autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_ids = itertools.count()
#: spans open in the process, outermost first
_open: List["_Span"] = []
#: the records of each kept top-level span, oldest first
_groups: Deque[List["Record"]] = collections.deque(maxlen=KEEP)


class Record:
    """One call of a span; ``parent`` and ``top`` are ``id``s of records
    (``top`` is the record's own for a top-level span, ``parent`` None)."""

    __slots__ = ("id", "name", "parent", "top", "start_ns", "end_ns",
                 "_start", "_end")

    def __init__(self, name: str, parent: Optional["Record"]):
        self.id = next(_ids)
        self.name = name
        self.parent = parent.id if parent is not None else None
        self.top = parent.top if parent is not None else self.id
        self.start_ns = self.end_ns = None
        self._start = self._end = None

    @property
    def host_ms(self) -> Optional[float]:
        """Host time from the span's start to its end; None while open."""
        if self.end_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Time on the stream between the span's two events; waits for the
        second.  None without CUDA or while the span is open."""
        if self._end is None:
            return None
        self._end.synchronize()
        return self._start.elapsed_time(self._end)


class _Span:
    """An open span: its record and the list of its top-level span's
    records, which its children join."""

    __slots__ = ("record", "group", "_range")

    def __init__(self, name: str):
        parent = _open[-1] if _open else None
        self.record = Record(PREFIX + name, parent and parent.record)
        if parent is None:
            self.group = []
            _groups.append(self.group)
        else:
            self.group = parent.group
        self.group.append(self.record)

    def __enter__(self) -> "Record":
        rec = self.record
        self._range = torch._C._profiler._RecordFunctionFast(rec.name)
        self._range.__enter__()
        _open.append(self)
        if torch.cuda.is_initialized():
            rec._start = torch.cuda.Event(enable_timing=True)
            rec._start.record()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> None:
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if rec._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec._end = end
        _open.remove(self)
        self._range.__exit__(*exc)


def span(name: str):
    """A context for one call of the layer ``name`` (recorded as
    ``repro_torch.<name>``); the shared no-op unless a profiler records."""
    if not _enabled():
        return _NOOP
    return _Span(name)


def records() -> List[Record]:
    """The kept records, each top-level span's in the order they opened."""
    return [r for group in _groups for r in group]


def clear() -> None:
    """Empty the store (spans still open keep recording)."""
    _groups.clear()
