"""What the readers of the program's own spans share.

The port marks its layer boundaries with spans (``repro_torch.spans``):
``train_step`` holds ``forward``, ``loss``, ``backward`` and ``optimizer``;
``prefill`` and ``decode_step`` hold ``forward``, whose layers each hold a
``mixer`` and an ``ffn``, and whose readout is ``head``.  A span records
only while a profiler runs, so after a ``--trace 1`` run the program's
store holds the records of the traced units and nothing else.  Each
record's device time comes from a pair of CUDA events on the compute
stream.

A reader sums the device ms of one span over every occurrence under one
top-level span and divides by the count of those top-level spans, which
must equal the trace's units.  It returns None where the run has no trace,
the program no such record (a program without the spans) or no device
time (a CPU run).
"""

from __future__ import annotations

import sys

from .ref import model as ref_model

PREFIX = "repro_torch."


def program_records():
    """The program's span records, or None where the program has no spans
    (nothing is imported: a run that used the spans has their module)."""
    spans = sys.modules.get(PREFIX + "spans")
    return None if spans is None else spans.records()


def layers(run, part: str) -> int:
    """The cell's layers that hold a ``part`` (``"mixer"`` or ``"ffn"``)."""
    blocks = ref_model.blocks(run.cell.config)
    if part == "mixer":
        return len(blocks)
    return sum(1 for _, ffn in blocks if ffn != "none")


def span_ms(run, kind: str, top: str, name: str, per_unit: int = 1):
    """Device ms a unit in the spans ``name`` under the top-level spans
    ``top``, each unit holding ``per_unit`` of them; raises where the
    records disagree with the trace or the model."""
    t = run.trace
    if run.kind != kind or t is None:
        return None
    records = program_records()
    if not records:
        return None
    tops = {r.id for r in records
            if r.parent is None and r.name == PREFIX + top}
    if not tops:
        return None
    if len(tops) != t.units:
        raise ValueError(f"spans: {len(tops)} top-level {top!r} spans in a "
                         f"trace of {t.units} units")
    hits = [r for r in records if r.name == PREFIX + name and r.top in tops]
    if len(hits) != per_unit * t.units:
        raise ValueError(f"spans: {len(hits)} {name!r} spans under "
                         f"{t.units} {top!r}; the model makes {per_unit} a "
                         f"unit")
    times = [r.device_ms for r in hits]
    if not times or any(ms is None for ms in times):
        return None
    return sum(times) / t.units
