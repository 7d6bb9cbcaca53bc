"""JSONL trace recording and loading (schema: ``repro_torch.sim.events``).

A trace is a list of dict records, one JSON object per line, serialized
with ``sort_keys=True`` so that identical runs produce byte-identical
files (the determinism contract of DESIGN.md §9).  The recorder is
in-memory first — ``ClusterSim`` always records — and ``dump``/``dumps``
materialize the JSONL on demand.
"""

from __future__ import annotations

import json
from typing import Dict, List


class TraceRecorder:
    """Append-only in-memory record sink with JSONL (de)materialization."""

    def __init__(self) -> None:
        self.records: List[Dict] = []

    def write(self, record: Dict) -> None:
        self.records.append(record)

    def dumps(self) -> str:
        return "\n".join(json.dumps(r, sort_keys=True)
                         for r in self.records) + "\n"

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())


def loads_trace(text: str) -> List[Dict]:
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def load_trace(path: str) -> List[Dict]:
    with open(path) as f:
        return loads_trace(f.read())
