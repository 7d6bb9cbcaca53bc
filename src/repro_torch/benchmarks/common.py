"""Shared benchmark fixtures: catalog, the paper's 20 scenarios, and the
masks that make two runs' records and lines comparable."""

from __future__ import annotations

import re
from typing import List, Tuple

from ..core import Request, generate_catalog
from ..examples import masked_walls

#: the record fields that hold a wall: every driver's ``us_per_call``,
#: fig6b's and fig7's and the benches' ``wall_s``, fig12's
#: ``recovery_s_ours`` and bench_risk's ``decision_overhead_us`` (best-of
#: walls and their ratio)
WALL_FIELDS = ("us_per_call", "wall_s", "recovery_s_ours",
               "decision_overhead_us")
#: the benches' record of the host they ran on
PLATFORM_FIELDS = ("python", "numpy", "machine")

#: §5.1: Cartesian {10,50,100,400,1000} × {(1,2),(2,2),(1,4)} + 5 irregular
SCENARIOS: List[Tuple[int, float, float]] = (
    [(p, c, m) for p in (10, 50, 100, 400, 1000)
     for c, m in ((1, 2), (2, 2), (1, 4))]
    + [(17, 7, 7), (75, 3, 5), (115, 4, 2), (287, 1, 6), (439, 1, 9)]
)


def catalog(seed: int = 0, max_offerings: int = 2000):
    return generate_catalog(seed=seed, max_offerings=max_offerings)


def requests() -> List[Request]:
    return [Request(pods=p, cpu_per_pod=c, mem_per_pod=m)
            for p, c, m in SCENARIOS]


def masked_csv(text: str) -> str:
    """The runner's ``name,us_per_call,derived`` lines with every field
    that prints a wall masked: each line's ``us_per_call``, the ``{:.2f}s``
    walls (:func:`repro_torch.examples.masked_walls`), fig12's
    ``recovery_ours=0.06s`` (``_`` follows it, so ``\\b`` finds no edge
    there) and bench_risk's ``overhead=1.379x`` (a ratio of two walls):
    what two runs of one driver print alike."""
    lines = []
    for line in text.split("\n"):
        fields = line.split(",", 2)
        if len(fields) == 3 and fields[0] != "name":
            fields[1] = "<us>"
        lines.append(",".join(fields))
    text = masked_walls("\n".join(lines))
    text = re.sub(r"recovery_ours=\d+\.\d\ds", "recovery_ours=<s>", text)
    return re.sub(r"overhead=\d+(\.\d+)?x", "overhead=<x>", text)


def without(record, fields=WALL_FIELDS):
    """``record`` with each dict key in ``fields`` dropped at any depth
    (tuples become lists): what two runs of one driver return alike."""
    if isinstance(record, dict):
        return {k: without(v, fields) for k, v in record.items()
                if k not in fields}
    if isinstance(record, (list, tuple)):
        return [without(v, fields) for v in record]
    return record
