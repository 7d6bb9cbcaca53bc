"""Workload-aware performance scaling (paper §3.3, Eq. 8) — the Karpenter
scaling integration point.

CoreMark can't see network/disk hardware, so for instances whose
specialization matches the declared workload intent the benchmark score is
scaled by the on-demand price ratio to the general-purpose sibling
(symbols as in Table 1 / DESIGN.md):

    BS_i^scaled = BS_i × OP_i / OP_base          (Eq. 8)

where ``OP_base`` is the on-demand price of the general-purpose sibling
``{family}{gen}{vendor}.{size}`` (:meth:`Offering.base_instance_type`,
indexed by :func:`build_base_price_index`).  The rationale: AWS prices the
`n`/`d`/`dn` premium at the value of the specialized hardware, so the
od-price ratio is a market-calibrated proxy for the network/disk
performance CoreMark misses.

Integration with the Karpenter scaling path: this runs inside
DatasetPreProcessing (Alg. 1 lines 3–6, `provisioner.preprocess`) — i.e.
in the same controller pass that Karpenter's provisioner uses to build its
candidate list — *before* the ILP sees the candidates, so the scaled
``BS_i`` flows into ``Perf_i = BS_i·Pod_i`` and hence into both the Eq. 4–5
objective normalization (``Perf_i/Perf_min``) and the Eq. 2 E_PerfCost
score.  Non-matching specializations stay unscaled (the paper's c6id
example); no declared intent ⇒ no scaling.  A wrong intent only
mis-weights specialization; it never breaks feasibility or availability
(paper §3.3 last paragraph).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Set

from .market import Offering

#: specialization kind -> the intents it serves
_SPEC_TO_INTENTS = {
    "general": frozenset(),
    "network": frozenset({"network"}),
    "disk": frozenset({"disk"}),
    "network+disk": frozenset({"network", "disk"}),
}


def build_base_price_index(catalog: Iterable[Offering]) -> Dict[str, float]:
    """Map base_instance_type -> on-demand price of the general-purpose sibling.

    Prices are AZ-independent on AWS; we take the first general offering seen
    for each (family, gen, vendor, size).
    """
    index: Dict[str, float] = {}
    for o in catalog:
        if o.specialization == "general" and o.instance_type not in index:
            index[o.instance_type] = o.od_price
    return index


def matches_intent(offering: Offering, workload: Set[str]) -> bool:
    """Does this offering's specialization serve any declared intent?"""
    serves = _SPEC_TO_INTENTS[offering.specialization]
    return bool(serves & workload)


def scaled_benchmark_score(offering: Offering, workload: Set[str],
                           base_price_index: Dict[str, float]) -> float:
    """Eq. 8 applied per-offering; single-core BS in, scaled BS out."""
    if not workload or not matches_intent(offering, workload):
        return offering.bs_core
    op_base = base_price_index.get(offering.base_instance_type)
    if op_base is None or op_base <= 0:
        # No general sibling in the candidate universe: leave unscaled
        # rather than invent a base price.
        return offering.bs_core
    return offering.bs_core * (offering.od_price / op_base)
