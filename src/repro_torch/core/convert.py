"""Carry market state across from the JAX package.

The decision plane has no weights: its state is the market — the offering
catalog and the preprocessed candidate items.  These helpers rebuild the
port's :class:`~repro_torch.core.market.Offering` and
:class:`~repro_torch.core.efficiency.CandidateItem` from any dataclass
instances with the same fields (the reference package's, duck-typed via
``dataclasses.asdict``), so both packages can solve one market without this
package importing the other.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

from .efficiency import CandidateItem
from .market import Offering


def catalog_from_reference(offerings: Iterable) -> List[Offering]:
    """The port's offerings, field for field equal to ``offerings``."""
    return [Offering(**dataclasses.asdict(o)) for o in offerings]


def items_from_reference(items: Iterable) -> List[CandidateItem]:
    """The port's candidate items, field for field equal to ``items``."""
    out = []
    for it in items:
        fields = dataclasses.asdict(it)
        fields["offering"] = Offering(**fields["offering"])
        out.append(CandidateItem(**fields))
    return out
