"""Carry a scenario across from the JAX package.

A :class:`~repro_torch.sim.scenario.Scenario` is plain JSON-serializable
values — the trace header alone replays a run — so the reference
package's scenario crosses over through its own ``to_dict()`` and this
package's :meth:`Scenario.from_dict`, faults, shocks and the
``RegionConfig`` included, without this package importing the other.
Catalogs cross over through
:func:`repro_torch.core.convert.catalog_from_reference`.
"""

from __future__ import annotations

from .scenario import Scenario


def scenario_from_reference(ref_scenario) -> Scenario:
    """The port's scenario, equal field for field to ``ref_scenario`` (any
    object with the reference schema's ``to_dict()``)."""
    return Scenario.from_dict(ref_scenario.to_dict())
