"""ChaosPlane: deterministic fault injection + degraded-mode provisioning.

Two halves (DESIGN.md §16):

- :mod:`repro_torch.chaos.faults` — the fault models and the
  :class:`ChaosController` that applies them to observed market feeds.
  Import-light (numpy only) so the sim layer can depend on it freely.
- :mod:`repro_torch.chaos.guard` — the hardened policy / degradation ladder.
  Imported lazily (PEP 562) because it depends on :mod:`repro_torch.sim.policy`,
  which itself reaches back to :mod:`repro_torch.chaos.faults` via the scenario
  schema.
"""

from .faults import (FAULT_KINDS, FEED_KINDS, REGION_KINDS, SOLVER_KINDS,
                     ChaosController, Fault, fault_storm, region_storm)

_GUARD_SYMBOLS = ("DEFAULT_LADDER", "GuardConfig", "HardenedPolicy",
                  "backoff_schedule", "check_decision",
                  "decision_available", "quarantine_mask", "safe_pool")

__all__ = ["FAULT_KINDS", "FEED_KINDS", "REGION_KINDS", "SOLVER_KINDS",
           "ChaosController", "Fault", "fault_storm", "region_storm",
           *_GUARD_SYMBOLS]


def __getattr__(name):
    if name in _GUARD_SYMBOLS:
        from . import guard
        return getattr(guard, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
