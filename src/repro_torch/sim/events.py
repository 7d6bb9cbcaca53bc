"""Event taxonomy + JSONL trace record schema of the scenario engine.

The engine (``repro_torch.sim.engine.ClusterSim``) is a discrete-event simulation;
everything that happens is one of a small set of timestamped events, and
every event is serializable to a one-line JSON record so a run can be
recorded to a JSONL trace and replayed bit-exactly (DESIGN.md §9).

Record types (``TRACE_VERSION = 1``):

==============  ============================================================
``header``      first line: schema version + the full Scenario spec
``tick``        the market is about to advance by ``hours``
``market_state``  live (spot, t3) vectors after a tick or shock — together
                with the seeded catalog these fully determine a snapshot
``shock``       a deterministic scheduled price/capacity shock was applied
``demand``      the demand schedule changed the requested pod count
``interrupts``  the interrupt notices sampled this tick (possibly empty),
                including fault-injected and rebalance-advisory notices
``fault``       a chaos fault window opened or closed (DESIGN.md §16) —
                diagnostic only; replay re-derives fault effects from the
                scenario spec, never from these records
``fulfillment`` per-offering granted node counts for a decision's pool
``probe``       a one-off fulfillment probe (Fig. 9 driver)
``decision``    a provisioning decision (pool, α*, metrics — wall time is
                deliberately excluded: records must be deterministic)
``summary``     last line: totals for quick inspection
==============  ============================================================

Determinism contract: floats round-trip exactly through ``json`` (CPython
serializes ``repr`` shortest-roundtrip), record key order is fixed by
``sort_keys=True``, and no wall-clock or RNG-state material is recorded.
Same seed ⇒ byte-identical trace; replay consumes ``market_state`` /
``interrupts`` / ``fulfillment`` records instead of RNG draws.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Sequence

from ..core.market import InterruptEvent

TRACE_VERSION = 1


@dataclasses.dataclass(frozen=True)
class InterruptNotice:
    """An interruption notice from a pluggable interrupt model.

    Generalizes the core :class:`InterruptEvent` with a warning lead time:
    the notice is *advisory* at ``time`` and capacity is actually reclaimed
    at ``time + lead_hours`` (the rebalance-recommendation model; the
    classic 2-minute warning is ``lead_hours == 0`` at simulation scale).
    """

    time: float
    offering_id: str
    count: int
    reason: str = "capacity-reclaim"
    lead_hours: float = 0.0

    @property
    def effective_time(self) -> float:
        return self.time + self.lead_hours

    def to_core(self) -> InterruptEvent:
        """The core event the §4.1 provisioner loop consumes."""
        return InterruptEvent(time=self.time, offering_id=self.offering_id,
                              count=self.count, reason=self.reason)

    def to_record(self) -> Dict:
        return {"time": self.time, "offering_id": self.offering_id,
                "count": self.count, "reason": self.reason,
                "lead_hours": self.lead_hours}

    @classmethod
    def from_record(cls, rec: Dict) -> "InterruptNotice":
        return cls(time=rec["time"], offering_id=rec["offering_id"],
                   count=rec["count"], reason=rec["reason"],
                   lead_hours=rec["lead_hours"])


# ---------------------------------------------------------------------------
# Record constructors — one per trace record type
# ---------------------------------------------------------------------------

def catalog_digest(catalog) -> str:
    """Deterministic fingerprint of the offering universe a trace was
    recorded against.  Replay validates it so a trace can never be
    silently paired with a different catalog (same seed ⇒ same digest).
    Hashes every decision-relevant field — prices and capacity, the
    Eq. 1 resource dims, and the hazard inputs — so two catalogs that
    could produce different decisions can never share a digest."""
    h = hashlib.sha256()
    for o in catalog:
        h.update(f"{o.offering_id}|{o.spot_price}|{o.od_price}|{o.t3}|"
                 f"{o.bs_core}|{o.vcpus}|{o.mem_gib}|{o.sps_single}|"
                 f"{o.interruption_freq}|{o.specialization}\n".encode())
    return h.hexdigest()[:16]


def header_record(scenario_dict: Dict, n_offerings: int,
                  digest: str) -> Dict:
    return {"type": "header", "version": TRACE_VERSION,
            "scenario": scenario_dict, "n_offerings": n_offerings,
            "catalog_digest": digest}


def tick_record(time: float, hours: float) -> Dict:
    return {"type": "tick", "time": time, "hours": hours}


def market_state_record(time: float, spot, t3) -> Dict:
    return {"type": "market_state", "time": time,
            "spot": [float(x) for x in spot], "t3": [int(x) for x in t3]}


def shock_record(time: float, kind: str, selector: str, factor: float,
                 affected: int) -> Dict:
    return {"type": "shock", "time": time, "kind": kind,
            "selector": selector, "factor": factor, "affected": affected}


def demand_record(time: float, pods: int) -> Dict:
    return {"type": "demand", "time": time, "pods": pods}


def interrupts_record(time: float,
                      notices: Sequence[InterruptNotice]) -> Dict:
    return {"type": "interrupts", "time": time,
            "notices": [n.to_record() for n in notices]}


def fault_record(time: float, kind: str, phase: str,
                 fault_index: int) -> Dict:
    """A fault window transition ("begin"/"end").  The scenario spec in
    the header already fully determines every fault effect (the chaos
    controller is a pure function of spec + market state), so these lines
    are human-readable provenance, not replay inputs."""
    return {"type": "fault", "time": time, "kind": kind, "phase": phase,
            "fault_index": int(fault_index)}


def fulfillment_record(time: float, grants: Dict[str, int]) -> Dict:
    return {"type": "fulfillment", "time": time,
            "grants": {k: int(v) for k, v in sorted(grants.items())}}


def probe_record(time: float, offering_id: str, requested: int,
                 granted: int) -> Dict:
    return {"type": "probe", "time": time, "offering_id": offering_id,
            "requested": requested, "granted": granted}


def decision_record(time: float, reason: str, policy: str, pool_counts: Dict[str, int],
                    alpha, metrics: Dict[str, float]) -> Dict:
    return {"type": "decision", "time": time, "reason": reason,
            "policy": policy,
            "pool": {k: int(v) for k, v in sorted(pool_counts.items())},
            "alpha": None if alpha is None else float(alpha),
            "metrics": {k: float(v) for k, v in sorted(metrics.items())}}


def summary_record(time: float, total_cost: float, interrupted_nodes: int,
                   decisions: int, final_pool: Dict[str, int]) -> Dict:
    return {"type": "summary", "time": time, "total_cost": total_cost,
            "interrupted_nodes": interrupted_nodes, "decisions": decisions,
            "final_pool": {k: int(v) for k, v in sorted(final_pool.items())}}
