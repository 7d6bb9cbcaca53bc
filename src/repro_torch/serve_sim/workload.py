"""Deterministic request-rate traces + queueing-theoretic capacity staffing.

The serving co-simulation (DESIGN.md §15) is driven by a per-interval
arrival-rate trace λ(t) in requests/second — the aggregate of millions of
users, each a sparse Poisson source, so λ is the only statistic that
matters (the per-user streams never need simulating).  Three canonical
shapes cover the production regimes the provisioning plane must absorb:

* ``diurnal`` — the 24 h sinusoidal day/night cycle every consumer
  service shows, plus small seeded per-interval noise;
* ``bursty``  — the diurnal base with seeded lognormal bursts landing on
  random intervals (push notifications, batch retries);
* ``flash``   — the diurnal base with one flash-crowd window (a launch,
  an outage elsewhere) multiplying demand for a few hours.

Determinism contract (same as DESIGN.md §9): a trace is a *pure function*
of its :class:`WorkloadSpec` — every draw comes from a fresh
``np.random.default_rng`` seeded by the spec's fields, so the same spec
produces byte-identical float64 arrays in any process, any call order.
:func:`trace_digest` pins that as a checkable hash.

Capacity staffing implements the square-root safety rule (the Halfin-Whitt
regime of M/M/c): to keep queueing delay negligible at offered load
ρ = λ/μ, provision ``c = ⌈ρ + β·√ρ⌉`` servers, not ⌈ρ⌉ — the √ρ headroom
is what absorbs stochastic arrival bursts within an interval, and β ≈ 1–2
corresponds to a ≲ few-% delay probability.  This is the "queueing-delay
headroom term" through which the ILP provisions *capacity*, not raw pods.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np

#: workload kind → seed-stream tag (keeps kinds on disjoint RNG streams
#: even at equal seeds)
_KIND_TAG = {"diurnal": 1, "bursty": 2, "flash": 3}

#: default square-root staffing safety factor β (≈1 % delay probability)
DEFAULT_STAFFING_BETA = 1.5


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One request-rate trace, fully determined by its fields."""

    kind: str = "diurnal"            # "diurnal" | "bursty" | "flash"
    base_qps: float = 1000.0         # trough-level arrival rate (req/s)
    peak_factor: float = 2.5         # diurnal peak / trough ratio
    duration_hours: float = 24.0
    step_hours: float = 1.0          # trace granularity (≙ sim tick)
    seed: int = 0
    noise: float = 0.03              # per-interval multiplicative jitter
    burst_factor: float = 2.0        # bursty: burst multiplier scale
    burst_rate: float = 0.15         # bursty: P(burst) per interval
    flash_factor: float = 4.0        # flash: crowd multiplier
    flash_hours: float = 2.0         # flash: crowd window length

    def __post_init__(self):
        if self.kind not in _KIND_TAG:
            raise ValueError(f"unknown workload kind {self.kind!r}; "
                             f"choose from {sorted(_KIND_TAG)}")
        for field in ("base_qps", "peak_factor", "duration_hours",
                      "step_hours", "noise", "burst_factor", "burst_rate",
                      "flash_factor", "flash_hours"):
            object.__setattr__(self, field, float(getattr(self, field)))
        object.__setattr__(self, "seed", int(self.seed))

    @property
    def n_steps(self) -> int:
        return max(1, int(math.ceil(self.duration_hours / self.step_hours
                                    - 1e-9)))

    def times(self) -> np.ndarray:
        """Interval start times (hours): λ[k] holds on [times[k], times[k+1])."""
        return np.arange(self.n_steps, dtype=np.float64) * self.step_hours

    def _rng(self) -> np.random.Generator:
        # stream-free determinism: a fresh generator per call, seeded only
        # by spec fields — the trace is a pure function of the spec
        return np.random.default_rng(
            (self.seed & 0xFFFFFFFF, _KIND_TAG[self.kind], self.n_steps))

    def trace(self) -> np.ndarray:
        """λ(t) per interval (req/s), float64, byte-identical per spec."""
        rng = self._rng()
        t = self.times()
        # diurnal base: trough at base_qps, peak at base·peak_factor,
        # peak mid-afternoon (hour 15 of each day)
        amp = 0.5 * (self.peak_factor - 1.0)
        phase = 2.0 * np.pi * (t % 24.0 - 15.0) / 24.0
        lam = self.base_qps * (1.0 + amp * (1.0 + np.cos(phase)))
        if self.noise > 0:
            lam = lam * (1.0 + self.noise
                         * (2.0 * rng.random(self.n_steps) - 1.0))
        if self.kind == "bursty":
            hit = rng.random(self.n_steps) < self.burst_rate
            mult = 1.0 + (self.burst_factor - 1.0) * rng.random(self.n_steps)
            lam = np.where(hit, lam * mult, lam)
        elif self.kind == "flash":
            n_flash = max(1, int(round(self.flash_hours / self.step_hours)))
            hi = max(1, self.n_steps - n_flash)
            start = int(rng.integers(self.n_steps // 4, max(hi,
                                                            self.n_steps // 4
                                                            + 1)))
            lam[start:start + n_flash] *= self.flash_factor
        return np.ascontiguousarray(lam, dtype=np.float64)


def trace_digest(spec: WorkloadSpec) -> str:
    """blake2b over the spec repr + raw trace bytes — the determinism
    contract as a comparable string (bench_serve verifies same seed ⇒
    identical digest before timing anything)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr(spec).encode())
    h.update(spec.trace().tobytes())
    return h.hexdigest()


def staffed_pods(lam_qps: float, qps_per_pod: float,
                 beta: float = DEFAULT_STAFFING_BETA) -> int:
    """Square-root staffing: pods needed to serve ``lam_qps`` with
    queueing-delay headroom.

    M/M/c with per-server rate μ = ``qps_per_pod`` and offered load
    ρ = λ/μ: ``c = ⌈ρ + β·√ρ⌉`` keeps the delay probability small and
    roughly constant as λ scales (Halfin-Whitt).  β = 0 degrades to the
    bare capacity floor ⌈ρ⌉."""
    if lam_qps <= 0:
        return 1
    if qps_per_pod <= 0:
        raise ValueError("qps_per_pod must be positive")
    rho = float(lam_qps) / float(qps_per_pod)
    return max(1, int(math.ceil(rho + float(beta) * math.sqrt(rho) - 1e-9)))


def demand_schedule_from_trace(spec: WorkloadSpec, qps_per_pod: float,
                               beta: float = DEFAULT_STAFFING_BETA,
                               ) -> tuple:
    """(initial_pods, ((time, pods), ...)) — the workload trace converted
    into the scenario engine's pod-demand schedule via square-root
    staffing.  Consecutive equal staffing levels are merged so the
    schedule only carries genuine capacity changes.  Policy-independent by
    construction: every compared policy provisions the same pod demand and
    differs only in *which* offerings provide it (DESIGN.md §15)."""
    lam = spec.trace()
    times = spec.times()
    staff = [staffed_pods(l, qps_per_pod, beta) for l in lam]
    initial = staff[0]
    schedule = []
    prev = initial
    for t, pods in zip(times[1:], staff[1:]):
        if pods != prev:
            schedule.append((float(t), int(pods)))
            prev = pods
    return initial, tuple(schedule)


__all__ = ["DEFAULT_STAFFING_BETA", "WorkloadSpec",
           "demand_schedule_from_trace", "staffed_pods", "trace_digest"]
