"""Pluggable solver backends for the min-plus cover DP (DESIGN.md §12).

The ILP engine reduces every solve — single-α, a GSS prescan grid, or the
cross-decision batches of ``solve_ilp_many`` — to one primitive: a forward
min-plus value pass over a bundle sequence that also emits *improvement
bits*, the per-(bundle, coverage) booleans the exact backtracker consumes.
This module defines that primitive once, with two interchangeable
implementations:

* :class:`NumpyBackend` — the host path: a Python loop over bundles with
  in-place vectorized row updates.  The reference for the bit-identical
  selection contract.
* :class:`TorchBackend` — the device path: every dispatch stacks its groups
  ragged (no padding) and runs them in one launch of the hand-written CUDA
  kernel :func:`repro_torch.core.cover_dp.cover_dp`, one CTA per group.  On
  a CPU device (``"torch:cpu"``, what the tests use) it runs the kernel's
  plain torch version instead.

Canonical kernel semantics (every backend, float64):

    dp[0] = 0, dp[j>0] = +inf
    for b in 0..B-1:                       # bundle order is significant
        cand[j] = dp[max(j - pods[b], 0)] + cost[b]      (j >= 1)
        bits[b, j] = cand[j] < dp[j]                     (bits[b, 0] = False)
        dp[j]    = min(dp[j], cand[j])                   (dp[0] pinned at 0)

(The strict ``<`` needs no epsilon: dp values are exact subset-cost sums,
so a strict improvement at (b, j) means every optimal solution of the
bundle prefix uses b — the backtracker's take-rule — and equality means
skipping b is optimal.)

Every arithmetic step is an elementwise float64 op executed in the same
order by every implementation, so the resulting ``dp``/``bits`` are
bit-identical — which is what makes backend choice invisible to selections
(the backtracker's tie-breaking reads only ``bits``).

There is no fallback between backends: ``make_backend("torch")`` on a
machine without CUDA raises, and a failed build or launch fails the solve.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .cover_dp import CoverBatch, cover_dp

#: one (bpods, costs, target) residual covering problem; ``bpods`` int64
#: (all >= 1), ``costs`` float64 (may contain +inf), ``target`` >= 1
CoverGroup = Tuple[np.ndarray, np.ndarray, int]


@dataclasses.dataclass(frozen=True)
class CoarseningConfig:
    """Demand-coarsening policy for the residual cover DP (DESIGN.md §14).

    The engine solves residuals at or below ``threshold`` exactly — the
    default keeps every paper-scale scenario (≤ 5 k pods) byte-identical to
    the uncoarsened engine.  Above it:

    * **gcd mode** (provably exact, bit-identical selections): when the
      market's structural pod counts share a gcd ``g > 1`` and
      ``ceil(residual / g) <= max_rows``, the DP runs at granularity ``g``
      — same keep set (pruning stays unscaled), same improvement bits,
      same backtrack, 1/g of the rows.
    * **approx mode** (bounded suboptimality): otherwise, when
      ``allow_approx``, a greedy rate-order prefix of whole bundles is
      committed until at most ``approx_rows`` pods of demand remain, and
      an *exact* cover DP over the remaining bundles closes that boundary
      window — so the DP cost is that of an ``approx_rows``-pod residual
      regardless of demand.  The only loss is committing whole prefix
      bundles where the fractional optimum would split one, and the
      returned objective carries an a-posteriori certificate
      ``gap_bound = objective - LP(residual)`` (LP = the fractional-greedy
      lower bound, so the true optimality gap is ≤ ``gap_bound``); if the
      certificate exceeds ``rel_gap·|LP|`` the row is silently re-solved
      exactly (``coarse == "approx_fallback"`` in
      :class:`~repro_torch.core.ilp.IlpStats`).

    Lives in :mod:`repro_torch.core.backend` (not ``ilp``), as in the
    reference, where fused device programs replicate the same per-row mode
    decision; importing from ``ilp`` would create a cycle.  Frozen +
    hashable so configs can key solve-batch groups.
    """

    enabled: bool = True
    threshold: int = 8192
    max_rows: int = 4096
    approx_rows: int = 4096
    allow_approx: bool = True
    rel_gap: float = 0.05


#: process-wide default: coarsening on, but inert below 8192 residual pods,
#: so every existing scale solves byte-identically to the exact engine
DEFAULT_COARSENING = CoarseningConfig()

#: core-DP upper-bound tuning of the host engine (`repro_torch.core.ilp`):
#: the core DP runs over the best-rate ``max(k_greedy + _CORE_PAD,
#: _CORE_MIN)`` bundles and only triggers when the greedy bound leaves more
#: than ``_CORE_TRIGGER`` bundles alive.
_CORE_PAD = 33
_CORE_MIN = 96
_CORE_TRIGGER = 160


class SolverBackend:
    """Interface: batched cover-DP value passes with improvement bits."""

    name = "abstract"

    #: engine hint: decode in slices of at most this many DP groups so the
    #: bits arrays of one slice die before the next is computed (the host
    #: path is cache/allocator-sensitive; accelerator backends want the
    #: whole stack in one dispatch and override with a large value)
    max_group_batch = 1 << 30

    def cover_bits(self, groups: Sequence[CoverGroup],
                   ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """For each group return ``(dp, bits)`` — ``dp`` float64 of shape
        ``(target+1,)`` and ``bits`` bool of shape ``(B, target+1)`` — per
        the canonical kernel above.  Implementations may stack groups into
        one padded dispatch; returned arrays are trimmed numpy arrays."""
        raise NotImplementedError

    def cover_values(self, groups: Sequence[CoverGroup]) -> List[np.ndarray]:
        """Value-only variant: just each group's final ``dp`` vector (used
        for the engine's core upper bounds, where bits are never read)."""
        return [dp for dp, _bits in self.cover_bits(groups)]


class NumpyBackend(SolverBackend):
    """Host reference implementation (ragged — no padding waste).

    Runs each group's forward pass with preallocated scratch rows (the
    pass is memory-bandwidth-bound; allocator churn is the only other
    cost worth removing) and skips +inf bundles outright — an inert
    bundle's candidates never beat the running ``dp``, so skipping is
    exact.
    """

    name = "numpy"
    max_group_batch = 8      # keep the live bits working set cache-sized

    def cover_bits(self, groups):
        scratch = np.empty(max((g[2] for g in groups), default=0) + 1)
        return [self._one(bpods, costs, target, scratch)
                for bpods, costs, target in groups]

    def cover_values(self, groups):
        scratch = np.empty(max((g[2] for g in groups), default=0) + 1)
        return [self._values(bpods, costs, target, scratch)
                for bpods, costs, target in groups]

    @staticmethod
    def _values(bpods: np.ndarray, costs: np.ndarray, target: int,
                scratch: Optional[np.ndarray] = None) -> np.ndarray:
        if scratch is None:
            scratch = np.empty(target + 1)
        dp = np.full(target + 1, np.inf)
        dp[0] = 0.0
        for b in range(len(bpods)):
            cb = costs[b]
            if not np.isfinite(cb):
                continue
            pb = int(bpods[b])
            if pb <= target:
                k = target + 1 - pb
                cand = np.add(dp[:k], cb, out=scratch[:k])
                np.minimum(dp[pb:], cand, out=dp[pb:])
                if pb > 1:
                    np.minimum(dp[1:pb], cb, out=dp[1:pb])
            else:
                np.minimum(dp[1:], cb, out=dp[1:])
        return dp

    @staticmethod
    def _one(bpods: np.ndarray, costs: np.ndarray, target: int,
             scratch: Optional[np.ndarray] = None,
             ) -> Tuple[np.ndarray, np.ndarray]:
        B = len(bpods)
        if scratch is None:
            scratch = np.empty(target + 1)
        dp = np.full(target + 1, np.inf)
        dp[0] = 0.0
        # every finite bundle's row is fully written below (j >= 1) and the
        # j = 0 column is blanked at the end, so empty beats zeros here
        bits = np.empty((B, target + 1), dtype=bool)
        for b in range(B):
            cb = costs[b]
            if not np.isfinite(cb):
                bits[b] = False   # cand = x + inf never beats dp
                continue
            pb = int(bpods[b])
            if pb <= target:
                # j in [pb, target]: cand = dp[j - pb] + cb (pre-update dp;
                # the scratch row materializes before the in-place writes)
                k = target + 1 - pb
                cand = np.add(dp[:k], cb, out=scratch[:k])
                np.less(cand, dp[pb:], out=bits[b, pb:])
                np.minimum(dp[pb:], cand, out=dp[pb:])
                if pb > 1:        # j in [1, pb-1]: cand = dp[0] + cb = cb
                    np.less(cb, dp[1:pb], out=bits[b, 1:pb])
                    np.minimum(dp[1:pb], cb, out=dp[1:pb])
            else:                 # pb > target: cand = cb for every j >= 1
                np.less(cb, dp[1:], out=bits[b, 1:])
                np.minimum(dp[1:], cb, out=dp[1:])
        bits[:, 0] = False
        return dp, bits


class TorchBackend(SolverBackend):
    """Cover DP through the CUDA kernel, one launch per dispatch.

    ``device=None`` means the card (``"cuda"``), and construction raises
    when there is none; ``device="cpu"`` runs the kernel's plain torch
    version, which the CPU tests hold to the reference.  A dispatch packs
    its groups ragged on the host, copies them to the device once, launches
    once and copies ``dp`` (and ``bits``) back once, split into per-group
    numpy views.  The engine hands over every plan of a round at once
    (``max_group_batch`` is unbounded); the bits a launch writes are held
    under a per-device byte budget by splitting the stack — selections do
    not depend on the split, because groups are independent.
    """

    name = "torch"

    #: most improvement-bit bytes one launch may write: ample for a fleet
    #: tick on an 80 GB card, small on the host
    BITS_BUDGET = {"cuda": 2 << 30, "cpu": 64 << 20}

    def __init__(self, device=None):
        from .. import resolve_device

        self.device = resolve_device(device)
        if self.device.type not in self.BITS_BUDGET:
            raise ValueError(f"TorchBackend runs on cuda or cpu, not "
                             f"{self.device}")
        if self.device.type == "cpu":
            self.name = "torch:cpu"
        self.bits_budget = self.BITS_BUDGET[self.device.type]

    def cover_bits(self, groups):
        return self._dispatch(groups, with_bits=True)

    def cover_values(self, groups):
        return self._dispatch(groups, with_bits=False)

    def _slices(self, groups: Sequence[CoverGroup], with_bits: bool):
        if not with_bits:
            yield list(groups)
            return
        part, size = [], 0
        for g in groups:
            nbytes = len(g[0]) * (int(g[2]) + 1)
            if part and size + nbytes > self.bits_budget:
                yield part
                part, size = [], 0
            part.append(g)
            size += nbytes
        yield part

    def _dispatch(self, groups: Sequence[CoverGroup], with_bits: bool):
        out: List = []
        for part in self._slices(groups, with_bits):
            if not part:
                continue
            batch = CoverBatch.build(part, self.device)
            dp, bits = cover_dp(batch, with_bits)
            out += batch.split(dp.cpu().numpy(),
                               bits.cpu().numpy() if with_bits else None)
        return out


# ---------------------------------------------------------------------------
# Default-backend registry (env-overridable, no fallback)
# ---------------------------------------------------------------------------

_DEFAULT: Optional[SolverBackend] = None


def make_backend(spec: str) -> SolverBackend:
    """Build a backend from a spec string: ``torch`` (the CUDA kernel;
    raises without CUDA) | ``torch:cpu`` (its plain version on the host) |
    ``numpy``.  Anything else — the reference's ``jax*`` specs included —
    raises ``ValueError``."""
    if spec == "numpy":
        return NumpyBackend()
    if spec == "torch":
        return TorchBackend()
    if spec == "torch:cpu":
        return TorchBackend("cpu")
    raise ValueError(f"unknown solver backend spec {spec!r} "
                     "(expected torch | torch:cpu | numpy)")


def get_backend() -> SolverBackend:
    """The process-default backend: ``KUBEPACS_SOLVER_BACKEND`` if set,
    else ``torch`` — an unqualified solve runs on the card."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = make_backend(
            os.environ.get("KUBEPACS_SOLVER_BACKEND", "torch"))
    return _DEFAULT


def set_backend(backend: Optional[SolverBackend | str]) -> SolverBackend:
    """Override the process default (string specs accepted); ``None``
    resets to the environment/default resolution on next use."""
    global _DEFAULT
    if isinstance(backend, str):
        backend = make_backend(backend)
    _DEFAULT = backend
    return get_backend() if backend is None else backend
