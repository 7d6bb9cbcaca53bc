"""Pluggable solver backends for the min-plus cover DP (DESIGN.md §12).

The ILP engine reduces every solve — single-α, a GSS prescan grid, or the
cross-decision batches of ``solve_ilp_many`` — to one primitive: a forward
min-plus value pass over a bundle sequence that also emits *improvement
bits*, the per-(bundle, coverage) booleans the exact backtracker consumes.
This module defines that primitive once, with interchangeable
implementations, and the fused plane that runs a whole search on the card:

* :class:`NumpyBackend` — the host path: a Python loop over bundles with
  in-place vectorized row updates.  The reference for the bit-identical
  selection contract.
* :class:`TorchBackend` — the device path: every dispatch stacks its groups
  ragged (no padding) and runs them in one launch of the hand-written CUDA
  kernel :func:`repro_torch.core.cover_dp.cover_dp`, one CTA per group.  On
  a CPU device (``"torch:cpu"``, what the tests use) it runs the kernel's
  plain torch version instead.
* :class:`FusedTorchBackend` — the fused decision plane
  (``"torch:fused"``; ``"torch:fused:cpu"`` on the host): a whole batched
  GSS on the card through the row-solver kernel, whose golden rows also
  score their pools, read back once and replayed on the host (DESIGN.md
  §13).

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

There is no fallback between backends: ``make_backend("torch")`` or
``"torch:fused"`` on a machine without CUDA raises, and a failed build or
launch fails the solve.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cover_dp import CoverBatch, cover_dp
from .cuda_lib import build
from .fused_rows import FEASIBLE, TOO_WIDE, DeviceMarket, fused_rows

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
# The fused decision plane (DESIGN.md §13)
# ---------------------------------------------------------------------------

#: golden ratio shrink factor, the same float64 expression as
#: ``repro_torch.core.gss.PHI`` (gss imports this module, not the reverse)
_PHI = (math.sqrt(5.0) - 1.0) / 2.0

_MISS = object()      # lookup sentinel (stored values include None)


def golden_rounds(tolerance: float) -> int:
    """Rounds the device runs: any bracket is at most 1 wide and shrinks by
    PHI per round, so ``ceil(log(tol) / log(PHI))`` suffice (+2 slack)."""
    if 0.0 < tolerance < 1.0:
        return int(math.ceil(math.log(tolerance) / math.log(_PHI))) + 2
    return 3


class FusedTorchBackend(TorchBackend):
    """The whole bracketed GSS of a batch on the card
    (``make_backend("torch:fused")``; ``"torch:fused:cpu"`` runs the plain
    versions on the host).

    * **prescan** — every (decision, grid-α) row of the batch in one
      :func:`~repro_torch.core.fused_rows.fused_rows` launch (sliced under
      the bits budget): saturation, LP prune, core bound, decode DP and
      backtrack per row, one CTA each.
    * **golden** — a host loop of exactly :func:`golden_rounds` rounds that
      queues, with no synchronisation, the bracket update as elementwise
      torch ops (each product its own op, so it is rounded before the add
      that uses it, as on the host), one ``fused_rows`` launch for every
      decision's probe, whose rows also return the speculative pool score
      that steers the brackets (``score_req``: no ``score`` launch of its
      own), and the event writes.  A round in which no
      decision is active changes nothing, so the fixed count records the
      reference's ``while_loop`` events exactly.  The events are read back
      once.

    The host replay (:class:`_FusedGssRecord`, driven by
    ``bracketed_gss_many``) re-runs the sequential control flow with exact
    host floats and takes each probe's counts from the device record by
    exact α lookup; a miss (the speculative score steered a bracket
    differently from the exact score) is solved on this device through the
    inherited per-dispatch path and counted in ``fallback_solves``.  One
    sampled prescan row per batch is re-solved by the NumPy engine; a
    mismatch raises :class:`_PrescanMismatch`.

    ``CompiledMarket`` arrays are uploaded once per ``market.digest`` (an
    LRU of :attr:`MAX_MARKETS` entries; ``device_cache_info()`` counts hits
    and misses).  Batches whose demand would need the approx coarsening
    tier are declined and run on the inherited per-dispatch path.
    """

    name = "torch:fused"
    supports_fused_gss = True
    MAX_MARKETS = 8

    def __init__(self, device=None):
        super().__init__(device)
        if self.device.type == "cpu":
            self.name = "torch:fused:cpu"
        self._market_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._host_check = NumpyBackend()
        self.device_cache_hits = 0
        self.device_cache_misses = 0
        self.fallback_solves = 0
        self.fused_records = 0
        self.verify_solves = 0

    # -- device market cache ------------------------------------------------
    def _device_market(self, market) -> DeviceMarket:
        """Upload-once market arrays, keyed on the content digest."""
        ent = self._market_cache.get(market.digest)
        if ent is not None:
            self.device_cache_hits += 1
            self._market_cache.move_to_end(market.digest)
            return ent
        self.device_cache_misses += 1
        ent = DeviceMarket.build(market, self.device)
        self._market_cache[market.digest] = ent
        while len(self._market_cache) > self.MAX_MARKETS:
            self._market_cache.popitem(last=False)
        return ent

    def device_cache_info(self) -> Dict[str, int]:
        """Market-cache hits, misses and entries; host-replay fallback and
        verification solves; CUDA library builds of this process."""
        return {"hits": self.device_cache_hits,
                "misses": self.device_cache_misses,
                "entries": len(self._market_cache),
                "fallback_solves": self.fallback_solves,
                "verify_solves": self.verify_solves,
                "program_builds": build.compiles}

    # -- device stages ------------------------------------------------------
    @staticmethod
    def _coarse(market, coarsening) -> Tuple[int, int, int]:
        """The ``(threshold, max_rows, gcd)`` triple of the row solver;
        coarsening off → an unreachable threshold (every row exact)."""
        if coarsening is None or not coarsening.enabled:
            return 2 ** 62, 1, 1
        return (int(coarsening.threshold), int(coarsening.max_rows),
                max(int(market.pods_gcd), 1))

    def _decisions(self, market, reqs, excludes):
        """Upload the batch's decisions and normalise their objectives on
        the device (``CompiledMarket.norms`` per mask): returns ``(market
        tensors, pn (D, N), qn (D, N), active (D, N), reqs (D,))``."""
        dm = self._device_market(market)
        ex = np.zeros((len(reqs), market.n), dtype=bool)
        for d, mask in enumerate(excludes):
            if mask is not None:
                ex[d] = mask
        excl = torch.from_numpy(ex).to(self.device)
        rq = torch.tensor([int(r) for r in reqs], dtype=torch.int64
                          ).to(self.device)
        inf = torch.tensor(float("inf"), dtype=torch.float64,
                           device=self.device)
        one = torch.ones((), dtype=torch.float64, device=self.device)
        keep = ~excl
        pmask = keep & (dm.perf > 0.0)
        pmin = torch.where(pmask, dm.perf, inf).amin(dim=1)
        perf_min = torch.where(pmask.any(dim=1), pmin, one)
        smin = torch.where(keep, dm.price, inf).amin(dim=1)
        sp_min = torch.where(torch.isfinite(smin), smin, one)
        pn = dm.perf / perf_min[:, None]
        qn = dm.price / sp_min[:, None]
        return dm, pn, qn, dm.structural & keep, rq

    @staticmethod
    def _coefs(alphas, pn, qn):
        """``-α·pn + (1-α)·qn`` per row, each product its own op."""
        a = alphas[:, None]
        return torch.mul(-a, pn) + torch.mul(1.0 - a, qn)

    def _rows(self, dm, coefs, actives, reqs, coarse, max_req,
              score_req=None):
        return fused_rows(dm, coefs, actives, reqs, coarse, max_req,
                          self.bits_budget, score_req=score_req)

    @staticmethod
    def _to_host(*tensors):
        """The one readback of a stage's results."""
        out = [t.cpu().numpy() for t in tensors]
        for t in out:
            if t.dtype == np.uint8 and np.any(t == TOO_WIDE):
                raise RuntimeError("fused_rows: a row's DP target exceeded "
                                   "the width its batch allowed")
        return out

    def _run_prescan(self, market, reqs, excludes, grid, coarsening=None):
        """Counts ``(D, G, n)`` and feasibility ``(D, G)`` of every
        (decision, grid-α) row, from one stack of rows."""
        D, G = len(reqs), len(grid)
        dm, pn, qn, active, rq = self._decisions(market, reqs, excludes)
        di = torch.arange(D * G, device=self.device) // G
        alphas = torch.tensor([float(a) for a in grid], dtype=torch.float64
                              ).to(self.device).repeat(D)
        counts, status = self._rows(
            dm, self._coefs(alphas, pn[di], qn[di]), active[di], rq[di],
            self._coarse(market, coarsening), max(reqs, default=0))
        counts, status = self._to_host(counts, status)
        return (counts.reshape(D, G, market.n),
                (status == FEASIBLE).reshape(D, G))

    def _run_golden(self, market, reqs, excludes, a_list, b_list,
                    tolerance, coarsening=None):
        """Every golden round of the batch queued on the device; returns
        the recorded probes ``(ev_a (D, E), ev_c (D, E, n), ev_f (D, E),
        evn (D,))`` — α, counts and feasibility of each decision's first
        ``evn[d]`` probes, E = rounds + 2."""
        D, n = len(reqs), market.n
        dev = self.device
        dm, pn, qn, active, rq = self._decisions(market, reqs, excludes)
        coarse = self._coarse(market, coarsening)
        max_req = max(reqs, default=0)
        rounds = golden_rounds(tolerance)
        E = rounds + 2
        reqf = rq.to(torch.float64)
        tol = float(tolerance)
        f64 = dict(dtype=torch.float64, device=dev)
        a = torch.tensor([float(x) for x in a_list], dtype=torch.float64
                         ).to(dev)
        b = torch.tensor([float(x) for x in b_list], dtype=torch.float64
                         ).to(dev)

        # bracket init: the host's x1/x2 formulas; both probes, one stack;
        # each row scores its pool (-inf unless feasible)
        w0 = (b - a) * _PHI
        x1, x2 = b - w0, a + w0
        c12, s12, f12 = self._rows(dm, self._coefs(torch.cat([x1, x2]),
                                                   pn.repeat(2, 1),
                                                   qn.repeat(2, 1)),
                                   active.repeat(2, 1), rq.repeat(2), coarse,
                                   max_req, score_req=reqf.repeat(2))
        f1, f2 = f12[:D], f12[D:]
        ev_a = torch.zeros((D, E), **f64)
        ev_c = torch.zeros((D, E, n), dtype=torch.int64, device=dev)
        ev_s = torch.zeros((D, E), dtype=torch.uint8, device=dev)
        ev_a[:, 0], ev_a[:, 1] = x1, x2
        ev_c[:, 0], ev_c[:, 1] = c12[:D], c12[D:]
        ev_s[:, 0], ev_s[:, 1] = s12[:D], s12[D:]
        evn = torch.full((D,), 2, dtype=torch.int64, device=dev)
        dn = torch.arange(D, device=dev)
        zero_a = torch.zeros(D, **f64)
        zero_r = torch.zeros_like(rq)
        for _ in range(rounds):
            act = (b - a) > tol
            ge = f1 >= f2
            right = ge & act                     # shrink from the right
            left = act & ~ge                     # shrink from the left
            nb = torch.where(right, x2, b)
            na = torch.where(left, x1, a)
            w = (nb - na) * _PHI
            nx1 = torch.where(right, nb - w, torch.where(left, x2, x1))
            nx2 = torch.where(left, na + w, torch.where(right, x1, x2))
            pf1 = torch.where(left, f2, f1)
            pf2 = torch.where(right, f1, f2)
            probe = torch.where(right, nx1, torch.where(left, nx2, zero_a))
            # inactive decisions re-solve req = 0 (the saturation exit),
            # scored at their demand all the same
            cp, sp, fp = self._rows(dm, self._coefs(probe, pn, qn), active,
                                    torch.where(act, rq, zero_r), coarse,
                                    max_req, score_req=reqf)
            f1 = torch.where(right, fp, pf1)
            f2 = torch.where(left, fp, pf2)
            ev_a[dn, evn] = torch.where(act, probe, ev_a[dn, evn])
            ev_c[dn, evn] = torch.where(act[:, None], cp, ev_c[dn, evn])
            ev_s[dn, evn] = torch.where(act, sp, ev_s[dn, evn])
            evn = evn + act.to(torch.int64)
            a, b, x1, x2 = na, nb, nx1, nx2
        ev_a, ev_c, ev_s, evn = self._to_host(ev_a, ev_c, ev_s, evn)
        return ev_a, ev_c, ev_s == FEASIBLE, evn

    # -- record entry point -------------------------------------------------
    def fused_gss_record(self, items, market, reqs, excludes, grid,
                         tolerance, coarsening=None,
                         ) -> Optional["_FusedGssRecord"]:
        """Run the device prescan for a ``bracketed_gss_many`` batch and
        return the replay record, or None to decline: an empty market or
        batch, or a batch whose coarsening ladder would need the approx
        tier (the row solver implements the exact and gcd modes).  A
        declined batch runs on the inherited per-dispatch path, the
        ``cover_dp`` kernel on the same device.  Device errors and a failed
        prescan verification raise."""
        if market.n == 0 or market.n_bundles == 0 or not reqs:
            return None
        cfg = DEFAULT_COARSENING if coarsening is None else coarsening
        max_req = max(int(r) for r in reqs)
        if cfg.enabled and max_req > cfg.threshold:
            g = market.pods_gcd
            if not (g > 1 and -(-max_req // g) <= cfg.max_rows):
                return None
        rec = _FusedGssRecord(self, items, market, reqs, excludes, grid,
                              tolerance, cfg)
        self.fused_records += 1
        return rec


class _PrescanMismatch(RuntimeError):
    """Device prescan counts failed the sampled host cross-check."""


class _FusedGssRecord:
    """Replay record binding one device-resident GSS batch to its host
    control loop (DESIGN.md §13).

    Construction runs the prescan and verifies one sampled row on the host;
    :meth:`run_golden` runs the golden rounds once the host has chosen
    brackets.  Both fill an exact-bitwise α → counts lookup per decision,
    which the host replay (``bracketed_gss_many``) resolves every probe
    through (:meth:`solve_many`).
    """

    def __init__(self, backend, items, market, reqs, excludes, grid,
                 tolerance, coarsening=None):
        self._backend = backend
        self._items = list(items)
        self._market = market
        self._reqs = [int(r) for r in reqs]
        self._excludes = list(excludes)
        self._tolerance = float(tolerance)
        self._coarsening = coarsening
        counts, feas = backend._run_prescan(market, self._reqs,
                                            self._excludes, list(grid),
                                            coarsening=coarsening)
        self.prescan = [
            [list(map(int, counts[d, g])) if feas[d, g] else None
             for g in range(len(grid))]
            for d in range(len(self._reqs))]
        self._lookup: List[dict] = [{} for _ in self._reqs]
        for d, row in enumerate(self.prescan):
            for a, c in zip(grid, row):
                self._lookup[d].setdefault(float(a), c)
        self._verify_sample(list(grid))

    def _verify_sample(self, grid: List[float]) -> None:
        """Re-solve one sampled (decision, α) prescan row — rotated through
        decisions and grid points by the backend's ``verify_solves`` counter
        — on the NumPy engine, and raise :class:`_PrescanMismatch` unless
        the device's counts equal it exactly."""
        if not self._reqs or not grid:
            return
        be = self._backend
        d = be.verify_solves % len(self._reqs)
        g = be.verify_solves % len(grid)
        be.verify_solves += 1
        from .ilp import solve_ilp_many   # deferred: no import cycle
        ref = solve_ilp_many(
            self._items, [self._reqs[d]], [[float(grid[g])]],
            market=self._market, excludes=[self._excludes[d]],
            backend=be._host_check, coarsening=self._coarsening)[0][0]
        if ref != self.prescan[d][g]:
            raise _PrescanMismatch(
                f"{be.name}: prescan counts diverged from the host engine "
                f"at decision {d}, alpha {float(grid[g])!r}")

    def run_golden(self, a_list, b_list) -> None:
        ev_a, ev_c, ev_f, evn = self._backend._run_golden(
            self._market, self._reqs, self._excludes,
            [float(a) for a in a_list], [float(b) for b in b_list],
            self._tolerance, coarsening=self._coarsening)
        for d in range(len(self._reqs)):
            lut = self._lookup[d]
            for s in range(int(evn[d])):
                cnt = (list(map(int, ev_c[d, s])) if ev_f[d, s] else None)
                lut.setdefault(float(ev_a[d, s]), cnt)

    def solve_many(self, idxs, alpha_lists):
        """``solve_ilp_many``-shaped resolution of a golden round's probes:
        one counts-or-None list per (decision index, α list) pair.  Misses
        are solved through the backend's per-dispatch path and counted."""
        out = [[None] * len(al) for al in alpha_lists]
        miss_pos: List[Tuple[int, List[int]]] = []
        miss_reqs: List[int] = []
        miss_alphas: List[List[float]] = []
        miss_excl: List[Optional[np.ndarray]] = []
        for k, (d, alist) in enumerate(zip(idxs, alpha_lists)):
            lut = self._lookup[d]
            missing = []
            for j, a in enumerate(alist):
                hit = lut.get(float(a), _MISS)
                if hit is _MISS:
                    missing.append(j)
                else:
                    out[k][j] = hit
            if missing:
                miss_pos.append((k, missing))
                miss_reqs.append(self._reqs[d])
                miss_alphas.append([alist[j] for j in missing])
                miss_excl.append(self._excludes[d])
        if miss_pos:
            self._backend.fallback_solves += sum(
                len(js) for _k, js in miss_pos)
            from .ilp import solve_ilp_many   # deferred: no import cycle
            solved = solve_ilp_many(
                self._items, miss_reqs, miss_alphas, market=self._market,
                excludes=miss_excl, backend=self._backend,
                coarsening=self._coarsening)
            for (k, js), counts_d in zip(miss_pos, solved):
                for j, c in zip(js, counts_d):
                    out[k][j] = c
                    self._lookup[idxs[k]].setdefault(
                        float(alpha_lists[k][j]), c)
        return out


# ---------------------------------------------------------------------------
# Default-backend registry (env-overridable, no fallback)
# ---------------------------------------------------------------------------

_DEFAULT: Optional[SolverBackend] = None


def make_backend(spec: str) -> SolverBackend:
    """Build a backend from a spec string: ``torch`` (the cover-DP kernel;
    raises without CUDA) | ``torch:cpu`` (its plain version on the host) |
    ``torch:fused`` (the fused plane on the card; raises without CUDA) |
    ``torch:fused:cpu`` (its plain versions on the host) | ``numpy``.
    Anything else — the reference's ``jax*`` specs included — raises
    ``ValueError``."""
    if spec == "numpy":
        return NumpyBackend()
    if spec == "torch":
        return TorchBackend()
    if spec == "torch:cpu":
        return TorchBackend("cpu")
    if spec == "torch:fused":
        return FusedTorchBackend()
    if spec == "torch:fused:cpu":
        return FusedTorchBackend("cpu")
    raise ValueError(f"unknown solver backend spec {spec!r} (expected "
                     "torch | torch:cpu | torch:fused | torch:fused:cpu | "
                     "numpy)")


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
