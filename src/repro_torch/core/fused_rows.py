"""The fused plane's row solver: wrapper and plain version.

``fused_rows`` solves a stack of engine rows — one (decision, α) objective
row each, as ``repro_torch.core.ilp._solve_rows`` solves it on the host:
saturation, the coarsening mode, the LP prune with its core-DP bound, the
decode DP with improvement bits and the backtrack — and returns each row's
counts and status.  On a CUDA stack it is one launch of the hand-written
kernel ``csrc/fused_rows.cu`` (one CTA per row, both cover DPs inside it
through ``csrc/cover_dp.cuh``) per slice of rows; on a CPU stack it runs
:func:`fused_rows_plain`, which the kernel is held to on the card.  Given
``score_req``, each row also scores its own counts in the tail of its CTA
(``csrc/score.cuh``, the order of :func:`~repro_torch.core.score.score_plain`):
the golden rounds take their scores from here and launch no ``score``.

The kernel reads only the prefix of the rate order that a row uses (the
first ``max(k_ub + _CORE_PAD, _CORE_MIN)`` bundles, ``cum_c`` up to
``k_ub``): it selects candidates with a histogram of the rate keys and
sorts those alone, or, when there are more than :data:`PREFIX_CAP`, sorts
all of them.  :func:`prefix_plan` is that selection in NumPy; the row's
path comes back in the optional ``paths`` output.

Counts and statuses are bitwise the host engine's: every float op is the
host's op in the host's order (see the kernel's source note for where that
could break and why it does not).

A row's status is :data:`FEASIBLE`, :data:`INFEASIBLE` (counts are then the
saturated items alone) or :data:`TOO_WIDE` (a DP target beyond the width the
caller's ``max_req`` allows; the caller raises on it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .cover_dp import SMEM_DP_WIDTH, CoverBatch, cover_dp_plain
from .cuda_lib import library
from .score import score_plain

INFEASIBLE, FEASIBLE, TOO_WIDE = 0, 1, 2

#: a row's path (the ``paths`` output): exited before the prune, rate-order
#: prefix sorted in shared memory, all DP bundles sorted
PATH_NONE, PATH_PREFIX, PATH_FULL = 0, 1, 2
#: the kernel's selection histogram and the prefix path's capacity
#: (``kBins``, ``kCap`` of ``csrc/fused_rows.cu``)
SELECT_BINS = 4096
PREFIX_CAP = 2048
#: residuals from which the histogram keeps no pod sums (``kPodClamp``):
#: such a row's prefix bound is all n bundles
POD_CLAMP = 1 << 21
#: the kernel's clock64 stamps a row (``stages`` output): start, then the
#: end of each stage below
STAGES = ("saturation", "select", "sort", "sums", "lp", "core_dp", "kept",
          "decode_dp", "backtrack", "score")
#: the kernel's shared memory after the first dp row (``kWorkBytes``,
#: ``kLpTableBytes`` of ``csrc/fused_rows.cu``): the work region, and the LP
#: table, which holds the second dp row from the core DP on
WORK_BYTES = PREFIX_CAP * (8 + 4 + 8 + 8 + 8)
LP_TABLE_BYTES = SMEM_DP_WIDTH * 8


def rows_smem(width_cap: int) -> Tuple[int, int]:
    """``(dp_smem, total)`` of a ``fused_rows`` CTA whose dp rows are
    ``width_cap`` doubles: the first row's bytes in shared memory (0 when
    both rows go to global memory, wider than ``SMEM_DP_WIDTH``), and the
    CTA's dynamic shared memory, that row 16-byte aligned, the work region
    and the LP table (the second row)."""
    dp_smem = 8 * width_cap if width_cap <= SMEM_DP_WIDTH else 0
    return dp_smem, -(-dp_smem // 16) * 16 + WORK_BYTES + LP_TABLE_BYTES

#: the host engine's keep test: cost + lp <= ub * KEEP_REL + KEEP_ABS
KEEP_REL = 1.0 + 1e-12
KEEP_ABS = 1e-9


@dataclasses.dataclass(frozen=True)
class DeviceMarket:
    """The arrays of a ``CompiledMarket`` the row solver and the score
    read, on one device, unpadded."""

    pods: torch.Tensor         # (N,) int64
    bound: torch.Tensor        # (N,) int64
    perf: torch.Tensor         # (N,) float64
    price: torch.Tensor        # (N,) float64
    podsf: torch.Tensor        # (N,) float64
    structural: torch.Tensor   # (N,) bool
    b_item: torch.Tensor       # (B,) int64
    b_pods: torch.Tensor       # (B,) int64
    b_copies: torch.Tensor     # (B,) int64

    @classmethod
    def build(cls, market, device: torch.device) -> "DeviceMarket":
        def up(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)
                                    ).to(device)
        return cls(pods=up(market.pods, np.int64),
                   bound=up(market.bound, np.int64),
                   perf=up(market.perf, np.float64),
                   price=up(market.price, np.float64),
                   podsf=up(market.pods, np.float64),
                   structural=up(market.structural, np.bool_),
                   b_item=up(market.b_item, np.int64),
                   b_pods=up(market.b_pods, np.int64),
                   b_copies=up(market.b_copies, np.int64))

    @property
    def n_items(self) -> int:
        return int(self.pods.numel())

    @property
    def n_bundles(self) -> int:
        return int(self.b_item.numel())


def dp_width(max_req: int, coarse: Tuple[int, int, int]) -> int:
    """The largest DP target ``eff_res`` of any row whose demand is at most
    ``max_req`` under the ``(threshold, max_rows, gcd)`` triple: rows at or
    below the threshold run exact; above it a row runs at granularity gcd
    when ``ceil(residual / gcd) <= max_rows``, which then holds for every
    residual up to ``max_req``."""
    thr, maxr, gcd = coarse
    max_req = max(int(max_req), 0)
    g_rows = -(-max_req // gcd) if gcd > 0 else max_req
    if max_req > thr and gcd > 1 and g_rows <= maxr:
        return max(min(max_req, thr), g_rows)
    return max_req


def _check_rows(dm: DeviceMarket, coefs, actives, reqs) -> None:
    R, N = coefs.shape
    if N != dm.n_items:
        raise ValueError(f"fused_rows: rows have {N} items, the market "
                         f"{dm.n_items}")
    want = ((coefs, torch.float64, (R, N)), (actives, torch.bool, (R, N)),
            (reqs, torch.int64, (R,)))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise TypeError(f"fused_rows: expected {dtype} {shape}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    dev = dm.pods.device
    for t in (coefs, actives, reqs):
        if t.device != dev:
            raise ValueError(f"fused_rows: a row tensor is on {t.device}, "
                             f"the market on {dev}")


def _check_out(name: str, t: Optional[torch.Tensor], dtype, shape, dev):
    if t is not None and (t.dtype != dtype or tuple(t.shape) != shape
                          or t.device != dev or not t.is_contiguous()):
        raise ValueError(f"fused_rows: {name} must be a contiguous {dtype} "
                         f"{shape} tensor on {dev}")


def fused_rows(dm: DeviceMarket, coefs: torch.Tensor, actives: torch.Tensor,
               reqs: torch.Tensor, coarse: Tuple[int, int, int],
               max_req: int, bits_budget: int, *,
               score_req: Optional[torch.Tensor] = None,
               paths: Optional[torch.Tensor] = None,
               stages: Optional[torch.Tensor] = None):
    """``(counts (R, N) int64, status (R,) uint8)`` of every row: ``coefs``
    ``(R, N)`` float64 objective rows, ``actives`` ``(R, N)`` bool
    (structural and not excluded), ``reqs`` ``(R,)`` int64 demands, each at
    most ``max_req``; ``coarse`` the ``(threshold, max_rows, gcd)`` triple.
    With ``score_req`` (``(R,)`` float64, each row's decision demand), a
    third tensor, ``(R,)`` float64: the pool score of each row's counts at
    its ``score_req`` where the row is :data:`FEASIBLE`, else ``-inf``.

    CUDA: the rows go to the kernel in slices whose improvement bits stay
    under ``bits_budget`` bytes, one launch each, counted in
    ``fused_rows.launches`` (those that score also in
    ``fused_rows.scoring_launches``); nothing is synchronised.  The kernel
    fills ``paths`` (``(R,)`` uint8, one of ``PATH_*``) and ``stages``
    (``(R, len(STAGES) + 1)`` int64 clock64 stamps) when they are given.
    CPU: :func:`fused_rows_plain` (the outputs stay untouched)."""
    _check_rows(dm, coefs, actives, reqs)
    dev = coefs.device
    R = coefs.shape[0]
    _check_out("paths", paths, torch.uint8, (R,), dev)
    _check_out("stages", stages, torch.int64, (R, len(STAGES) + 1), dev)
    if score_req is not None and (score_req.dtype != torch.float64
                                  or tuple(score_req.shape) != (R,)
                                  or score_req.device != dev):
        raise TypeError(f"fused_rows: score_req must be float64 ({R},) on "
                        f"{dev}, got {score_req.dtype} "
                        f"{tuple(score_req.shape)} on {score_req.device}")
    if dev.type == "cpu":
        return fused_rows_plain(dm, coefs, actives, reqs, coarse, max_req,
                                score_req=score_req)
    if dev.type != "cuda":
        raise ValueError(f"fused_rows: tensors on {dev}; expected CUDA or "
                         "CPU")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError("fused_rows: the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(dev)} is not")
    R, N = coefs.shape
    B = dm.n_bundles
    if B >= 2 ** 31 or R >= 2 ** 31:
        raise ValueError("fused_rows: more than 2**31 bundles or rows")
    coefs, actives, reqs = (t.contiguous() for t in (coefs, actives, reqs))
    scoring = score_req is not None
    if scoring:
        score_req = score_req.contiguous()
    thr, maxr, gcd = (int(x) for x in coarse)
    width_cap = dp_width(max_req, (thr, maxr, gcd)) + 1
    dp_smem, smem = rows_smem(width_cap)
    counts = torch.empty((R, N), dtype=torch.int64, device=dev)
    status = torch.empty(R, dtype=torch.uint8, device=dev)
    scores = (torch.empty(R, dtype=torch.float64, device=dev) if scoring
              else None)
    step = max(1, bits_budget // max(1, B * width_cap))
    # one set of scratch for the largest slice, reused by every launch of
    # the call (they run in order on one stream): a slice's bits are
    # allocated once, never beside the previous slice's
    n_max = min(step, R)
    fs = torch.empty(n_max * 7 * B, dtype=torch.float64, device=dev)
    is_ = torch.empty(n_max * 3 * B, dtype=torch.int32, device=dev)
    keep = torch.empty(n_max * B, dtype=torch.uint8, device=dev)
    bits = torch.empty(n_max * B * width_cap, dtype=torch.uint8, device=dev)
    dp_gl = (None if dp_smem else
             torch.empty(n_max * 2 * width_cap, dtype=torch.float64,
                         device=dev))
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo in range(0, R, step):
            n = min(step, R - lo)
            err = lib.fused_rows_launch(
                dm.pods.data_ptr(), dm.bound.data_ptr(), dm.perf.data_ptr(),
                dm.price.data_ptr(), dm.podsf.data_ptr(),
                dm.b_item.data_ptr(), dm.b_pods.data_ptr(),
                dm.b_copies.data_ptr(), N, B,
                coefs[lo].data_ptr(), actives[lo].data_ptr(),
                reqs[lo:].data_ptr(),
                score_req[lo:].data_ptr() if scoring else None,
                thr, maxr, gcd, width_cap,
                fs.data_ptr(), is_.data_ptr(), keep.data_ptr(),
                None if dp_gl is None else dp_gl.data_ptr(),
                bits.data_ptr(), counts[lo].data_ptr(),
                status[lo:].data_ptr(),
                scores[lo:].data_ptr() if scoring else None,
                n, dp_smem, smem, stream,
                None if paths is None else paths[lo:].data_ptr(),
                None if stages is None else stages[lo].data_ptr())
            if err != 0:
                raise RuntimeError(f"fused_rows: kernel launch failed with "
                                   f"CUDA error {err}")
            fused_rows.launches += 1
            if scoring:
                fused_rows.scoring_launches += 1
    return (counts, status, scores) if scoring else (counts, status)


#: kernel launches since the last reset (the wrapper is the only writer),
#: and of those, the launches whose rows scored their counts
fused_rows.launches = 0
fused_rows.scoring_launches = 0


def seq_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Strict left-to-right running sum (``np.cumsum`` order), taken on a
    CPU copy: CPU ``torch.cumsum`` of a 1-D float64 tensor is one
    sequential loop, while CUDA's reassociates."""
    return torch.cumsum(v.cpu(), 0).to(v.device)


def prefix_plan(rate: np.ndarray, pods: np.ndarray, residual: int,
                ) -> Tuple[int, int]:
    """``(candidates, path)`` of the kernel's selection for one row:
    ``rate`` the row's DP bundle keys ``bcost / pods + 0.0`` (>= 0, finite)
    and ``pods`` their pod sizes, both in market order.

    The keys' bit patterns go to :data:`SELECT_BINS` bins (bin 0 the zero
    keys, the rest spread over [least positive key, largest key] by a
    shift); the first bin whose pod sum reaches ``residual`` (below
    :data:`POD_CLAMP`) bounds ``k_ub``, hence the prefix length
    ``min(n, max(k_ub + _CORE_PAD, _CORE_MIN))``; every bundle in a bin up
    to the first whose count reaches that bound is a candidate.  More than
    :data:`PREFIX_CAP` candidates take the full path."""
    from .backend import _CORE_MIN, _CORE_PAD

    bits = np.ascontiguousarray(rate, dtype=np.float64).view(np.uint64)
    n = len(bits)
    positive = bits[bits != 0]
    lo = int(positive.min()) if positive.size else 0
    span = int(bits.max()) - lo if positive.size else 0
    shift = 0
    while (span >> shift) >= SELECT_BINS - 1:
        shift += 1
    bins = np.zeros(n, dtype=np.int64)
    nz = bits != 0
    bins[nz] = 1 + ((bits[nz] - np.uint64(lo)) >> np.uint64(shift)
                    ).astype(np.int64)
    count = np.cumsum(np.bincount(bins, minlength=SELECT_BINS))
    pod_sum = np.zeros(SELECT_BINS, dtype=np.int64)
    np.add.at(pod_sum, bins, np.asarray(pods, dtype=np.int64))
    pod_sum = np.cumsum(pod_sum)
    reach = np.flatnonzero(pod_sum >= residual)
    b1_count = int(count[reach[0]]) if reach.size and residual < POD_CLAMP \
        else n
    m_bound = min(n, max(b1_count - 1 + _CORE_PAD, _CORE_MIN))
    cut = np.flatnonzero(count >= m_bound)
    n_cand = int(count[cut[0]]) if cut.size else n
    return n_cand, PATH_PREFIX if n_cand <= PREFIX_CAP else PATH_FULL


def prefix_plans(info: List[dict]) -> List[Tuple[int, int]]:
    """:func:`prefix_plan` of every row of :func:`fused_rows_plain`'s
    ``info``; ``(0, PATH_NONE)`` for a row that exited before the rate
    order."""
    return [prefix_plan(r["rate"], r["pods"], r["residual"])
            if "rate" in r else (0, PATH_NONE) for r in info]


def _backtrack(bits: np.ndarray, pods: np.ndarray, target: int) -> np.ndarray:
    take = np.zeros(len(pods), dtype=bool)
    j = target
    for b in range(len(pods) - 1, -1, -1):
        if j == 0:
            break
        if bits[b, j]:
            take[b] = True
            j = max(0, j - int(pods[b]))
    return take


def _cover(pods: torch.Tensor, costs: torch.Tensor, target: int,
           with_bits: bool):
    batch = CoverBatch.build([(pods.cpu().numpy(), costs.cpu().numpy(),
                               target)], costs.device)
    dp, bits = cover_dp_plain(batch, with_bits)
    if with_bits:
        bits = bits.view(len(pods), target + 1)
    return dp, bits


def fused_rows_plain(dm: DeviceMarket, coefs: torch.Tensor,
                     actives: torch.Tensor, reqs: torch.Tensor,
                     coarse: Tuple[int, int, int], max_req: int,
                     info: Optional[List[dict]] = None,
                     score_req: Optional[torch.Tensor] = None):
    """The kernel's function, row by row in torch ops on the rows' device
    (sums on CPU copies, the cover DPs through ``cover_dp_plain``), over
    the whole rate order; with ``score_req``, also the rows' scores
    (:func:`~repro_torch.core.score.score_plain` of the counts, ``-inf``
    where a row is not :data:`FEASIBLE`).  With ``info`` a list, one dict
    per row is appended: the DP bundle count ``n``, the core-DP length
    ``core`` (0 when the bound did not trigger), the kept count ``kept``,
    the DP target ``eff_res`` (0 when the row exited before the DP) and,
    for a row that reached the rate order, its ``residual`` and its DP
    bundles' rate keys ``rate`` and pod sizes ``pods`` in market order
    (NumPy)."""
    # deferred: backend imports this module; the host engine's prune
    # constants live there
    from .backend import _CORE_MIN, _CORE_PAD, _CORE_TRIGGER

    _check_rows(dm, coefs, actives, reqs)
    dev = coefs.device
    R, N = coefs.shape
    thr, maxr, gcd = (int(x) for x in coarse)
    width_cap = dp_width(max_req, (thr, maxr, gcd)) + 1
    pb_items = dm.pods * dm.bound
    counts = torch.zeros((R, N), dtype=torch.int64, device=dev)
    status = torch.zeros(R, dtype=torch.uint8, device=dev)
    for r, req in enumerate(reqs.cpu().tolist()):
        row_info = {"n": 0, "core": 0, "kept": 0, "eff_res": 0}
        if info is not None:
            info.append(row_info)
        coef, act = coefs[r], actives[r]
        neg = (coef < 0.0) & act
        counts[r] = torch.where(neg, dm.bound, torch.zeros_like(dm.bound))
        in_dp = act & ~neg
        covered = int(pb_items[neg].sum())
        capacity = int(pb_items[in_dp].sum())
        residual = max(req - covered, 0)
        if residual == 0 or capacity < residual:
            status[r] = FEASIBLE if residual == 0 else INFEASIBLE
            continue
        rs_g = -(-residual // gcd)
        eff_g = gcd if (residual > thr and gcd > 1 and rs_g <= maxr) else 1
        eff_res = -(-residual // eff_g)
        if eff_res + 1 > width_cap:
            status[r] = TOO_WIDE
            continue

        # the row's DP bundles, compacted in market order
        bidx = torch.nonzero(in_dp[dm.b_item]).flatten()
        bpods = dm.b_pods[bidx]
        bcost = coef[dm.b_item[bidx]] * dm.b_copies[bidx].to(torch.float64)
        # + 0.0 turns -0.0 into 0.0, so any stable sort ties them
        rate = bcost / bpods.to(torch.float64) + 0.0
        order = torch.sort(rate, stable=True).indices
        p_sorted = bpods[order].to(torch.float64)
        c_sorted = bcost[order]
        cum_p = seq_cumsum(p_sorted)
        cum_c = seq_cumsum(c_sorted)
        n = len(bidx)
        k_ub = min(int(torch.searchsorted(
            cum_p, torch.tensor([float(residual)], dtype=torch.float64,
                                device=dev))[0]), n - 1)
        ub = float(cum_c[k_ub])
        rb = (residual - bpods).clamp(min=0).to(torch.float64)
        kk = torch.searchsorted(cum_p, rb).clamp(max=n - 1)
        km = (kk - 1).clamp(min=0)
        zero = torch.zeros_like(rb)
        prev_p = torch.where(kk > 0, cum_p[km], zero)
        prev_c = torch.where(kk > 0, cum_c[km], zero)
        q = c_sorted[kk] / p_sorted[kk]
        lp = prev_c + (rb - prev_p) * q
        lp = torch.where(rb <= 0.0, zero, lp)
        keep = (bcost + lp) <= ub * KEEP_REL + KEEP_ABS
        row_info.update(n=n, eff_res=eff_res)
        if info is not None:
            row_info.update(residual=residual, rate=rate.cpu().numpy(),
                            pods=bpods.cpu().numpy())
        if int(keep.sum()) > _CORE_TRIGGER:
            K = min(n, max(k_ub + _CORE_PAD, _CORE_MIN))
            row_info["core"] = K
            dp, _ = _cover(bpods[order[:K]] // eff_g, c_sorted[:K], eff_res,
                           False)
            core_ub = float(dp[eff_res])
            if core_ub < ub:
                keep = (bcost + lp) <= core_ub * KEEP_REL + KEEP_ABS

        kept = torch.nonzero(keep).flatten()
        row_info["kept"] = len(kept)
        kpods = bpods[kept] // eff_g
        _dp, bits = _cover(kpods, bcost[kept], eff_res, True)
        take = _backtrack(bits.cpu().numpy(), kpods.cpu().numpy(), eff_res)
        taken = bidx[kept[torch.from_numpy(take).to(dev)]]
        counts[r].index_add_(0, dm.b_item[taken], dm.b_copies[taken])
        status[r] = FEASIBLE
    if score_req is None:
        return counts, status
    s = score_plain(counts, dm.perf, dm.price, dm.podsf, score_req)
    return counts, status, torch.where(status == FEASIBLE, s,
                                       torch.full_like(s, float("-inf")))
