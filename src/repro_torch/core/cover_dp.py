"""The cover-DP kernel: wrapper and plain version.

``cover_dp`` runs the canonical recurrence of :mod:`repro_torch.core.backend`
for a ragged stack of groups in one launch of the hand-written CUDA kernel
``csrc/cover_dp.cu`` (one CTA per group, the bundle loop inside the CTA;
the recurrence itself is ``cover_dp_block`` of ``csrc/cover_dp.cuh``, on
two dp rows that trade places each bundle).
It takes a :class:`CoverBatch` — the groups concatenated without padding,
with per-group offsets — and returns the concatenated ``dp`` rows and, when
asked, the improvement bits, both bitwise equal to the host reference.

On a CUDA batch the wrapper launches the kernel or raises; on a CPU batch it
runs :func:`cover_dp_plain`, a torch scan over bundles on a padded
``(G, R+1)`` float64 batch (pads: ``pods=1, cost=+inf``).  The plain version
is the CPU path and what the kernel is held to on the card; nothing falls
back to it.

The kernel is part of the library that :mod:`repro_torch.core.cuda_lib`
builds from ``csrc/`` at first use.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda_lib import library

#: dynamic shared memory a block may opt into on an H100 (sm_90)
SMEM_OPTIN = 232_448
#: the widest dp row (T + 1 doubles) that runs in shared memory: two of
#: them take 131,088 B; wider groups run their two rows in global memory
SMEM_DP_WIDTH = 8192 + 1


def two_rows_smem(width: int) -> int:
    """Dynamic shared memory of a ``cover_dp`` CTA whose dp rows are
    ``width`` doubles: both rows, or 0 when they go to global memory (the
    group's slice of the dp output and a scratch row)."""
    return 16 * width if width <= SMEM_DP_WIDTH else 0


@dataclasses.dataclass(frozen=True)
class CoverBatch:
    """A ragged stack of cover-DP groups ``(bpods, costs, target)``.

    Host index arrays (numpy) plus one device copy of everything the kernel
    reads: ``ints`` holds ``pods | b_off | targets | dp_off | bits_off |
    scr_off`` (int64), ``costs`` the bundle costs (float64).  Group ``g``
    owns bundles ``b_off[g]:b_off[g+1]``, dp entries ``dp_off[g]:dp_off[g+1]``
    (its ``target + 1`` columns), bits ``bits_off[g]:bits_off[g+1]``
    (row-major ``(B_g, target + 1)``) and, when its two dp rows do not fit
    shared memory (:func:`two_rows_smem`), the scratch row
    ``scr_off[g]:scr_off[g+1]``.
    """

    b_off: np.ndarray
    targets: np.ndarray
    dp_off: np.ndarray
    bits_off: np.ndarray
    scr_off: np.ndarray
    ints: torch.Tensor
    costs: torch.Tensor

    @classmethod
    def build(cls, groups: Sequence[Tuple[np.ndarray, np.ndarray, int]],
              device: torch.device) -> "CoverBatch":
        nb = np.array([len(g[0]) for g in groups], dtype=np.int64)
        if any(len(g[1]) != n for g, n in zip(groups, nb)):
            raise ValueError("cover_dp: bpods and costs lengths differ")
        targets = np.array([g[2] for g in groups], dtype=np.int64)
        if np.any(targets < 0):
            raise ValueError("cover_dp: negative target")
        b_off = np.concatenate([[0], np.cumsum(nb)]).astype(np.int64)
        dp_off = np.concatenate([[0], np.cumsum(targets + 1)]).astype(np.int64)
        bits_off = np.concatenate(
            [[0], np.cumsum(nb * (targets + 1))]).astype(np.int64)
        wide = targets + 1 > SMEM_DP_WIDTH         # two_rows_smem(...) == 0
        scr_off = np.concatenate(
            [[0], np.cumsum(np.where(wide, targets + 1, 0))]).astype(np.int64)
        pods = np.concatenate([np.asarray(g[0], dtype=np.int64)
                               for g in groups] or [np.zeros(0, np.int64)])
        costs = np.concatenate([np.asarray(g[1], dtype=np.float64)
                                for g in groups] or [np.zeros(0)])
        if np.any(pods < 1):
            raise ValueError("cover_dp: bundle pods must be >= 1")
        ints = np.concatenate([pods, b_off, targets, dp_off, bits_off,
                               scr_off])
        return cls(b_off=b_off, targets=targets, dp_off=dp_off,
                   bits_off=bits_off, scr_off=scr_off,
                   ints=torch.from_numpy(ints).to(device),
                   costs=torch.from_numpy(costs).to(device))

    @property
    def n_groups(self) -> int:
        return len(self.targets)

    @property
    def n_bundles(self) -> int:
        return int(self.b_off[-1])

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of every CTA of the launch: two rows of
        the widest group that runs in shared memory."""
        fit = self.targets[self.targets + 1 <= SMEM_DP_WIDTH]
        return two_rows_smem(int(fit.max()) + 1) if fit.size else 0

    def split(self, dp: np.ndarray, bits: Optional[np.ndarray],
              ) -> List:
        """Per-group views of the concatenated outputs: ``dp`` rows, or
        ``(dp, bits)`` pairs with ``bits`` shaped ``(B_g, target + 1)``."""
        out = []
        for g in range(self.n_groups):
            d = dp[self.dp_off[g]:self.dp_off[g + 1]]
            if bits is None:
                out.append(d)
                continue
            nb = int(self.b_off[g + 1] - self.b_off[g])
            out.append((d, bits[self.bits_off[g]:self.bits_off[g + 1]]
                        .reshape(nb, int(self.targets[g]) + 1)))
        return out


def cover_dp(batch: CoverBatch, with_bits: bool = True,
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(dp, bits)`` of every group of ``batch``, concatenated (``bits`` is
    None when ``with_bits`` is False).  CUDA batch: one kernel launch,
    counted in ``cover_dp.launches``.  CPU batch: :func:`cover_dp_plain`."""
    dev = batch.costs.device
    if dev.type == "cpu" and batch.ints.device.type == "cpu":
        return cover_dp_plain(batch, with_bits)
    if dev.type != "cuda" or batch.ints.device != dev:
        raise ValueError(f"cover_dp: tensors on {batch.ints.device} and "
                         f"{dev}; expected one CUDA device")
    if batch.ints.dtype != torch.int64 or batch.costs.dtype != torch.float64:
        raise TypeError("cover_dp: expected int64 indices and float64 costs")
    if not (batch.ints.is_contiguous() and batch.costs.is_contiguous()):
        raise ValueError("cover_dp: inputs must be contiguous")
    if torch.cuda.get_device_capability(dev) != (9, 0):
        raise RuntimeError("cover_dp: the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(dev)} is not")
    dp = torch.empty(int(batch.dp_off[-1]), dtype=torch.float64, device=dev)
    bits = (torch.empty(int(batch.bits_off[-1]), dtype=torch.bool, device=dev)
            if with_bits else None)
    G = batch.n_groups
    if G == 0:
        return dp, bits
    smem = batch.smem_bytes
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > optin:
        raise RuntimeError(f"cover_dp: {smem} bytes of shared memory per "
                           f"block exceed the device's {optin}")
    n_scr = int(batch.scr_off[-1])
    scratch = (torch.empty(n_scr, dtype=torch.float64, device=dev)
               if n_scr else None)
    # int64 views into ``ints``: pods | b_off | targets | dp_off | bits_off
    # | scr_off
    nb = batch.n_bundles
    pods, b_off, targets, dp_off, bits_off, scr_off = (
        batch.ints.data_ptr() + 8 * o
        for o in (0, nb, nb + G + 1, nb + 2 * G + 1, nb + 3 * G + 2,
                  nb + 4 * G + 3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library().cover_dp_launch(
            pods, batch.costs.data_ptr(), b_off, targets, dp_off, bits_off,
            scr_off, dp.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            bits.data_ptr() if with_bits else None, G, smem, stream)
    if err != 0:
        raise RuntimeError(f"cover_dp: kernel launch failed with CUDA error "
                           f"{err}")
    cover_dp.launches += 1
    return dp, bits


#: kernel launches since the last reset (the wrapper is the only writer)
cover_dp.launches = 0


def cover_dp_plain(batch: CoverBatch, with_bits: bool = True,
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function as a torch scan over bundles on a padded
    ``(G, R+1)`` float64 batch, on the batch's device.  Pad bundles carry
    ``pods=1, cost=+inf`` (inert); pad columns are never read back, since
    the ``j``-prefix of the recurrence does not depend on the width."""
    dev = batch.costs.device
    G = batch.n_groups
    nb = np.diff(batch.b_off)
    B = int(nb.max()) if G else 0
    R = int(batch.targets.max()) if G else 0
    inf = float("inf")
    bmask = torch.from_numpy(np.arange(B)[None, :] < nb[:, None]).to(dev)
    pods = torch.ones((G, B), dtype=torch.int64, device=dev)
    costs = torch.full((G, B), inf, dtype=torch.float64, device=dev)
    pods[bmask] = batch.ints[:batch.n_bundles]
    costs[bmask] = batch.costs
    j = torch.arange(R + 1, dtype=torch.int64, device=dev)
    dp = torch.full((G, R + 1), inf, dtype=torch.float64, device=dev)
    dp[:, 0] = 0.0
    bits = (torch.empty((G, B, R + 1), dtype=torch.bool, device=dev)
            if with_bits else None)
    for b in range(B):
        pb, cb = pods[:, b:b + 1], costs[:, b:b + 1]
        src = torch.gather(dp, 1, (j - pb).clamp(min=0))
        # 1 <= j < pb: the candidate is cb itself, as the host writes it
        cand = torch.where(j >= pb, src + cb, cb)
        cand[:, 0] = inf                                  # dp[0] pinned
        if with_bits:
            torch.lt(cand, dp, out=bits[:, b])
        dp = torch.minimum(dp, cand)
    # each group's own block, sliced (a boolean mask over (G, B, R+1)
    # would index through int64 coordinates, 24 bytes a bit)
    widths = batch.targets + 1
    dp_out = torch.cat([dp[g, :widths[g]] for g in range(G)]
                       or [dp.new_zeros(0)])
    if not with_bits:
        return dp_out, None
    return dp_out, torch.cat([bits[g, :nb[g], :widths[g]].reshape(-1)
                              for g in range(G)] or [bits.new_zeros(0)])
