"""Per-offering serving throughput / latency from the roofline model.

This module replaces the scalar ``perf = BS_i · Pod_i`` score with serving
quantities for the co-simulation (DESIGN.md §15): every offering gets a
**QPS per pod** (throughput the ILP should buy) and a **per-request
latency** (what the SLO mask filters on), derived from the ML stack
instead of CoreMark alone.

Derivation (two modes, identical *ranking* by construction):

* ``roofline`` — count a reduced decode cell: the smoke config of
  ``profile.arch``, ``serving.make_sharded_decode`` on a 1×1
  ``("data","model")`` mesh, run once on abstract (``meta``) parameters,
  cache and batch under :func:`repro_torch.roofline.analyze_step` (the
  port's counterpart of the reference's compiled-HLO walk), and turn
  ``Roofline.step_s`` into an *efficiency factor* — counted step time over
  the ideal weight-stream bound on the same cell, both at the roofline
  module's H100 constants — that rescales the analytic full-model bound
  (both roofline terms are linear in N, so the factor transfers; it
  captures what the analytic bound misses: KV-cache traffic, unfused
  elementwise passes, layout copies).
* ``analytic`` — the ``model_flops`` model: a decode step
  over B concurrent rows on a D-device pod moves the active weights once
  plus the KV cache of B rows at the pinned context length
  (``memory_s = (2·N + B·S·kv_bytes)/(HBM_BW·D)``, bf16) and computes
  ``2·N`` FLOPs per row (``compute_s = 2·N·B/(PEAK_FLOPS·D)``);
  ``step_s = max`` of the two.  At the default profile the KV term
  dominates — decode at 32 k context is cache-bound.

``"auto"`` resolves to ``"roofline"`` (the reference's choice whenever its
ML stack imports); ``KUBEPACS_SERVE_PERF=analytic`` pins the analytic
model.  Only ``"auto"`` degrades to analytic, with a warning, when the
count fails; an explicit ``"roofline"`` raises.

Either way ``token_s_ref`` is the per-token seconds of the *reference*
machine (a gen-6 intel core, ``GEN6_CORE_SCORE``).  Offerings scale it by
their CoreMark ratio ``s_i = BS_i / GEN6_CORE_SCORE`` — one multiplicative
speed factor per offering, which is exactly why the two modes can never
disagree on ranking, only on absolute seconds (the property the
deterministic twin of the reference's roofline ranking test pins).

Both the step time and the per-market table are cached by a (config,
shape, offering-set) digest — recompiling a decode cell per provisioning
decision would dwarf the solver.  ``cache_stats()`` exposes hit/miss
counters for the invalidation tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..core.market import GEN6_CORE_SCORE

#: The analytic model's two machine rates, carried bit for bit from the
#: reference's roofline module (its per-chip ``PEAK_FLOPS`` and ``HBM_BW``):
#: they are the reference analytic model's inputs, which the parity tests
#: pin so that serving traces stay byte-equal.  They state no speed of the
#: card this package runs on (``repro_torch.roofline`` holds the H100's).
PEAK_FLOPS = 197e12
HBM_BW = 819e9

#: env override for the default perf-model mode
#: (``KUBEPACS_SERVE_PERF=analytic`` pins the analytic model)
ENV_MODE = "KUBEPACS_SERVE_PERF"

_MODES = ("auto", "roofline", "analytic")


@dataclasses.dataclass(frozen=True)
class ServingProfile:
    """What is being served: the (config, shape) half of the cache key.

    ``active_params`` is pinned rather than recomputed so the analytic
    model needs no model code and both modes rescale to the same
    full-model anchor (qwen2.5-14b dense ≈ 14.8e9 parameters)."""

    arch: str = "qwen2.5-14b"
    shape: str = "decode_32k"
    active_params: float = 14.8e9     # full-model params touched per token
    kv_bytes_per_token: float = 1.97e5   # bf16 K+V bytes cached per token
    context_len: int = 32768          # KV length each stream decodes against
    devices_per_pod: int = 8          # chips a pod shards the replica over
    batch_per_pod: int = 32           # concurrent decode streams per pod
    tokens_per_request: int = 128     # decoded tokens per request
    mode: str = "auto"                # "auto" | "roofline" | "analytic"

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown perf-model mode {self.mode!r}; "
                             f"choose from {_MODES}")
        for field in ("active_params", "kv_bytes_per_token"):
            object.__setattr__(self, field, float(getattr(self, field)))
        for field in ("context_len", "devices_per_pod", "batch_per_pod",
                      "tokens_per_request"):
            object.__setattr__(self, field, int(getattr(self, field)))

    def resolved_mode(self) -> str:
        return "roofline" if self.mode == "auto" else self.mode

    @property
    def digest(self) -> str:
        """Config+shape digest (mode-inclusive): the table cache key half
        that invalidates when any serving assumption changes."""
        h = hashlib.blake2b(digest_size=16)
        h.update(repr(dataclasses.astuple(self)).encode())
        return h.hexdigest()


def default_profile() -> ServingProfile:
    """The profile serving scenarios use unless told otherwise; honours
    the ``KUBEPACS_SERVE_PERF`` mode override."""
    mode = os.environ.get(ENV_MODE, "auto").strip() or "auto"
    return ServingProfile(mode=mode)


# --------------------------------------------------------------------------
# reference step time (per-token seconds on the gen-6 intel anchor)
# --------------------------------------------------------------------------

def analytic_token_s(profile: ServingProfile) -> float:
    """Pure-analytic decode-step roofline: max of the compute
    term and the memory term (active weights streamed once + KV cache of
    every concurrent row at the pinned context) over a ``devices_per_pod``
    pod.  One new token per row per step ⇒ per-token seconds = step
    seconds.  Default profile: ≈ 36 ms/token, cache-bound."""
    n = profile.active_params
    b = float(profile.batch_per_pod)
    d = float(profile.devices_per_pod)
    kv_bytes = b * profile.context_len * profile.kv_bytes_per_token
    compute_s = 2.0 * n * b / (PEAK_FLOPS * d)
    memory_s = (2.0 * n + kv_bytes) / (HBM_BW * d)
    return max(compute_s, memory_s)


@contextlib.contextmanager
def _one_device_mesh():
    """A 1×1 ``("data","model")`` mesh of this rank, with no process group
    of its own (size-1 dims issue no collective); a fake group of one rank
    stands in for the default group while none is initialised."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    own = not dist.is_initialized()
    if own:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=1)
    try:
        yield DeviceMesh("cpu", torch.tensor([[dist.get_rank()]]),
                         mesh_dim_names=("data", "model"),
                         _init_backend=False)
    finally:
        if own:
            dist.destroy_process_group()


def _roofline_token_s(profile: ServingProfile) -> float:
    """Count a reduced decode cell (smoke twin, capped batch/seq so it
    counts in seconds) on abstract tensors, and rescale the analytic
    full-model bound by the cell's efficiency factor (counted step time /
    ideal weight-stream bound, both at ``repro_torch.roofline``'s
    constants)."""
    import torch

    from .. import roofline, serving, sharding
    from ..configs.base import SHAPES, InputShape, get_config
    from ..data.pipeline import batch_pspecs
    from ..models import transformer

    cfg = get_config(profile.arch, smoke=True)
    full = SHAPES[profile.shape]
    if full.kind != "decode":
        raise ValueError(f"serving profile needs a decode shape, got "
                         f"{profile.shape!r} ({full.kind})")
    cell = InputShape("serve_cell", seq_len=min(full.seq_len, 2048),
                      global_batch=min(profile.batch_per_pod, 8),
                      kind="decode")
    rules = sharding.single_pod_rules()
    with _one_device_mesh() as mesh, sharding.mesh_context(mesh, rules):
        aparams = transformer.abstract_params(cfg)
        acache = transformer.abstract_cache(cfg, cell.global_batch,
                                            cell.seq_len)
        key = "codes" if cfg.input_mode == "audio_codes" else "tokens"
        shape = ((cell.global_batch, cfg.n_codebooks, 1)
                 if key == "codes" else (cell.global_batch, 1))
        tokens = {key: torch.empty(shape, dtype=torch.int32, device="meta")}
        step = serving.make_sharded_decode(
            cfg, rules, batch_pspecs(cfg, cell, rules), donate=False)
        # the last slot: a full cache
        cost = roofline.analyze_step(step, aparams, acache, tokens,
                                     cell.seq_len - 1)
    rl = roofline.roofline_of(cost)
    # efficiency factor: the counted roofline over the *same cell's* ideal
    # bound (weights + its cache bytes) — transfers to the full model
    # because both roofline terms are linear in the streamed bytes
    smoke_active = float(transformer.active_params(cfg))
    cache_bytes = float(sum(t.numel() * t.element_size()
                            for layer in acache for t in layer.values()))
    ideal_s = max(2.0 * smoke_active * cell.global_batch
                  / roofline.PEAK_FLOPS,
                  (2.0 * smoke_active + cache_bytes) / roofline.HBM_BW)
    eff = rl.step_s / max(ideal_s, 1e-30)
    return analytic_token_s(profile) * eff


#: step cache: (arch, shape, active_params, batch_per_pod, resolved mode)
#: → reference per-token seconds.  Module-level so every policy / bench /
#: replica run in a process shares one compile.
_STEP_CACHE: Dict[Tuple, float] = {}
_TABLE_CACHE: Dict[Tuple[str, Tuple], "ServingTable"] = {}
_STATS = {"step_hits": 0, "step_misses": 0,
          "table_hits": 0, "table_misses": 0}


def cache_stats() -> Dict[str, int]:
    return dict(_STATS)


def clear_caches() -> None:
    _STEP_CACHE.clear()
    _TABLE_CACHE.clear()
    for k in _STATS:
        _STATS[k] = 0


def reference_token_s(profile: ServingProfile) -> Tuple[float, str]:
    """(per-token seconds at speed factor 1.0, resolved mode), cached.
    ``auto`` degrades roofline → analytic with a warning if the count
    fails (a broken distributed install ≠ a broken co-simulation); an
    explicit ``mode="roofline"`` propagates the error."""
    mode = profile.resolved_mode()
    key = (profile.arch, profile.shape, profile.active_params,
           profile.kv_bytes_per_token, profile.context_len,
           profile.devices_per_pod, profile.batch_per_pod, mode)
    if key in _STEP_CACHE:
        _STATS["step_hits"] += 1
        return _STEP_CACHE[key], mode
    _STATS["step_misses"] += 1
    if mode == "roofline":
        try:
            token_s = _roofline_token_s(profile)
        except Exception as exc:  # noqa: BLE001 — "auto" degrades, loudly
            if profile.mode == "roofline":
                raise
            warnings.warn(f"serve_sim: roofline perf model unavailable "
                          f"({exc!r}); falling back to analytic")
            mode = "analytic"
            key = key[:-1] + (mode,)
            token_s = analytic_token_s(profile)
    else:
        token_s = analytic_token_s(profile)
    _STEP_CACHE[key] = token_s
    return token_s, mode


# --------------------------------------------------------------------------
# per-market serving table
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingTable:
    """Vectorized serving quantities for one offering set under one
    profile — the co-simulation's replacement for scalar perf scores."""

    profile_digest: str
    mode: str                        # resolved: "roofline" | "analytic"
    token_s_ref: float               # per-token s at speed factor 1.0
    offering_ids: Tuple[str, ...]
    speed: np.ndarray                # s_i = BS_i / GEN6_CORE_SCORE
    qps_per_pod: np.ndarray          # requests/s one pod of i sustains
    request_ms: np.ndarray           # per-request decode latency on i

    @property
    def index(self) -> Dict[str, int]:
        return {oid: k for k, oid in enumerate(self.offering_ids)}

    def slo_mask(self, slo_ms: float) -> Optional[np.ndarray]:
        """Boolean mask (True = SLO-infeasible, exclude from the ILP) in
        :func:`repro_torch.core.provisioner.exclusion_mask` convention; ``None``
        when every offering meets the SLO."""
        mask = self.request_ms > float(slo_ms)
        return mask if bool(mask.any()) else None

    def qps_map(self) -> Dict[str, float]:
        """offering_id → QPS/pod (the recovery-accounting rate table)."""
        return {oid: float(q)
                for oid, q in zip(self.offering_ids, self.qps_per_pod)}


def serving_table(profile: ServingProfile,
                  offerings: Sequence) -> ServingTable:
    """Build (or fetch) the serving table for ``offerings`` — anything
    with ``offering_id``/``bs_core`` attributes (market offerings or the
    ``.offering`` of solver candidates)."""
    offs = [getattr(o, "offering", o) for o in offerings]
    market_key = tuple((o.offering_id, float(o.bs_core)) for o in offs)
    cache_key = (profile.digest, market_key)
    hit = _TABLE_CACHE.get(cache_key)
    if hit is not None:
        _STATS["table_hits"] += 1
        return hit
    _STATS["table_misses"] += 1
    token_s, mode = reference_token_s(profile)
    speed = np.array([bs / GEN6_CORE_SCORE for _, bs in market_key],
                     dtype=np.float64)
    token_s_i = token_s / np.maximum(speed, 1e-12)
    request_ms = profile.tokens_per_request * token_s_i * 1e3
    qps_per_pod = profile.batch_per_pod / (profile.tokens_per_request
                                           * token_s_i)
    table = ServingTable(
        profile_digest=profile.digest, mode=mode, token_s_ref=token_s,
        offering_ids=tuple(oid for oid, _ in market_key),
        speed=speed, qps_per_pod=qps_per_pod, request_ms=request_ms)
    _TABLE_CACHE[cache_key] = table
    return table


def reference_qps_per_pod(profile: ServingProfile) -> float:
    """QPS/pod of the speed-factor-1.0 anchor under the profile's
    resolved step time.  Staffing, SLO, and capacity all derive from the
    same ``token_s_ref``, which makes the co-simulation *scale-invariant*
    in it: pod counts and absolute latencies shift between modes, but
    mask fractions, attainment, and policy rankings do not — the property
    the analytic-≡-roofline ranking test pins."""
    token_s, _ = reference_token_s(profile)
    return profile.batch_per_pod / (profile.tokens_per_request * token_s)


def default_slo_ms(profile: ServingProfile,
                   slack: float = 1.05) -> float:
    """Default latency SLO: ``slack`` × the reference request latency —
    a request may decode 5 % slower than on the gen-6 intel anchor.  With
    the catalog's CoreMark spread (speed factors ≈ 0.79–1.23) this masks
    the slow quarter of the market (old generations, low-score vendors):
    SLO-infeasibility is a *speed-factor* threshold (``s_i < 1/slack``),
    identical in both perf-model modes."""
    token_s, _ = reference_token_s(profile)
    return slack * profile.tokens_per_request * token_s * 1e3


__all__ = ["ENV_MODE", "ServingProfile", "ServingTable", "analytic_token_s",
           "cache_stats", "clear_caches", "default_profile", "default_slo_ms",
           "reference_qps_per_pod", "reference_token_s", "serving_table"]
