"""Logical-axis sharding rules (MaxText-style) for all assigned archs, on a
``torch.distributed`` ``DeviceMesh``.

Weights carry *logical* axis names; :func:`logical_to_pspec` maps them to
mesh axes under a :class:`MeshRules`.  Activation/cache constraints are
config-aware (GQA head counts are not always divisible by the model axis, so
we shard heads when divisible and head_dim otherwise).  The rules and the
spec helpers are the reference's (``src/repro/sharding.py``), as pure logic.

A :class:`PartitionSpec` names, for each tensor dim, the mesh axes it is
split over (a name, a tuple of names, or ``None``); :func:`to_placements`
turns it into DTensor placements (``Shard(d)`` / ``Replicate()`` per mesh
dim).  A contextvar holds the active (mesh, rules) so model code can call
:func:`constrain` unconditionally: it is the identity outside a mesh
context (and on a plain tensor), and a ``redistribute`` of a DTensor to
the spec's placements inside one.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (split
    over each, major first) or ``None`` (not split).  A tuple of one name
    is that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """How logical axes map onto mesh axes."""

    batch: Tuple[str, ...]                   # data-parallel axes
    model: Optional[str] = "model"           # tensor/expert-parallel axis
    fsdp: Optional[Tuple[str, ...]] = None   # weight-shard axes (ZeRO-3 style)
    seq: Optional[Tuple[str, ...]] = None    # context-parallel axes (long decode)
    seq_act: bool = True                     # Megatron-SP: shard the sequence
    #                                          dim of inter-block activations
    #                                          over the model axis
    attn_mode: str = "none"                  # "none" | "auto" | "ulysses" | "cp"
    #                                          how self-attention internals are
    #                                          parallelized (see flash_mode)
    ep_shard_map: bool = False               # explicit local_map expert
    #                                          parallelism: local-rows x
    #                                          local-experts + one all-reduce
    #                                          a layer


def single_pod_rules(fsdp: bool = False, long_context: bool = False) -> MeshRules:
    return MeshRules(batch=("data",),
                     fsdp=("data",) if fsdp else None,
                     seq=("data",) if long_context else None)


def multi_pod_rules(fsdp: bool = False, long_context: bool = False) -> MeshRules:
    return MeshRules(batch=("pod", "data"),
                     fsdp=("pod", "data") if fsdp else None,
                     seq=("pod", "data") if long_context else None)


# -- logical weight axes -> PartitionSpec -----------------------------------

#: logical axis names that live on the model (tensor-parallel) axis
_MODEL_AXES = {"vocab", "q", "kv", "ff", "inner"}
#: logical axis names that live on the fsdp axes when fsdp is enabled
_FSDP_AXES = {"embed", "expert_in"}


def logical_to_pspec(axes: Sequence[Optional[str]], rules: MeshRules,
                     expert_parallel: bool = True) -> P:
    out = []
    for ax in axes:
        if ax in _MODEL_AXES:
            out.append(rules.model)
        elif ax == "experts":
            out.append(rules.model if expert_parallel else None)
        elif ax == "expert_ff":
            out.append(None if expert_parallel else rules.model)
        elif ax in _FSDP_AXES:
            out.append(rules.fsdp)
        else:                       # None, "state", "convk", ...
            out.append(None)
    return P(*out)


# -- ambient mesh context -----------------------------------------------------

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def mesh_context(mesh, rules: MeshRules):
    """Install (mesh, rules) for :func:`constrain` and the spec helpers.
    ``mesh`` is a ``DeviceMesh`` with named dims (anything with
    ``mesh_dim_names`` and ``shape`` serves the spec helpers).  Inside, a
    plain tensor that meets a DTensor in an op (a rotary table, a mask,
    a constant) counts as replicated on the DTensor's mesh."""
    token = _ACTIVE.set((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Tuple[Any, MeshRules]]:
    return _ACTIVE.get()


def rules_or_default() -> MeshRules:
    ctx = _ACTIVE.get()
    return ctx[1] if ctx is not None else MeshRules(batch=())


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def local_rank(mesh, dim) -> int:
    """This rank's coordinate on mesh dim ``dim`` (an index or a name); 0
    on a dim of size 1, which needs no process group of its own."""
    i = dim if isinstance(dim, int) else list(mesh.mesh_dim_names).index(dim)
    return 0 if mesh.size(i) == 1 else mesh.get_local_rank(i)


def to_placements(spec: Sequence, mesh) -> List:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.
    Raises on an unknown axis, on an axis named twice, and on a tuple of
    axes out of the mesh's order (DTensor splits a dim over its mesh dims
    in mesh order)."""
    names = list(mesh.mesh_dim_names)
    out: List = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r}: no mesh axis {a!r} in "
                                 f"{names}")
            if a in seen:
                raise ValueError(f"spec {spec!r} names mesh axis {a!r} "
                                 "twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r}: axes {axes} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def constrain(x, spec: P):
    """Redistribute a DTensor to ``spec``'s placements when a mesh is
    active; the identity outside a mesh and on a plain tensor.  The
    constraint is a layout hint, as in the reference: a split that does not
    divide its dim evenly (a batch of 1 over the data axes) is left out,
    where GSPMD would pad."""
    ctx = _ACTIVE.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    placements = to_placements(spec, mesh)
    pieces = {}
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            pieces[p.dim] = pieces.get(p.dim, 1) * mesh.size(m)
    placements = [Replicate() if isinstance(p, Shard)
                  and x.shape[p.dim] % pieces[p.dim] else p
                  for p in placements]
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def _reshape_or_gather(t, shape):
    """``t.reshape(shape)``, gathering the DTensor ``t`` on the dims the
    reshape touches first when its split cannot be carried through."""
    try:
        return t.reshape(shape)
    except RuntimeError:
        old = tuple(t.shape)
        lead = 0
        while lead < min(len(old), len(shape)) and old[lead] == shape[lead]:
            lead += 1
        placements = [Replicate() if isinstance(p, Shard) and p.dim >= lead
                      else p for p in t.placements]
        return t.redistribute(t.device_mesh, placements).reshape(shape)


class _Reshape(torch.autograd.Function):
    """Autograd for :func:`reshape` of a DTensor: the forward and the
    backward (the reshape back of the gradient, which may arrive split
    another way) both go through :func:`_reshape_or_gather`."""

    @staticmethod
    def forward(ctx, t, shape):
        ctx.shape_in = tuple(t.shape)
        return _reshape_or_gather(t, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape_or_gather(g, ctx.shape_in), None


def reshape(x, *shape):
    """``x.reshape(*shape)``; for a DTensor whose split cannot be carried
    through the reshape (a flat ``heads·head_dim`` dim split into more
    pieces than there are heads), the dims the reshape touches are gathered
    first, as GSPMD reshards before such a reshape — in the backward too."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    return _Reshape.apply(x, tuple(shape))


# -- config-aware activation / cache specs -----------------------------------

def _axis_size(name) -> int:
    ctx = _ACTIVE.get()
    if ctx is None or name is None:
        return 1
    sizes = mesh_sizes(ctx[0])
    if isinstance(name, tuple):
        size = 1
        for n in name:
            size *= sizes[n]
        return size
    return sizes[name]


def batch_axes() -> Optional[Tuple[str, ...]]:
    r = rules_or_default()
    return r.batch if r.batch else None


def act_spec_btd(seq_len: Optional[int] = None) -> P:
    """(batch, seq, d_model) activations: batch over data axes; with
    Megatron-style sequence parallelism the *inter-block* sequence dim also
    shards over the model axis whenever it divides evenly."""
    r = rules_or_default()
    seq_ax = None
    if (r.seq_act and seq_len is not None and r.model is not None
            and _axis_size(r.model) > 1 and seq_len % _axis_size(r.model) == 0
            and seq_len > 1):
        seq_ax = r.model
    return P(batch_axes(), seq_ax, None)


def head_axis_spec(n_heads: int, head_dim: int) -> Tuple[Optional[str], Optional[str]]:
    """Which of (heads, head_dim) goes on the model axis for (B,S,H,hd)."""
    r = rules_or_default()
    m = r.model
    msize = _axis_size(m)
    if msize <= 1:
        return None, None
    if n_heads % msize == 0:
        return m, None
    if head_dim % msize == 0:
        return None, m
    return None, None


def attn_act_spec(n_heads: int, head_dim: int) -> P:
    h_ax, d_ax = head_axis_spec(n_heads, head_dim)
    return P(batch_axes(), None, h_ax, d_ax)


def kv_cache_spec(n_kv_heads: int, head_dim: int, long_context: bool) -> P:
    """(B, T, KV, hd) cache: batch over data unless long-context (then the
    sequence axis takes the data axes and batch stays replicated)."""
    r = rules_or_default()
    h_ax, d_ax = head_axis_spec(n_kv_heads, head_dim)
    if long_context and r.seq:
        return P(None, r.seq, h_ax, d_ax)
    return P(batch_axes(), None, h_ax, d_ax)


def mamba_state_spec() -> P:
    """(B, d_inner, state): d_inner on the model axis."""
    r = rules_or_default()
    return P(batch_axes(), r.model, None)


def mamba_conv_state_spec() -> P:
    """(B, convk-1, d_inner)."""
    r = rules_or_default()
    return P(batch_axes(), None, r.model)


def flash_mode(batch_size: int, seq_len: int) -> str:
    """How to parallelize flash self-attention on the active mesh.

    * "ulysses" — reshard batch over (data × model); attention is then fully
      device-local.  Needs B divisible by the whole mesh.
    * "cp" — context parallelism: shard the q sequence dim over the model
      axis; k/v are gathered once per layer.  Needs S divisible by the model
      axis.
    * "none" — leave the layout as it comes (baseline).
    """
    ctx = _ACTIVE.get()
    if ctx is None:
        return "none"
    mesh, r = ctx
    if r.attn_mode == "none" or r.model is None:
        return "none"
    dm = _axis_size(r.batch) * _axis_size(r.model)
    msize = _axis_size(r.model)
    if (r.attn_mode in ("auto", "ulysses") and dm > 1
            and batch_size % dm == 0):
        return "ulysses"
    if (r.attn_mode in ("auto", "cp") and msize > 1
            and seq_len % msize == 0 and seq_len > msize):
        return "cp"
    return "none"


def ulysses_spec(rank: int) -> P:
    """(B, ...) with batch sharded over every mesh axis."""
    r = rules_or_default()
    axes = tuple(r.batch) + ((r.model,) if r.model else ())
    return P(axes, *([None] * (rank - 1)))


def cp_q_spec(rank: int) -> P:
    """(B, S, ...) with the q sequence dim on the model axis."""
    r = rules_or_default()
    return P(batch_axes(), r.model, *([None] * (rank - 2)))


def cp_kv_spec(rank: int) -> P:
    """(B, S, KV, hd) k/v replicated over model (gathered once per layer)."""
    return P(batch_axes(), *([None] * (rank - 1)))


def moe_group_spec() -> P:
    """(G, E, C, d) expert buffers: groups on data, experts on model."""
    r = rules_or_default()
    return P(batch_axes(), r.model, None, None)


def logits_spec() -> P:
    """(B, S, vocab) with vocab on the model axis."""
    r = rules_or_default()
    return P(batch_axes(), None, r.model)


# -- trees of specs -> DTensors ------------------------------------------------

def distribute(t, spec: Sequence, mesh):
    """``t`` as a DTensor on ``mesh`` under ``spec``: a DTensor is
    redistributed; a plain tensor (the global value, the same on every
    rank) becomes this rank's slice of it, with no collective (a ``meta``
    tensor gives a ``meta`` local tensor of its own storage, the shard's
    size, as a rank holds it)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    placements = to_placements(spec, mesh)
    if isinstance(t, DTensor):
        if tuple(t.placements) == tuple(placements):
            return t
        return t.redistribute(mesh, placements)
    if not t.is_meta and t.device.type != mesh.device_type:
        t = t.to(mesh.device_type)
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    local = torch.empty_like(local) if local.is_meta else local.contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, specs, mesh):
    """:func:`distribute` over matching nested dicts / lists / tuples of
    tensors and specs (``None`` and non-tensor leaves pass through)."""
    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(specs, P):
        return type(tree)(distribute_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    if isinstance(tree, torch.Tensor):
        return distribute(tree, specs, mesh)
    if hasattr(tree, "__array__"):                  # numpy inputs
        return distribute(torch.as_tensor(tree), specs, mesh)
    return tree


__all__ = ["MeshRules", "P", "PartitionSpec", "act_spec_btd", "active",
           "attn_act_spec", "batch_axes", "constrain", "cp_kv_spec",
           "cp_q_spec", "distribute", "distribute_tree", "flash_mode",
           "head_axis_spec", "kv_cache_spec", "local_rank",
           "logical_to_pspec",
           "logits_spec", "mamba_conv_state_spec", "mamba_state_spec",
           "mesh_context", "mesh_sizes", "moe_group_spec", "multi_pod_rules",
           "rules_or_default", "single_pod_rules", "to_placements",
           "ulysses_spec"]
