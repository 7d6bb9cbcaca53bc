"""Three-term roofline of one step, counted from the step itself on
abstract tensors (no hardware runs).

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = wire_bytes_per_device / link_bw

The reference walks the partitioned HLO of a compiled step.  A torch
program has no HLO, so the source of truth here is :func:`analyze_step`:
it runs the step eagerly on abstract tensors (``device="meta"``, or
DTensors whose local tensors are ``meta``), so that nothing of the
model's size is allocated, under a ``TorchDispatchMode`` that counts
every aten op the step dispatches on one device:

  * FLOPs of the matmul family only (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, ``convolution``; ``einsum`` and ``matmul`` lower to
    them), by the formulas of ``torch.utils.flop_counter`` — the
    reference's "dots exactly";
  * bytes as operands plus results of every op except views and
    metadata ops (:data:`_SKIP_BYTES_OPS`).  Eager ops are unfused, so
    this is an upper bound on what the reference counts at XLA's fusion
    boundaries;
  * loops: eager execution runs every iteration, so a loop's body is
    counted once per trip (the reference multiplies ``while`` bodies by
    their trip counts); ``unknown_trip_counts`` is 0 by construction;
  * collectives: the c10d functional collectives that DTensor issues,
    turned into ring wire bytes per device by :func:`_collective_wire`
    with N from the op's process group:
        all-reduce        2·(N−1)/N · buf
        all-gather          (N−1)/N · result
        reduce-scatter      (N−1)   · result
        all-to-all          (N−1)/N · buf
        collective-permute            buf

The model kernels reach the counter as one op each
(``repro_torch::flash_attention``, ``repro_torch::selective_scan`` and the
scan's backward ``repro_torch::selective_scan_bwd``) with their own cost
(:func:`attn_cost`, :func:`scan_cost`, :func:`scan_bwd_cost`), as the
reference's walker meets a custom call.

The same run keeps the step's memory account, the counterpart of XLA's
``memory_analysis()``.  Every storage that an op creates on the device
(a counted aten op, a kernel op's fake, a collective's output; views,
in-place and ``out=`` ops create none) is counted once, by its identity,
when it is created, and given back when it dies (a weakref callback on the
storage: no rescan of the live set).  ``argument_bytes`` is the distinct
storages the arguments reach, ``peak_bytes`` the most bytes of the step's
own storages alive at once (outputs included), ``output_bytes`` the
storages of the return value that the step created.  Scratch that an op
takes inside its CUDA implementation (cuBLAS workspace, cub temporaries of
``sort`` / ``cumsum``) exists only on the card and is not in the count,
save the scan backward's (``mamba_scan.scan_bwd_work_bytes``): a kernel op
of this package that takes scratch says how much, and the count holds it
beside the live bytes at the op's launch.

The constants are the H100 SXM data sheet's (dense, no sparsity, at the
700 W power limit).
"""

from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves

from .kernels.mamba_scan import scan_bwd_work_bytes

#: H100 SXM, dense bf16 tensor-core rate (FLOP/s per device)
PEAK_FLOPS = 989e12
#: H100 SXM HBM3 bandwidth (bytes/s per device)
HBM_BW = 3.35e12
#: H100 SXM device memory (bytes per device)
HBM_BYTES = 80e9
#: The per-GPU link a ring across more than one 8-GPU node is bound by:
#: one 400 Gb/s NDR InfiniBand port per GPU (bytes/s per device).  Inside a
#: node NVLink gives 450 GB/s each way; the production meshes (256 and 512
#: devices) span many nodes, so every ring has an inter-node hop.
LINK_BW = 50e9
#: H100 SXM float32 rate outside the tensor cores (FLOP/s)
FP32_FLOPS = 67e12
#: special-function-unit rate (exp): 132 SMs x 16 MUFU results a clock
#: (CUDA programming guide, compute capability 9.0) x 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9


@dataclasses.dataclass
class CollectiveStats:
    wire_bytes: float = 0.0                       # per device
    by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    count: int = 0


def _collective_wire(op: str, buf: float, n: int) -> float:
    if op == "all-reduce":
        return 2.0 * (n - 1) / n * buf
    if op == "all-gather":
        return (n - 1) / n * buf              # result shape printed
    if op == "reduce-scatter":
        return (n - 1) * buf                  # result = scattered piece
    if op == "all-to-all":
        return (n - 1) / n * buf
    return float(buf)                         # collective-permute


# ---------------------------------------------------------------------------
# The two kernels' costs (one op each)
# ---------------------------------------------------------------------------

def attn_flops(b, sq, skv, h, kv, hd, causal=True, q_offset=0,
               kv_len=None):
    """4 hd flops (S = Q K^T and P V) per valid (query, key) pair."""
    skv = skv if kv_len is None else max(0, min(int(kv_len), skv))
    qpos = q_offset + np.arange(sq)
    pairs = int(np.minimum(qpos + 1, skv).sum()) if causal else sq * skv
    return 4 * hd * pairs * b * h


def attn_bytes(b, sq, skv, h, kv, hd, elem):
    """q, k, v read and o, lse (float32) written once."""
    return elem * (2 * b * sq * h * hd + 2 * b * skv * kv * hd) \
        + 4 * b * sq * h


def attn_cost(b, sq, skv, h, kv, hd, elem, causal=True, q_offset=0,
              kv_len=None) -> Tuple[float, float]:
    """``(FLOPs, bytes)`` of one ``flash_attention`` op."""
    return (float(attn_flops(b, sq, skv, h, kv, hd, causal, q_offset,
                             kv_len)),
            float(attn_bytes(b, sq, skv, h, kv, hd, elem)))


def _bound(flops, nbytes):
    """``(ms, "bytes" | "operations")``: ``nbytes`` over HBM or ``flops``
    at :data:`PEAK_FLOPS`, whichever is longer."""
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_bound(b, sq, skv, h, kv, hd, elem, causal=True, q_offset=0):
    """``(ms, "bytes" | "operations")``: q, k, v read and o, lse written
    once over HBM; or :func:`attn_flops` over the dense bf16 tensor-core
    rate."""
    return _bound(*attn_cost(b, sq, skv, h, kv, hd, elem, causal, q_offset))


def scan_cost(b, s, di, n, elem) -> Tuple[float, float]:
    """``(FLOPs, bytes)`` of one ``selective_scan`` op: x, dt, B, C, A, D
    read and y, h_final written once; its operations are exps (one per
    (b, t, d, n)) on the SFUs and 6 float32 ops per (b, t, d, n) and 3 per
    (b, t, d) outside the tensor cores, none of them dense products, so
    they are given as the dense-bf16 FLOPs that take the same time at
    :data:`PEAK_FLOPS` — the op's compute term is then its time on the
    units that really do the work."""
    nbytes = elem * (3 * b * s * di + 2 * b * s * n) + 4 * (di * n + di) \
        + 4 * b * di * n
    t_exp = b * s * di * n / SFU_OPS_PER_S
    t_flop = (6 * b * s * di * n + 3 * b * s * di) / FP32_FLOPS
    return max(t_exp, t_flop) * PEAK_FLOPS, float(nbytes)


def scan_bound(b, s, di, n, elem):
    """``(ms, "bytes" | "operations")`` of :func:`scan_cost`: the bytes
    over HBM, or the exps over the SFU rate or the float32 ops over the
    float32 rate, whichever is longer."""
    return _bound(*scan_cost(b, s, di, n, elem))


def scan_bwd_cost(b, s, di, n, elem) -> Tuple[float, float]:
    """``(FLOPs, bytes)`` of one ``selective_scan_bwd`` op, counted as the
    gradient's own work and never what an implementation recomputes: x,
    dt, dy, B, C, A, D read and dx, ddt, dB, dC, dA, dD written once (the
    optional h0, dh and dh0 left out); one exp per (b, t, d, n) on the
    SFUs; and outside the tensor cores, per (b, t, d, n), 15 float32 ops:
    dt·A, the carry exp·g_{t+1}, C·dy and its add (g_t), Σ_n B·g (2),
    z = carry·h_{t-1}, Σ_n A·z (2), dA's dt·z and sum (2), dB's u·g and
    dC's h·dy with their sums over channels (4); per (b, t, d), 7: dx =
    dt·du + D·dy (3), ddt = x·du + Σ_n A·z (2), dD's x·dy and sum (2).
    Given, as :func:`scan_cost`'s, as the dense-bf16 FLOPs that take the
    same time at :data:`PEAK_FLOPS`."""
    nbytes = elem * (5 * b * s * di + 4 * b * s * n) + 8 * (di * n + di)
    t_exp = b * s * di * n / SFU_OPS_PER_S
    t_flop = (15 * b * s * di * n + 7 * b * s * di) / FP32_FLOPS
    return max(t_exp, t_flop) * PEAK_FLOPS, float(nbytes)


def scan_bwd_bound(b, s, di, n, elem):
    """``(ms, "bytes" | "operations")`` of :func:`scan_bwd_cost`, as
    :func:`scan_bound`."""
    return _bound(*scan_bwd_cost(b, s, di, n, elem))


# ---------------------------------------------------------------------------
# The counter
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepCost:
    """Per-device cost of one step, the counterpart of the reference's
    ``HloCost``."""
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    wire_by_op: Dict[str, float] = dataclasses.field(default_factory=dict)
    n_collectives: int = 0
    unknown_trip_counts: int = 0
    #: FLOPs and bytes of the kernel ops, by op name (a part of the totals)
    by_kernel: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    #: bytes of the distinct device storages the arguments reach (local
    #: shards of DTensors, parameters and buffers of modules)
    argument_bytes: int = 0
    #: most bytes of the storages the step created that were alive at once
    peak_bytes: int = 0
    #: bytes of the storages of the return value that the step created
    output_bytes: int = 0


_aten = torch.ops.aten

#: the matmul family: the only ops whose FLOPs are counted
_FLOP_OPS = (_aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm,
             _aten.convolution)

#: ops that move no data: allocation, metadata and bookkeeping (views are
#: found from their schemas)
_SKIP_BYTES_OPS = {
    _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default,
    _aten.new_empty_strided.default, _aten.detach.default,
    _aten.lift_fresh.default, _aten.sym_size.int, _aten.sym_stride.int,
    _aten.sym_numel.default, _aten.sym_storage_offset.default,
    _aten.is_contiguous.default, _aten._local_scalar_dense.default,
    _aten.arange.default, _aten.arange.start, _aten.arange.start_step,
}

#: c10d functional collectives (and DTensor's own all-to-all) -> the
#: reference's collective names
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
}


#: ops that hand their input on (funcol's autograd wrapper of a collective's
#: result) but whose ``meta`` kernel copies it: counted as an alias
_PASS_THROUGH = {("_c10d_functional", "_wrap_tensor_autograd")}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _is_view(func) -> bool:
    """True for an op whose result aliases an input (a view, an in-place or
    an ``out=`` op)."""
    return any(r.alias_info is not None for r in func._schema.returns)


def _device_tensors(tree) -> Iterator[torch.Tensor]:
    """The ``meta`` tensors of ``tree``: its leaves, the parameters and
    buffers of its modules, each DTensor's local tensor."""
    for t in tree_leaves(tree):
        if isinstance(t, torch.nn.Module):
            yield from _device_tensors(list(t.parameters())
                                       + list(t.buffers()))
            continue
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor) and t.is_meta:
            yield t


def _storages(tree) -> Dict[int, int]:
    """``{storage id: bytes}`` of the distinct storages ``tree`` reaches."""
    out = {}
    for t in _device_tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _group_size(func, args, kwargs, n_default: int) -> int:
    """N of a functional collective: its ``group_size`` argument, else the
    size of the group its ``group_name`` names."""
    names = [a.name for a in func._schema.arguments]
    vals = dict(zip(names, args))
    vals.update(kwargs)
    if "group_size" in vals:
        return int(vals["group_size"])
    if "group_name" in vals:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(vals["group_name"]).size()
    return n_default


def _kernel_cost(name: str, args, kwargs) -> Tuple[float, float]:
    if name == "flash_attention":
        q, k = args[0], args[1]
        causal, q_offset, kv_len = args[3], args[4], args[5]
        b, sq, h, hd = q.shape
        return attn_cost(b, sq, k.shape[1], h, k.shape[2], hd,
                         q.element_size(), causal, q_offset, kv_len)
    x, a = args[0], args[2]
    b, s, di = x.shape
    cost = scan_bwd_cost if name == "selective_scan_bwd" else scan_cost
    return cost(b, s, di, a.shape[1], x.element_size())


def _kernel_scratch(name: str, args) -> int:
    """Bytes of scratch a kernel op of this package takes beside its
    outputs while it runs."""
    if name != "selective_scan_bwd":
        return 0
    x, a = args[0], args[2]
    return scan_bwd_work_bytes(*x.shape, a.shape[1])


class _CostMode(TorchDispatchMode):
    """Counts the ops of one device.  An op on DTensors is left to DTensor
    (``NotImplemented``), whose local ops and collectives come back here;
    the global-shape ops DTensor runs under its own ``FakeTensorMode`` to
    propagate shapes are not the step's and are skipped."""

    def __init__(self, n_devices: int, arguments: Dict[int, int]):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = {op: flop_registry[op] for op in _FLOP_OPS}
        self.n_devices = n_devices
        self.cost = StepCost(argument_bytes=sum(arguments.values()))
        self._arguments = arguments
        #: the step's live storages: id -> (weakref to the storage, bytes)
        self.live: Dict[int, Tuple[weakref.ref, int]] = {}
        self._now = 0

    def _created(self, out) -> None:
        """Counts the storages of ``out`` that no argument and no earlier op
        holds, and a callback on each that gives its bytes back when it
        dies."""
        for t in tree_leaves(out):
            if not (isinstance(t, torch.Tensor) and t.is_meta):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self.live or key in self._arguments:
                continue
            n = st.nbytes()
            self.live[key] = (weakref.ref(st, functools.partial(
                self._died, key)), n)
            self._now += n
            if self._now > self.cost.peak_bytes:
                self.cost.peak_bytes = self._now

    def _held(self, nbytes: int) -> None:
        """Counts ``nbytes`` alive beside the live storages for a moment."""
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._now + nbytes)

    def _died(self, key: int, _ref) -> None:
        entry = self.live.pop(key, None)
        if entry is not None:
            self._now -= entry[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if (func.namespace, func._opname) in _PASS_THROUGH:
            return _aten.alias.default(args[0])
        out = func(*args, **kwargs)
        if any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack()):
            return out
        if not _is_view(func):
            self._created(out)
        c = self.cost
        ns, op = func.namespace, func._opname
        if ns == "repro_torch":
            self._held(_kernel_scratch(op, args))
            flops, nbytes = _kernel_cost(op, args, kwargs)
            c.flops += flops
            c.bytes += nbytes
            f0, b0 = c.by_kernel.get(op, (0.0, 0.0))
            c.by_kernel[op] = (f0 + flops, b0 + nbytes)
            return out
        if ns in ("_c10d_functional", "_dtensor") and op in _COLLECTIVES:
            coll = _COLLECTIVES[op]
            src = tree_leaves(args[0])
            buf = sum(_nbytes(t) for t in (tree_leaves(out)
                                           if coll in ("all-gather",
                                                       "reduce-scatter")
                                           else src))
            n = max(2, _group_size(func, args, kwargs, self.n_devices))
            wire = _collective_wire(coll, buf, n)
            c.wire_bytes += wire
            c.wire_by_op[coll] = c.wire_by_op.get(coll, 0.0) + wire
            c.n_collectives += 1
            return out
        packet = func.overloadpacket
        if packet in self._flops:
            c.flops += float(self._flops[packet](*args, **kwargs,
                                                 out_val=out))
        if func in _SKIP_BYTES_OPS or _is_view(func) or ns != "aten":
            return out
        c.bytes += sum(_nbytes(t) for t in tree_leaves((args, kwargs))) \
            + sum(_nbytes(t) for t in tree_leaves(out))
        return out


def _check_abstract(tree) -> None:
    for t in tree_leaves(tree):
        local = t._local_tensor if isinstance(t, DTensor) else t
        if isinstance(local, torch.Tensor) and not local.is_meta:
            raise ValueError("analyze_step: every tensor argument must be "
                             f"abstract (device 'meta'); got {local.device}")
    if isinstance(tree, torch.nn.Module):
        _check_abstract(list(tree.parameters()))


def analyze_step(fn, *args, n_devices: int = 1, **kwargs) -> StepCost:
    """Per-device :class:`StepCost` of ``fn(*args, **kwargs)``, run once on
    abstract tensors (every tensor argument, and every parameter of a
    module argument, on ``meta``, plain or as a DTensor's local tensor).
    ``n_devices`` is the group size taken for a collective that names
    none."""
    for a in list(args) + list(kwargs.values()):
        _check_abstract(a)
    mode = _CostMode(n_devices, _storages((args, kwargs)))
    try:
        with mode:
            out = fn(*args, **kwargs)
        mode.cost.output_bytes = sum(
            n for key, n in _storages(out).items() if key in mode.live)
    finally:
        mode.live.clear()          # no callback outlives the count
    return mode.cost


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    wire_bytes_per_device: float
    n_devices: int
    model_flops_global: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.wire_bytes_per_device / LINK_BW

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time lower bound (no overlap assumed)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak-FLOPs runtime if the step ran at its bound:
        1.0 when compute-dominated, <1 when memory/collectives dominate."""
        if self.step_s <= 0:
            return 0.0
        return self.compute_s / self.step_s

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): 'useful compute' share
        — catches remat recompute, causal-mask waste, MoE capacity padding."""
        total = self.flops_per_device * self.n_devices
        if total <= 0:
            return 0.0
        return self.model_flops_global / total

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization upper bound at the roofline:
        useful FLOPs / (devices × peak × step_time)."""
        denom = self.n_devices * PEAK_FLOPS * self.step_s
        return self.model_flops_global / denom if denom > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "wire_bytes_per_device": self.wire_bytes_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bound": self.bound,
            "step_s": self.step_s,
            "roofline_fraction": self.roofline_fraction,
            "model_flops_global": self.model_flops_global,
            "model_flops_ratio": self.model_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def roofline_of(cost: StepCost, n_devices: int = 1,
                model_flops_global: float = 0.0) -> Roofline:
    return Roofline(flops_per_device=cost.flops,
                    bytes_per_device=cost.bytes,
                    wire_bytes_per_device=cost.wire_bytes,
                    n_devices=n_devices,
                    model_flops_global=model_flops_global)


def model_flops(cfg, shape, active_param_count: int) -> float:
    """MODEL_FLOPS = 6·N_active·D for training, 2·N_active·D for inference
    (D = tokens processed by the step)."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active_param_count * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active_param_count * tokens
    tokens = shape.global_batch * 1          # decode: one token per row
    return 2.0 * active_param_count * tokens


def parse_collectives(cost: StepCost) -> CollectiveStats:
    """The collective summary of a counted step."""
    return CollectiveStats(wire_bytes=cost.wire_bytes, by_op=cost.wire_by_op,
                           count=cost.n_collectives)


__all__ = ["CollectiveStats", "HBM_BW", "HBM_BYTES", "LINK_BW", "PEAK_FLOPS",
           "Roofline", "StepCost", "analyze_step", "attn_bound", "attn_cost",
           "attn_flops", "model_flops", "parse_collectives", "roofline_of",
           "scan_bound", "scan_bwd_bound", "scan_bwd_cost", "scan_cost"]
