"""The port's cost model (``repro_torch.roofline``) against the reference's
HLO walker (``repro.roofline``): exact FLOPs, loops, collective wire
bytes, the roofline terms, ``model_flops``, the decode cell's FLOPs beside
``analyze_hlo``'s, and the two kernel ops' own costs.

Every count runs on abstract (``meta``) tensors; the collective tests start
a fake process group of their own and destroy it.
"""

import functools
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.testing._internal.distributed.fake_pg import FakeStore

import repro.roofline as ref_rl
import repro.serving as ref_serving
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import transformer as ref_tf

from repro_torch import roofline, serving
from repro_torch.configs import SHAPES, get_config, list_archs
from repro_torch.kernels import ops
from repro_torch.models import transformer

META = torch.device("meta")


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


@pytest.fixture
def fake_group():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_matmul_counts_2mnk_exactly():
    c = roofline.analyze_step(lambda a, b: a @ b, meta(256, 512),
                              meta(512, 128))
    assert c.flops == 2 * 256 * 512 * 128
    # operands and result of the one op, float32
    assert c.bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)
    assert c.unknown_trip_counts == 0 and c.wire_bytes == 0.0


def test_loop_trip_counts_multiplied():
    """Eager code runs every trip: the reference's
    ``test_scan_trip_counts_multiplied`` for a Python loop."""
    def f(x, w):
        for _ in range(9):
            x = x @ w
        return x.sum()
    c = roofline.analyze_step(f, meta(8, 64), meta(64, 64))
    assert c.flops == 9 * 2 * 8 * 64 * 64


def test_nested_loop_trip_counts():
    def f(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x.sum()
    c = roofline.analyze_step(f, meta(8, 64), meta(64, 64))
    assert c.flops == 15 * 2 * 8 * 64 * 64


def test_einsum_and_bmm_lower_to_the_matmul_family():
    c = roofline.analyze_step(
        lambda a, b: torch.einsum("bsd,bde->bse", a, b),
        meta(4, 16, 32), meta(4, 32, 8))
    assert c.flops == 2 * 4 * 16 * 32 * 8


def test_views_move_no_bytes():
    c = roofline.analyze_step(lambda a: a.reshape(64, 2).t().unsqueeze(0),
                              meta(128))
    assert c.bytes == 0.0 and c.flops == 0.0


def test_rejects_concrete_tensors():
    with pytest.raises(ValueError, match="abstract"):
        roofline.analyze_step(lambda a: a + 1, torch.ones(3))


@pytest.mark.parametrize("op,buf,n", [
    ("all-reduce", 1024 * 512 * 2, 4), ("all-gather", 1024 * 512 * 2, 8),
    ("reduce-scatter", 4096, 16), ("all-to-all", 777, 3),
    ("collective-permute", 1024 * 512 * 2, 2)])
def test_collective_wire_equals_reference(op, buf, n):
    assert roofline._collective_wire(op, buf, n) == \
        ref_rl._collective_wire(op, buf, n)


def test_collectives_counted_on_a_fake_group(fake_group):
    """The reference test's buffers: an all-reduce over 4 ranks and an
    all-gather over 8 of 16 (bf16 1024 x 512 results)."""
    g4 = dist.new_group(list(range(4)))
    g8 = dist.new_group(list(range(8)))

    def f(x, y):
        a = funcol.all_reduce(x, "sum", g4)
        b = funcol.all_gather_single(y, 0, g8)
        return a, funcol.wait_tensor(b)

    c = roofline.analyze_step(f, meta(1024, 512, dtype=torch.bfloat16),
                              meta(128, 512, dtype=torch.bfloat16),
                              n_devices=16)
    buf = 1024 * 512 * 2
    assert c.wire_by_op["all-reduce"] == pytest.approx(2 * 3 / 4 * buf)
    assert c.wire_by_op["all-gather"] == pytest.approx(7 / 8 * buf)
    assert c.wire_by_op["all-reduce"] == ref_rl._collective_wire(
        "all-reduce", buf, 4)
    assert c.wire_by_op["all-gather"] == ref_rl._collective_wire(
        "all-gather", buf, 8)
    assert c.n_collectives == 2
    stats = roofline.parse_collectives(c)
    assert stats.count == 2 and stats.wire_bytes == c.wire_bytes


def test_roofline_terms_at_the_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.HBM_BYTES,
            roofline.LINK_BW) == (989e12, 3.35e12, 80e9, 50e9)
    rl = roofline.Roofline(flops_per_device=9.89e13,     # 0.1 s of compute
                           bytes_per_device=3.35e12,     # 1.0 s of HBM
                           wire_bytes_per_device=5e9,    # 0.1 s of link
                           n_devices=256,
                           model_flops_global=9.89e13 * 256 * 0.5)
    assert rl.compute_s == pytest.approx(0.1)
    assert rl.memory_s == pytest.approx(1.0)
    assert rl.collective_s == pytest.approx(0.1)
    assert rl.bound == "memory" and rl.step_s == pytest.approx(1.0)
    assert rl.roofline_fraction == pytest.approx(0.1)
    assert rl.model_flops_ratio == pytest.approx(0.5)
    assert rl.mfu_bound == pytest.approx(0.05)
    assert set(rl.as_dict()) == set(ref_rl.Roofline(1, 1, 1, 1).as_dict())


@pytest.mark.parametrize("arch", ref_list_archs())
def test_model_flops_equals_reference(arch):
    assert list_archs() == ref_list_archs()
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    n = transformer.active_params(cfg)
    assert n == ref_tf.active_params(ref_cfg)
    for name in REF_SHAPES:
        assert roofline.model_flops(cfg, SHAPES[name], n) == \
            ref_rl.model_flops(ref_cfg, REF_SHAPES[name], n)


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "internlm2-1.8b",
                                  "falcon-mamba-7b"])
def test_decode_cell_flops_match_reference_hlo(arch):
    """The smoke decode cell (B 8 against a 2048-long cache), no mesh:
    the port's count against ``analyze_hlo`` of the reference's compiled
    ``decode_fn`` (dots counted exactly by both), within 2%.  The position
    takes the current default int dtype, as the reference's roofline mode
    does: a JAX decision-plane test earlier in the process may have turned
    ``jax_enable_x64`` on, and the cache update then needs int64."""
    rc = ref_get_config(arch, smoke=True)
    hlo = jax.jit(functools.partial(ref_serving.decode_fn, cfg=rc)).lower(
        ref_tf.abstract_params(rc), ref_tf.abstract_cache(rc, 8, 2048),
        {"tokens": jax.ShapeDtypeStruct((8, 1), jnp.int32)},
        jax.ShapeDtypeStruct((), jnp.asarray(0).dtype)).compile().as_text()
    want = ref_rl.analyze_hlo(hlo, 1).flops
    cfg = get_config(arch, smoke=True)
    got = roofline.analyze_step(
        serving.decode_fn, transformer.abstract_params(cfg),
        transformer.abstract_cache(cfg, 8, 2048),
        {"tokens": meta(8, 1, dtype=torch.int32)}, 2047, cfg=cfg)
    assert got.flops == pytest.approx(want, rel=0.02)
    assert got.flops > 0 and got.bytes > 0


def test_attention_op_counts_its_own_cost():
    """``repro_torch::flash_attention`` at the internlm2-1.8b prefill (B 8,
    S 1024, H 16, KV 8, hd 128, bf16, causal) is one op whose roofline is
    ``attn_bound``'s (0.034776 ms)."""
    q = meta(8, 1024, 16, 128, dtype=torch.bfloat16)
    kv = meta(8, 1024, 8, 128, dtype=torch.bfloat16)
    c = roofline.analyze_step(ops.flash_attention, q, kv, kv)
    want = roofline.attn_cost(8, 1024, 1024, 16, 8, 128, 2)
    assert c.by_kernel == {"flash_attention": want}
    assert (c.flops, c.bytes) == want
    ms, by = roofline.attn_bound(8, 1024, 1024, 16, 8, 128, 2)
    assert roofline.roofline_of(c).step_s * 1e3 == ms and by == "operations"
    assert round(ms, 6) == 0.034776


def test_scan_op_counts_its_own_cost():
    """``repro_torch::selective_scan`` at falcon-mamba-7b's prefill (B 4,
    S 1024, di 8192, N 16, bf16) is one op whose roofline is
    ``scan_bound``'s (0.128384 ms)."""
    x = meta(4, 1024, 8192, dtype=torch.bfloat16)
    bc = meta(4, 1024, 16, dtype=torch.bfloat16)
    c = roofline.analyze_step(ops.selective_scan, x, x, meta(8192, 16), bc,
                              bc, meta(8192))
    want = roofline.scan_cost(4, 1024, 8192, 16, 2)
    assert c.by_kernel == {"selective_scan": want}
    ms, by = roofline.scan_bound(4, 1024, 8192, 16, 2)
    assert roofline.roofline_of(c).step_s * 1e3 == ms and by == "operations"
    assert round(ms, 6) == 0.128384


def test_scan_bwd_op_counts_its_own_cost():
    """A forward and backward through ``ops.selective_scan(...,
    impl="cuda")`` at falcon-mamba-7b's train_4k launch (B 4, S 4096, di
    8192, N 16, bf16) on ``meta`` counts one ``selective_scan`` at
    ``scan_cost`` and one ``selective_scan_bwd`` at ``scan_bwd_cost``,
    whose roofline is ``scan_bwd_bound``'s (0.513536 ms, the exps)."""
    def fwd_bwd(*args):
        ins = [t.requires_grad_() for t in args]
        y, _ = ops.selective_scan(*ins, impl="cuda")
        return torch.autograd.grad(y, ins, torch.empty_like(y))

    x = meta(4, 4096, 8192, dtype=torch.bfloat16)
    bc = meta(4, 4096, 16, dtype=torch.bfloat16)
    c = roofline.analyze_step(fwd_bwd, x, x, meta(8192, 16), bc, bc,
                              meta(8192))
    fwd = roofline.scan_cost(4, 4096, 8192, 16, 2)
    bwd = roofline.scan_bwd_cost(4, 4096, 8192, 16, 2)
    assert c.by_kernel == {"selective_scan": fwd, "selective_scan_bwd": bwd}
    assert bwd[1] == 2 * (5 * 4 * 4096 * 8192 + 4 * 4 * 4096 * 16) \
        + 8 * (8192 * 16 + 8192)
    ms, by = roofline.scan_bwd_bound(4, 4096, 8192, 16, 2)
    assert by == "operations" and round(ms, 6) == 0.513536
    assert ms == roofline.scan_bound(4, 4096, 8192, 16, 2)[0]


@pytest.mark.parametrize("shape", [(4, 4096, 8192, 16), (2, 100, 66, 5)])
def test_scan_bwd_op_counts_its_scratch(shape):
    """The scan backward's scratch (``scan_bwd_work_bytes``), which its CUDA
    body takes and frees inside the op, is in the memory account: the
    count's peak over one backward launch on ``meta`` is the seven
    gradients and the scratch, the outputs alone after it."""
    from repro_torch.kernels.mamba_scan import (scan_bwd_work_bytes,
                                                selective_scan_bwd_cuda)

    b, s, di, n = shape
    x = meta(b, s, di, dtype=torch.bfloat16)
    bc = meta(b, s, n, dtype=torch.bfloat16)
    A, D, h0 = meta(di, n), meta(di), meta(b, di, n)
    c = roofline.analyze_step(
        lambda *a: selective_scan_bwd_cuda(*a, None), x, x, A, bc, bc, D, h0,
        x)
    grads = 2 * (2 * b * s * di + 2 * b * s * n) + 4 * (
        di * n + di + b * di * n)
    assert c.peak_bytes == grads + scan_bwd_work_bytes(b, s, di, n)
    assert c.output_bytes == grads


def test_full_width_decode_cell_allocates_nothing_of_its_size():
    """qwen2.5-14b's decode_32k cell at full width on one device (~59 GB of
    bf16 parameters and cache) is counted on ``meta`` without growing the
    process by more than a fraction of a GB."""
    cfg = get_config("qwen2.5-14b")
    shape = SHAPES["decode_32k"]
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    params = transformer.abstract_params(cfg)
    cache = transformer.abstract_cache(cfg, shape.global_batch,
                                       shape.seq_len)
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters()) \
        + sum(t.numel() * t.element_size() for c in cache for t in c.values())
    assert nbytes > 50e9
    c = roofline.analyze_step(
        serving.decode_fn, params, cache,
        {"tokens": meta(shape.global_batch, 1, dtype=torch.int32)},
        shape.seq_len - 1, cfg=cfg)
    grown_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before
    assert grown_kb < 500_000
    rl = roofline.roofline_of(c)
    assert rl.bound == "memory" and c.bytes > nbytes * 0.9
    assert np.isfinite(rl.step_s) and c.flops > 0


# ---------------------------------------------------------------------------
# The memory account: argument, peak and output bytes, worked out by hand
# ---------------------------------------------------------------------------

def test_chain_of_two_elementwise_ops_peaks_at_two_results():
    """``(x * 2) + 1`` on 1000 float32: both results (4000 B each) are
    alive when the second is made; the return value is the second."""
    c = roofline.analyze_step(lambda x: (x * 2) + 1, meta(1000))
    assert (c.argument_bytes, c.peak_bytes, c.output_bytes) == \
        (4000, 8000, 4000)


def test_in_place_op_and_view_add_nothing():
    """An in-place op and a view write into / alias the argument's
    storage: nothing allocated, and an output that aliases an argument
    counts 0."""
    def f(x):
        x.add_(1)
        return x.view(10, 100)
    c = roofline.analyze_step(f, meta(1000))
    assert (c.argument_bytes, c.peak_bytes, c.output_bytes) == (4000, 0, 0)


def test_loop_that_allocates_and_drops_peaks_at_one_iteration():
    def f(x):
        for _ in range(5):
            y = x * 2                          # 4000 B, dropped each trip
            del y
    c = roofline.analyze_step(f, meta(1000))
    assert (c.peak_bytes, c.output_bytes) == (4000, 0)


def test_saved_tensors_and_gradients_are_counted():
    """``a2 = 2a``, ``y = a2 @ b``, ``loss = sum(y)`` and
    ``autograd.grad(loss, [a, b])`` with a (64, 32) and b (32, 16) float32:
    the forward makes a2 (8192 B, saved by the matmul for b's gradient,
    so it outlives ``del``), y (4096 B, not saved: freed) and loss (4 B).
    The backward makes the ones of loss's gradient (4 B; sum's backward
    expands it, a view), then in the matmul's node a2's gradient (8192 B)
    and b's (2048 B) while a2 is still saved: the peak, 4 + 8192 + 4 + 8192
    + 2048 = 18440 B.  The multiply's node then makes a's gradient
    (8192 B) after a2 and the ones are released.  The outputs are the two
    gradients, 8192 + 2048 B."""
    def f(a, b):
        a.requires_grad_(True)
        b.requires_grad_(True)
        with torch.enable_grad():
            a2 = a * 2
            y = a2 @ b
            loss = y.sum()
            del a2, y
            return torch.autograd.grad(loss, [a, b])
    c = roofline.analyze_step(f, meta(64, 32), meta(32, 16))
    assert (c.argument_bytes, c.peak_bytes, c.output_bytes) == \
        (8192 + 2048, 18440, 10240)


def test_attention_fake_allocates_o_and_lse():
    """The op's fake allocates what its CUDA body does: o like q (bf16
    2 x 128 x 8 x 64) and lse (2, 128, 4, 2) float32.  k and v are one
    tensor here: its storage is an argument once."""
    q = meta(2, 128, 8, 64, dtype=torch.bfloat16)
    kv = meta(2, 128, 4, 64, dtype=torch.bfloat16)
    c = roofline.analyze_step(torch.ops.repro_torch.flash_attention, q, kv,
                              kv, True, 0, None)
    o, lse = 2 * 128 * 8 * 64 * 2, 2 * 128 * 4 * 2 * 4
    assert c.argument_bytes == o + 2 * 128 * 4 * 64 * 2
    assert (c.peak_bytes, c.output_bytes) == (o + lse, o + lse)


def test_scan_fake_allocates_y_and_h_final():
    """y like x (bf16 2 x 100 x 32) and h_final (2, 32, 16) float32."""
    x = meta(2, 100, 32, dtype=torch.bfloat16)
    bc = meta(2, 100, 16, dtype=torch.bfloat16)
    c = roofline.analyze_step(torch.ops.repro_torch.selective_scan, x, x,
                              meta(32, 16), bc, bc, meta(32), None)
    y, h = 2 * 100 * 32 * 2, 2 * 32 * 16 * 4
    assert (c.peak_bytes, c.output_bytes) == (y + h, y + h)


def test_dtensor_matmul_counts_the_local_shard(fake_group):
    """x (128, 64) float32 split over 16 ranks (a local 8 x 64 shard,
    2048 B) times a replicated w (64, 32; 8192 B): the local product is
    (8, 32), 1024 B.  Gathered to every rank, the all-gather's result
    (128, 32; 16384 B) is a new storage beside the local product, and its
    DTensor wrapper is none."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = init_device_mesh("cpu", (16,), mesh_dim_names=("model",))
    x = DTensor.from_local(meta(8, 64), mesh, [Shard(0)], run_check=False)
    w = DTensor.from_local(meta(64, 32), mesh, [Replicate()],
                           run_check=False)
    c = roofline.analyze_step(lambda a, b: a @ b, x, w)
    assert (c.argument_bytes, c.peak_bytes, c.output_bytes) == \
        (2048 + 8192, 1024, 1024)
    c = roofline.analyze_step(
        lambda a, b: (a @ b).redistribute(mesh, [Replicate()]), x, w)
    assert c.n_collectives == 1
    assert (c.peak_bytes, c.output_bytes) == (1024 + 16384, 16384)


def test_argument_bytes_count_a_shared_leaf_once():
    """Two linear layers that share one (32, 64) float32 weight (8192 B),
    each with its own bias (128 B), and a buffer (128 B); the module and
    its weight passed again as an argument of their own."""
    lin1 = torch.nn.Linear(64, 32, device=META)
    lin2 = torch.nn.Linear(64, 32, device=META)
    lin2.weight = lin1.weight
    mod = torch.nn.Sequential(lin1, lin2)
    mod.register_buffer("scale", meta(32))
    c = roofline.analyze_step(lambda m, w, x: m[1](x), mod, lin1.weight,
                              meta(4, 64))
    assert c.argument_bytes == 8192 + 128 + 128 + 128 + 4 * 64 * 4
    assert c.output_bytes == 4 * 32 * 4
