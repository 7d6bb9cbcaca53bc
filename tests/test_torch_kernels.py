"""The port's sequence kernels (``repro_torch.kernels``) against the reference.

On this host the kernels' wrappers run their plain torch versions
(``repro_torch.kernels.ref``), which must agree with the reference's Pallas
kernels in interpret mode and its jnp oracles at the bars of
``tests/test_kernels.py``: attention f32 ``2e-5``, bf16 ``3e-2``; scan f32
``1e-4``, bf16 ``5e-2``.  Inputs are drawn with numpy and handed to both.
The CUDA kernels are held to the same plain versions on the card by
``chip_smoke.py`` (phase 8).
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.mamba_scan import selective_scan_pallas
from repro_torch.configs import get_config, list_archs
from repro_torch.core import cuda_lib
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import (check_inputs,
                                                 flash_attention_cuda)
from repro_torch.kernels.mamba_scan import selective_scan_cuda

REPO = pathlib.Path(__file__).resolve().parents[1]

ATTN_SHAPES = [
    # (b, sq, skv, h, kv, hd, qc, kc) as in tests/test_kernels.py
    (1, 32, 32, 4, 4, 16, 8, 8),        # MHA
    (2, 64, 64, 8, 2, 32, 16, 32),      # GQA 4:1
    (1, 128, 128, 6, 6, 64, 64, 32),    # wider head
    (2, 48, 48, 4, 1, 16, 16, 16),      # MQA
]
MAMBA_SHAPES = [
    (1, 32, 16, 4, 16, 16),     # (b, s, di, n, chunk, di_block)
    (2, 64, 32, 8, 16, 32),
    (2, 128, 64, 16, 32, 32),
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (both round the float64 draw to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _qkv(rng, b, sq, skv, h, kv, hd, dtype):
    return [_pair(rng.normal(size=shape), dtype)
            for shape in ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_vs_pallas_interpret(shape, dtype):
    b, sq, skv, h, kv, hd, qc, kc = shape
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(1), b, sq,
                                        skv, h, kv, hd, dtype)
    want = flash_attention_pallas(qj, kj, vj, causal=True, q_chunk=qc,
                                  kv_chunk=kc, interpret=True)
    got, lse = ref.flash_fwd_chunked(qt, kt, vt, causal=True, q_chunk=qc,
                                     kv_chunk=kc)
    assert got.dtype == qt.dtype and lse.shape == (b, sq, kv, h // kv)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL[dtype])


@pytest.mark.parametrize("kwargs", [{"causal": False},
                                    {"causal": True, "q_offset": 32},
                                    {"causal": False, "kv_len": 40},
                                    {"causal": True, "q_offset": 8,
                                     "kv_len": 24}])
def test_flash_plain_noncausal_and_kvlen_vs_pallas(kwargs):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(2), 2, 32, 64,
                                        4, 2, 16, "float32")
    want = flash_attention_pallas(qj, kj, vj, q_chunk=16, kv_chunk=16,
                                  interpret=True, **kwargs)
    got = ref.flash_attention_ref(qt, kt, vt, q_chunk=16, kv_chunk=16,
                                  **kwargs)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    naive = ref.attention_naive(qt, kt, vt, **kwargs)
    np.testing.assert_allclose(_np(naive), _np(want), atol=2e-5)


@pytest.mark.parametrize("kwargs", [{"causal": True},
                                    {"causal": False, "kv_len": 40},
                                    {"causal": True, "q_offset": 8,
                                     "kv_len": 24},
                                    {"causal": True, "causal_skip": True}])
def test_flash_lse_vs_reference_chunked(kwargs):
    """``(o, lse)`` against the reference's ``flash_fwd_chunked`` (f32,
    2e-5); rows with no valid key carry ``lse = -inf`` in both."""
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(3), 2, 32, 64,
                                        8, 2, 16, "float32")
    if kwargs.get("causal_skip"):
        kj, vj, kt, vt = kj[:, :32], vj[:, :32], kt[:, :32], vt[:, :32]
    o_w, lse_w = jref.flash_fwd_chunked(qj, kj, vj, q_chunk=16, kv_chunk=16,
                                        **kwargs)
    o_g, lse_g = ref.flash_fwd_chunked(qt, kt, vt, q_chunk=16, kv_chunk=16,
                                       **kwargs)
    assert lse_g.shape == lse_w.shape == (2, 32, 2, 4)
    np.testing.assert_allclose(_np(o_g), _np(o_w), atol=2e-5)
    np.testing.assert_allclose(_np(lse_g), _np(lse_w), atol=2e-5)


#: the bf16 kernel's tiles: 64 query rows (wgmma's M) and 64-key K/V tiles
KERNEL_TILE = 64
KERNEL_TILE_SHAPES = [
    # (b, sq, skv, h, kv, hd): two or three tiles a side
    (1, 128, 128, 4, 2, 64),        # GQA 2:1, a config head dim
    (2, 192, 192, 2, 1, 32),        # MQA
    (1, 128, 128, 2, 2, 128),       # MHA, internlm2's head dim
]


@pytest.mark.parametrize("shape", KERNEL_TILE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_at_kernel_tiles_vs_pallas_interpret(shape, dtype):
    """The plain version at the CUDA kernel's tile sizes (q 64, kv 64), as
    it is held to the kernel on the card: rounding p to bf16 per 64-key tile
    stays within the bars of the Pallas kernel in interpret mode (o) and of
    the reference's chunked forward (lse)."""
    b, sq, skv, h, kv, hd = shape
    (qj, qt), (kj, kt), (vj, vt) = _qkv(np.random.default_rng(10), b, sq,
                                        skv, h, kv, hd, dtype)
    want = flash_attention_pallas(qj, kj, vj, causal=True,
                                  q_chunk=KERNEL_TILE, kv_chunk=KERNEL_TILE,
                                  interpret=True)
    _, lse_w = jref.flash_fwd_chunked(qj, kj, vj, causal=True,
                                      q_chunk=KERNEL_TILE,
                                      kv_chunk=KERNEL_TILE)
    got, lse = ref.flash_fwd_chunked(qt, kt, vt, causal=True,
                                     q_chunk=KERNEL_TILE,
                                     kv_chunk=KERNEL_TILE)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_TOL[dtype])
    np.testing.assert_allclose(_np(lse), _np(lse_w), atol=ATTN_TOL[dtype])


def _blank(b, sq, skv, h, kv, hd, dtype, device="cpu"):
    return (torch.zeros((b, sq, h, hd), dtype=dtype, device=device),
            torch.zeros((b, skv, kv, hd), dtype=dtype, device=device),
            torch.zeros((b, skv, kv, hd), dtype=dtype, device=device))


def _attention_head_dims():
    """``(arch, H, KV, hd)`` of every config, full and smoke, with an
    attention layer (falcon-mamba-7b has none)."""
    out = []
    for arch in list_archs():
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            if any(spec.mixer == "attn" for spec in cfg.layout):
                out.append((arch, cfg.n_heads, cfg.n_kv_heads,
                            cfg.resolved_head_dim))
    return out


@pytest.mark.parametrize("hd", [8, 16, 24, 32, 64, 80, 112, 128, 136, 256])
def test_check_inputs_takes_bf16_head_dims(hd):
    """bf16: every multiple of 8 up to 256 (TMA rows of 16-byte
    multiples), however many 64-column boxes it spans."""
    check_inputs(*_blank(2, 100, 70, 4, 2, hd, torch.bfloat16))


def test_check_inputs_takes_every_config_head_dim():
    dims = _attention_head_dims()
    assert {hd for *_, hd in dims} >= {64, 80, 112, 128}
    assert len({arch for arch, *_ in dims}) == 9
    for _, h, kv, hd in dims:
        for dtype in (torch.bfloat16, torch.float32):
            check_inputs(*_blank(1, 16, 16, h, kv, hd, dtype))


@pytest.mark.parametrize("hd", [12, 100, 256])
def test_check_inputs_takes_f32_head_dims_up_to_256(hd):
    check_inputs(*_blank(1, 16, 32, 2, 1, hd, torch.float32))


def _misaligned_bf16():
    q, k, v = _blank(1, 16, 16, 2, 1, 16, torch.bfloat16)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)
    return flat[1:].view(q.shape), k, v


@pytest.mark.parametrize("case, exc", [
    ("bf16 hd 12", ValueError), ("bf16 hd 260", ValueError),
    ("f32 hd 264", ValueError), ("float16", TypeError),
    ("mixed dtypes", TypeError), ("k, v shapes differ", ValueError),
    ("heads not a multiple of kv heads", ValueError),
    ("bf16 data off a 16-byte boundary", ValueError)])
def test_check_inputs_raises_on_what_the_kernel_does_not_take(case, exc):
    inputs = {
        "bf16 hd 12": lambda: _blank(1, 8, 8, 2, 1, 12, torch.bfloat16),
        "bf16 hd 260": lambda: _blank(1, 8, 8, 2, 1, 260, torch.bfloat16),
        "f32 hd 264": lambda: _blank(1, 8, 8, 2, 1, 264, torch.float32),
        "float16": lambda: _blank(1, 8, 8, 2, 1, 16, torch.float16),
        "mixed dtypes": lambda: _blank(1, 8, 8, 2, 1, 16, torch.bfloat16)[:2]
        + (torch.zeros((1, 8, 1, 16)),),
        "k, v shapes differ": lambda: _blank(1, 8, 8, 2, 1, 16,
                                             torch.float32)[:2]
        + (torch.zeros((1, 9, 1, 16)),),
        "heads not a multiple of kv heads": lambda: _blank(
            1, 8, 8, 3, 2, 16, torch.float32),
        "bf16 data off a 16-byte boundary": _misaligned_bf16,
    }[case]()
    with pytest.raises(exc):
        check_inputs(*inputs)


@pytest.mark.parametrize("hd, match", [(12, "not taken"),
                                       (16, "CUDA device")])
def test_cuda_branch_checks_inputs_first(hd, match):
    """Off the CPU the wrapper calls :func:`check_inputs` before anything
    else: a bf16 head it does not take raises as such, a taken one reaches
    the device check (meta tensors stand in for a card)."""
    q, k, v = _blank(1, 8, 8, 2, 1, hd, torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match=match):
        flash_attention_cuda(q, k, v)


def test_flash_empty_rows_are_zero_with_minus_inf_lse():
    (_, qt), (_, kt), (_, vt) = _qkv(np.random.default_rng(4), 1, 16, 16, 2,
                                     1, 16, "float32")
    o, lse = ref.flash_fwd_chunked(qt, kt, vt, causal=False, kv_len=0,
                                   q_chunk=8, kv_chunk=8)
    assert torch.equal(o, torch.zeros_like(o))
    assert torch.isneginf(lse).all()


def _scan_inputs(rng, b, s, di, n, dtype, with_h0=False):
    x = _pair(rng.normal(size=(b, s, di)), dtype)
    dt = _pair(rng.uniform(0.001, 0.1, size=(b, s, di)), dtype)
    A = _pair(-rng.uniform(0.5, 2.0, size=(di, n)), "float32")
    Bm = _pair(rng.normal(size=(b, s, n)), dtype)
    Cm = _pair(rng.normal(size=(b, s, n)), dtype)
    D = _pair(rng.normal(size=(di,)), "float32")
    h0 = _pair(rng.normal(size=(b, di, n)), "float32") if with_h0 else None
    return x, dt, A, Bm, Cm, D, h0


@pytest.mark.parametrize("shape", MAMBA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_plain_vs_pallas_interpret(shape, dtype):
    """Both plain scans (chunked: the CPU path; sequential: what the kernel
    is held to on the card) against the Pallas kernel."""
    b, s, di, n, chunk, dib = shape
    x, dt, A, Bm, Cm, D, _ = _scan_inputs(np.random.default_rng(4), b, s,
                                          di, n, dtype)
    want = selective_scan_pallas(x[0], dt[0], A[0], Bm[0], Cm[0], D[0],
                                 chunk=chunk, di_block=dib, interpret=True)
    args = (x[1], dt[1], A[1], Bm[1], Cm[1], D[1])
    y_c, _ = ref.selective_scan_chunked(*args, chunk=chunk)
    y_s, _ = ref.selective_scan_ref(*args)
    for got in (y_c, y_s):
        assert got.dtype == x[1].dtype
        np.testing.assert_allclose(_np(got), _np(want), atol=SCAN_TOL[dtype])


@pytest.mark.parametrize("shape", MAMBA_SHAPES)
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_final_state_vs_reference(shape, with_h0):
    """``(y, h_final)`` of both plain scans against the reference's
    sequential oracle, with and without an initial state (f32, 1e-4)."""
    b, s, di, n, chunk, _ = shape
    x, dt, A, Bm, Cm, D, h0 = _scan_inputs(np.random.default_rng(5), b, s,
                                           di, n, "float32", with_h0)
    y_w, h_w = jref.selective_scan_ref(
        x[0], dt[0], A[0], Bm[0], Cm[0], D[0],
        h0=None if h0 is None else h0[0])
    args = (x[1], dt[1], A[1], Bm[1], Cm[1], D[1])
    h0t = None if h0 is None else h0[1]
    for y_g, h_g in (ref.selective_scan_chunked(*args, h0=h0t, chunk=chunk),
                     ref.selective_scan_ref(*args, h0=h0t)):
        assert h_g.shape == (b, di, n) and h_g.dtype == torch.float32
        np.testing.assert_allclose(_np(y_g), _np(y_w), atol=1e-4)
        np.testing.assert_allclose(_np(h_g), _np(h_w), atol=1e-4)


@pytest.mark.parametrize("n", [1, 5, 13, 16])
@pytest.mark.parametrize("case", ["float32", "bfloat16", "h0"])
def test_plain_scans_at_ragged_state_widths(n, case):
    """The plain scans the kernel is held to, at state widths that do not
    split evenly over the kernel's four lanes a channel (1, 5, 13) and the
    full width 16: ``selective_scan_chunked`` and
    ``selective_scan_ref`` against the Pallas kernel in interpret mode (y),
    and with an initial state, which the Pallas kernel does not take,
    against the reference's sequential oracle (y and ``h_final``)."""
    b, s, di, chunk = 2, 48, 16, 16
    dtype = "float32" if case == "h0" else case
    x, dt, A, Bm, Cm, D, h0 = _scan_inputs(np.random.default_rng(40 + n), b,
                                           s, di, n, dtype, case == "h0")
    args = (x[1], dt[1], A[1], Bm[1], Cm[1], D[1])
    h0t = None if h0 is None else h0[1]
    got = [ref.selective_scan_chunked(*args, h0=h0t, chunk=chunk),
           ref.selective_scan_ref(*args, h0=h0t)]
    if case == "h0":
        y_w, h_w = jref.selective_scan_ref(x[0], dt[0], A[0], Bm[0], Cm[0],
                                           D[0], h0=h0[0])
    else:
        y_w = selective_scan_pallas(x[0], dt[0], A[0], Bm[0], Cm[0], D[0],
                                    chunk=chunk, di_block=di,
                                    interpret=True)
    for y_g, h_g in got:
        assert y_g.dtype == x[1].dtype and h_g.shape == (b, di, n)
        np.testing.assert_allclose(_np(y_g), _np(y_w), atol=SCAN_TOL[dtype])
        if case == "h0":
            np.testing.assert_allclose(_np(h_g), _np(h_w), atol=1e-4)


def test_associative_scan_matches_reference_chunked():
    """The chunk recursion follows ``jax.lax.associative_scan``: the
    chunked scans agree far inside the bar, odd chunk lengths included."""
    x, dt, A, Bm, Cm, D, h0 = _scan_inputs(np.random.default_rng(6), 2, 42,
                                           8, 4, "float32", True)
    y_w, h_w = jref.selective_scan_chunked(x[0], dt[0], A[0], Bm[0], Cm[0],
                                           D[0], h0=h0[0], chunk=21)
    y_g, h_g = ref.selective_scan_chunked(x[1], dt[1], A[1], Bm[1], Cm[1],
                                          D[1], h0=h0[1], chunk=21)
    np.testing.assert_allclose(_np(y_g), _np(y_w), atol=1e-6)
    np.testing.assert_allclose(_np(h_g), _np(h_w), atol=1e-6)


def test_ops_auto_on_cpu_runs_plain_versions_and_counts_no_launch():
    (_, qt), (_, kt), (_, vt) = _qkv(np.random.default_rng(7), 1, 32, 32, 4,
                                     2, 16, "float32")
    x, dt, A, Bm, Cm, D, _ = _scan_inputs(np.random.default_rng(8), 1, 32,
                                          16, 4, "float32")
    scan_args = (x[1], dt[1], A[1], Bm[1], Cm[1], D[1])
    before = (flash_attention_cuda.launches, selective_scan_cuda.launches)
    o = ops.flash_attention(qt, kt, vt, q_chunk=8, kv_chunk=8)
    assert torch.equal(o, ref.flash_attention_ref(qt, kt, vt, q_chunk=8,
                                                  kv_chunk=8))
    o_k, _ = flash_attention_cuda(qt, kt, vt, q_chunk=8, kv_chunk=8)
    assert torch.equal(o_k, o)
    y, h = ops.selective_scan(*scan_args, chunk=16)
    y_c, h_c = ref.selective_scan_chunked(*scan_args, chunk=16)
    assert torch.equal(y, y_c) and torch.equal(h, h_c)
    y_k, h_k = selective_scan_cuda(*scan_args, chunk=16)
    assert torch.equal(y_k, y_c) and torch.equal(h_k, h_c)
    y_n, _ = ops.selective_scan(*scan_args, impl="naive")
    np.testing.assert_allclose(_np(y_n), _np(y_c), atol=1e-5)
    assert (flash_attention_cuda.launches,
            selective_scan_cuda.launches) == before


def test_ops_cuda_impl_on_cpu_tensors_raises():
    (_, qt), (_, kt), (_, vt) = _qkv(np.random.default_rng(9), 1, 16, 16, 2,
                                     2, 16, "float32")
    x, dt, A, Bm, Cm, D, _ = _scan_inputs(np.random.default_rng(9), 1, 16,
                                          8, 4, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(qt, kt, vt, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.selective_scan(x[1], dt[1], A[1], Bm[1], Cm[1], D[1],
                           impl="cuda")
    for bad in ("pallas", "flash"):
        with pytest.raises(ValueError):
            ops.flash_attention(qt, kt, vt, impl=bad)


def test_launch_functions_are_declared():
    """Every ``extern "C"`` launch function of ``csrc/`` has its argument
    types in ``LAUNCH_ARGTYPES``, one per C parameter."""
    decl = re.compile(r'extern "C" int (\w+_launch)\(([^)]*)\)', re.S)
    found = {}
    for path in sorted((REPO / "src" / "repro_torch" / "csrc").glob("*.cu")):
        for name, params in decl.findall(path.read_text()):
            found[name] = len([p for p in params.split(",") if p.strip()])
    assert {"flash_attention_launch", "mamba_scan_launch"} <= set(found)
    assert found == {k: len(v) for k, v in cuda_lib.LAUNCH_ARGTYPES.items()}
