"""The paths that ``chip_smoke.py`` phase 22 drives at the reference's long
input shapes, held to the reference on the CPU at smoke width.

On the card phase 22 runs prefill_32k and decode_32k (internlm2-1.8b) and
long_500k (falcon-mamba-7b block by block, jamba-1.5-large's
``layout[:5]``).  Here the same paths run at smoke width with the chunks
cut small (``attn_chunk_q`` / ``attn_chunk_kv`` 128, ``mamba_chunk`` 64 in
both packages), so that a few thousand positions span many attention
blocks and many scan chunks: prefill into caches several times the prompt,
then greedy decode steps, the decode tokens being the port's argmax fed to
both packages.  Parameters come from the port's seeded ``init_params``
(each arch's drawn once a module), converted to the reference's tree;
prompts are drawn with numpy.  The reference's ``prefill`` and
``decode_step`` run under ``jax.jit``, as it serves.  Both packages take their plain attention and
scan on the CPU.  Tolerance: logits and caches within ``1e-4`` of the
reference's (float32 compute), greedy tokens equal.

Also held: phase 22c's block-by-block prefill
(``chip_smoke.prefill_by_blocks``) against the port's own ``prefill``; the
memory of a Mamba block at long_500k, counted on ``meta``: its
sequence-long temporaries are let go once read, so a falcon-mamba-7b block
at B 1 x S 524,288 peaks at under six ``(1, S, d_inner)`` bf16 tensors
(it held nine, 77 GB, before they were); and ``serve``'s finiteness check
(``launch.serve.all_finite``), equal to ``isfinite(t).all()`` and taking
no temporary of the logits' size (``isfinite`` took 2.5 times their
bytes: the 22a serve ran out of memory there).  Last, phase 22's holds at
the long shapes, which take each band of positions to a share of its own
largest magnitude (``chip_smoke.band_errors``,
``chip_smoke.scan_plain_in_segments``): they fail a fault confined to the
late rows that a bar scaled by the whole sequence's largest magnitude
lets pass.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro import models as ref_models
from repro.configs import get_config as ref_get_config
from repro_torch import roofline
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.launch.serve import all_finite
from repro_torch.models import decode_step, init_params, prefill, transformer
from repro_torch.models.convert import (caches_to_reference,
                                        params_to_reference)

CPU = torch.device("cpu")
TOL = 1e-4
CHUNKS = dict(attn_chunk_q=128, attn_chunk_kv=128, mamba_chunk=64)
STEPS = 4

#: arch -> (prompt length, cache length)
LONG = {
    "internlm2-1.8b": (1024, 4096),
    "falcon-mamba-7b": (2048, 2048 + STEPS),
    "jamba-1.5-large-398b": (256, 8 * 256),
}


#: arch -> the stack fields of the layers the card runs (22d: jamba's
#: ``layout[:5]``, four Mamba layers, two with MoE, and the attention layer)
CUTS = {"jamba-1.5-large-398b": (5, {"prefix_layers": 0, "scan_period": 5})}


def _configs(arch, smoke=True):
    kw = dict(dtype="float32", **CHUNKS)
    if arch in CUTS:
        n, stack = CUTS[arch]
        kw.update(n_layers=n, **stack)
    return tuple(dataclasses.replace(
        cfg, layout=cfg.layout[:kw.get("n_layers", cfg.n_layers)],
        **kw).validate()
        for cfg in (ref_get_config(arch, smoke=smoke),
                    get_config(arch, smoke=smoke)))


ref_prefill = jax.jit(ref_models.prefill, static_argnums=1,
                      static_argnames="max_len")
ref_decode_step = jax.jit(ref_models.decode_step, static_argnums=1)


@functools.cache
def _params(arch, seed=28):
    """Both packages' configs and the port's parameters drawn from
    ``seed``, with the reference's converted from them (once a module)."""
    cfg_r, cfg_p = _configs(arch)
    params_t = init_params(cfg_p, torch.Generator().manual_seed(seed), CPU)
    return cfg_r, cfg_p, params_to_reference(cfg_p, params_t), params_t


def _assert_caches(cfg_p, got, want):
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), want)
    got = caches_to_reference(cfg_p, got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL)


@pytest.mark.parametrize("arch", sorted(LONG))
def test_long_prefill_and_decode_match_reference(arch):
    """Prefill a long prompt into caches longer still, then greedy decode
    steps: the logits of every step and the caches after the prefill (KV,
    SSM ``h`` and ``conv``) and after the last step within 1e-4 of the
    reference's, the greedy tokens equal."""
    cfg_r, cfg_p, params_j, params_t = _params(arch)
    S, max_len = LONG[arch]
    prompt = np.random.default_rng(28).integers(0, cfg_p.vocab_size, (1, S))
    lj, cj = ref_prefill(params_j, cfg_r, {"tokens": jnp.asarray(prompt)},
                         max_len=max_len)
    lt, ct = prefill(params_t, cfg_p, {"tokens": torch.from_numpy(prompt)},
                     max_len=max_len)
    assert tuple(lt.shape) == lj.shape == (1, S, cfg_p.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    _assert_caches(cfg_p, ct, cj)
    for i in range(STEPS):
        nxt = lt[:, -1:].argmax(-1)
        assert np.array_equal(nxt.numpy(), np.asarray(lj[:, -1:]).argmax(-1))
        lj, cj = ref_decode_step(params_j, cfg_r, cj,
                                 {"tokens": jnp.asarray(nxt.numpy())},
                                 jnp.asarray(S + i))
        lt, ct = decode_step(params_t, cfg_p, ct, {"tokens": nxt}, S + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    assert np.array_equal(lt.argmax(-1).numpy(), np.asarray(lj).argmax(-1))
    _assert_caches(cfg_p, ct, cj)


def test_block_prefill_matches_prefill():
    """Phase 22c's prefill a block at a time: each layer's SSM state equal
    to ``transformer.prefill``'s and the last position's logits within
    1e-5 of its."""
    _, cfg, _, params = _params("falcon-mamba-7b")
    tokens = torch.from_numpy(np.random.default_rng(29).integers(
        0, cfg.vocab_size, (2, 512)))
    logits, states, walls = chip_smoke.prefill_by_blocks(
        params, cfg, {"tokens": tokens})
    want, caches = prefill(params, cfg, {"tokens": tokens}, max_len=512)
    assert len(states) == len(caches) == len(walls) == cfg.n_layers
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want[:, -1:].numpy(),
                               atol=1e-5)
    for got, ref in zip(states, caches):
        assert sorted(got) == sorted(ref) == ["conv", "h"]
        for name in got:
            assert torch.equal(got[name], ref[name])


@pytest.mark.parametrize("seq", [65_536, 524_288])
def test_mamba_block_peak_is_under_six_activations(seq):
    """A falcon-mamba-7b block at full width (B 1, bf16 compute) counted on
    ``meta``: its peak of live bytes is under six ``(1, S, d_inner)`` bf16
    tensors, the norm's output and ``x @ in_proj`` among them (nine before
    the conv's input, the conv output and dt were let go once read)."""
    full = get_config("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=1, layout=full.layout[:1])
    block = transformer.abstract_params(cfg).layers[0]
    x = torch.empty((1, seq, cfg.d_model), dtype=torch.bfloat16,
                    device="meta")
    c = roofline.analyze_step(
        lambda b, x: b(x, cfg, cache=None, pos=0, make_cache=True), block, x)
    unit = seq * cfg.d_inner * 2
    assert 5 * unit < c.peak_bytes < 6 * unit
    assert c.output_bytes < unit


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_all_finite_is_isfinite_all(dtype):
    """``all_finite`` says what ``torch.isfinite(t).all()`` says, with a
    NaN, an infinity of either sign or none at a random place."""
    rng = np.random.default_rng(30)
    for bad in (None, float("nan"), float("inf"), float("-inf")) * 3:
        t = torch.from_numpy(rng.normal(size=(2, 33, 17))).to(dtype)
        if bad is not None:
            t[tuple(int(rng.integers(n)) for n in t.shape)] = bad
        got = all_finite(t)
        assert got.dtype == torch.bool and got.shape == ()
        assert bool(got) == bool(torch.isfinite(t).all())


def test_serve_finite_check_takes_no_logits_sized_temporary():
    """Counted on ``meta`` at the 22a logits' shape (B 4 x 32,760 x
    92,544, bf16): ``all_finite`` creates a few bytes, ``isfinite(t).all()``
    2.5 times the logits."""
    t = torch.empty((4, 32_760, 92_544), dtype=torch.bfloat16, device="meta")
    size = t.numel() * t.element_size()
    assert roofline.analyze_step(all_finite, t).peak_bytes < 64
    assert roofline.analyze_step(lambda t: torch.isfinite(t).all(),
                                 t).peak_bytes >= 2 * size


def _old_bar_passes(err, plain, bar):
    """The bar phase 22 held before it went band by band: ``bar`` times the
    larger of 1 and the whole output's largest magnitude."""
    return err <= bar * max(1.0, float(plain.abs().max()))


def test_attention_hold_goes_band_by_band():
    """Causal attention with diffuse scores: o of row r averages r values,
    so the late rows are far smaller than the first.  The plain output
    rounded to bf16 passes each band's bar; o scaled by 1.1 past the
    sequence's middle (a fault of the normalisation at far tiles) fails
    it, though under the whole-sequence bar it passes."""
    rng = np.random.default_rng(31)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2048, 2, 64))).float()
               for _ in range(3))
    o_p, _ = ref.flash_fwd_chunked(0.5 * q, k, v, causal=True, q_chunk=256,
                                   kv_chunk=256)
    bar, band = chip_smoke.ATTN_TOL["bfloat16"], 256
    good = chip_smoke.band_errors(o_p.bfloat16(), o_p, band)
    assert len(good) == 2048 // band
    assert chip_smoke.worst_share(good) <= 2 ** -8
    assert good[-1][1] < 0.25 * good[0][1]        # the late rows are small
    bad = o_p.clone()
    bad[:, 1024:] *= 1.1
    bands = chip_smoke.band_errors(bad, o_p, band)
    assert chip_smoke.worst_share(bands) > bar
    assert all(e == 0 for e, _, _ in bands[:1024 // band])
    assert _old_bar_passes(max(e for e, _, _ in bands), o_p, bar)


def test_scan_hold_goes_segment_by_segment():
    """The plain scan run a segment at a time with its state carried gives
    the one call's ``y`` and ``h_final`` (error 0), one band a segment, and
    no time off the card; ``y`` 3% off in the late segments fails the bf16
    bar of each segment's own largest |y|, though under the whole-sequence
    bar it passes."""
    rng = np.random.default_rng(32)
    s, di, n = 4096, 16, 16
    x, dt = (torch.from_numpy(a).float() for a in (
        rng.normal(size=(1, s, di)), rng.uniform(0.001, 0.1, (1, s, di))))
    A = -torch.from_numpy(rng.uniform(0.5, 2.0, (di, n))).float()
    Bm, Cm = (torch.from_numpy(rng.normal(size=(1, s, n))).float()
              for _ in range(2))
    D = torch.from_numpy(rng.normal(size=di)).float()
    args = (x, dt, A, Bm, Cm, D)
    y, h = ref.selective_scan_chunked(*args, chunk=64)
    segs, dh, hm, ms = chip_smoke.scan_plain_in_segments(args, y, h, 64, 1024)
    assert len(segs) == s // 1024 and ms is None
    assert chip_smoke.worst_share(segs) == 0 and dh == 0 and hm > 0
    bad = y.clone()
    bad[:, 2048:] *= 1.03
    segs, dh, _, _ = chip_smoke.scan_plain_in_segments(args, bad, h, 64, 1024)
    assert chip_smoke.worst_share(segs) > chip_smoke.LONG_SCAN_BF16_TOL
    assert dh == 0 and segs[0][0] == segs[1][0] == 0
    assert _old_bar_passes(max(e for e, _, _ in segs), y,
                           chip_smoke.SCAN_TOL["bfloat16"])
