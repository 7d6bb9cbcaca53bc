"""The port's training path (``repro_torch.optim``, ``data.pipeline``, the
gradient ``Function``s of ``kernels.ops``, ``models.transformer.loss_fn``
with its remat policies, and ``train.loop``) against the reference on the
CPU.

Inputs are drawn with numpy and handed to both packages; parameters come
from the reference's ``init_params`` through ``params_from_reference`` and
gradients go back through ``params_to_reference``.  Smoke configs in
float32.  Tolerances: the optimizer within 1e-6 relative, the attention
gradients within 2e-5, the scan's within 1e-4, the loss within 1e-5
relative and its gradients within 2e-5 absolute + 1e-4 relative.

**x64.**  The reference's learning rate mixes an int32 step with Python
floats, so its last bits depend on ``jax_enable_x64``, which the JAX
decision plane switches on for its whole process (an earlier test file in
the same worker may have done so).  An autouse fixture runs every test
here with x64 *off*, the reference's regime for training;
``test_schedule_matches_reference`` compares both regimes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.data import pipeline as ref_pipeline
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models import init_params as ref_init_params
from repro.models import transformer as ref_transformer
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import optim
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import pipeline
from repro_torch.kernels import ops, ref
from repro_torch.models import forward, init_params, loss_fn, prefill
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.transformer import reference_ranks, remat_passes
from repro_torch.train.loop import make_train_step

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def x64_off():
    """Run the reference with ``jax_enable_x64`` off (see the module
    docstring), whatever an earlier test in this process set."""
    with jax.enable_x64(False):
        assert not jax.config.jax_enable_x64
        yield


def _configs(arch, **overrides):
    ref = dataclasses.replace(ref_get_config(arch, smoke=True),
                              dtype="float32", **overrides)
    port = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               **overrides)
    return ref, port


def _params(arch, seed=0, **overrides):
    cfg_r, cfg_p = _configs(arch, **overrides)
    params_j = ref_init_params(cfg_r, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_r, cfg_p, params_j, params_from_reference(cfg_p, tree, CPU)


def _batch(cfg, seed=1, step=0, batch=2, seq=32):
    if cfg.input_mode == "vlm":
        seq += cfg.vision_prefix
    return pipeline.make_batch(cfg, pipeline.DataConfig(seed=seed),
                               step=step, batch=batch, seq=seq)


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _leaves_with_path(tree):
    """``{"a/b/c": array}`` of a reference tree."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in flat}


def _port_grads(model, cfg, batch):
    """``(total, metrics, {path: grad})`` of the port's loss."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    total, metrics = loss_fn(model, cfg, _t(batch))
    grads = torch.autograd.grad(total, list(named.values()))
    return total, metrics, dict(zip(named, grads))


def _assert_close_rel(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 1e-30)
    assert np.all(np.abs(got - want) <= rtol * scale), (got, want)


# ---------------------------------------------------------------- optim ----

@pytest.mark.parametrize("x64", [False, True], ids=["x64-off", "x64-on"])
def test_schedule_matches_reference(x64):
    """Warmup, cosine and floor, within 1e-6 relative in both x64 regimes
    (the reference's warm-up term is float64 with x64 on, rounded to
    float32 by the ``where``; the port computes in float32)."""
    cfg_kw = dict(lr=1e-3, warmup_steps=10, total_steps=100,
                  min_lr_ratio=0.1)
    with jax.enable_x64(x64):
        assert jax.config.jax_enable_x64 == x64
        want = [np.asarray(ref_optim.schedule(
            jnp.asarray(s, jnp.int32), ref_optim.OptConfig(**cfg_kw)))
            for s in range(0, 130, 3)]
    got = [optim.schedule(torch.tensor(s, dtype=torch.int32),
                          optim.OptConfig(**cfg_kw)) for s in range(0, 130, 3)]
    assert all(g.dtype == torch.float32 for g in got)
    _assert_close_rel([float(g) for g in got], [float(w) for w in want], 1e-6)


def _random_tree(rng):
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "stack": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "s": np.asarray(rng.normal(), np.float32)}


@pytest.mark.parametrize("grad_scale", [0.01, 100.0],
                         ids=["unclipped", "clipped"])
def test_adamw_matches_reference(grad_scale):
    """Four steps of ``adamw_update`` on a random tree (matrices decayed,
    vectors and scalars not): parameters, moments, learning rate and
    gradient norm within 1e-6 relative of the reference's."""
    rng = np.random.default_rng(3)
    tree = _random_tree(rng)
    cfg_r = ref_optim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    cfg_p = optim.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    p_r = {k: jnp.asarray(v) for k, v in tree.items()}
    p_t = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    s_r, s_t = ref_optim.init_opt_state(p_r), optim.init_opt_state(p_t)
    for _ in range(4):
        grads = {k: np.asarray(rng.normal(size=v.shape) * grad_scale,
                               np.float32) for k, v in tree.items()}
        p_r, s_r, m_r = ref_optim.adamw_update(
            p_r, {k: jnp.asarray(g) for k, g in grads.items()}, s_r, cfg_r)
        p_t, s_t, m_t = optim.adamw_update(
            p_t, {k: torch.from_numpy(g) for k, g in grads.items()}, s_t,
            cfg_p)
        for key in ("lr", "grad_norm"):
            _assert_close_rel(float(m_t[key]), float(m_r[key]), 1e-6)
        for k in tree:
            np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_r[k]),
                                       rtol=1e-6, atol=1e-7)
            for mom in ("m", "v"):
                np.testing.assert_allclose(
                    s_t[mom][k].numpy(), np.asarray(s_r[mom][k]),
                    rtol=1e-6, atol=1e-12)
    assert int(s_t["step"]) == int(s_r["step"]) == 4


def test_global_norm_matches_reference():
    tree = _random_tree(np.random.default_rng(4))
    want = ref_optim.global_norm({k: jnp.asarray(v) for k, v in tree.items()})
    got = optim.global_norm({k: torch.from_numpy(np.asarray(v))
                             for k, v in tree.items()})
    _assert_close_rel(float(got), float(want), 1e-6)


def test_adamw_minimizes_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.init_opt_state(params)
    cfg = optim.OptConfig(lr=0.2, warmup_steps=0, total_steps=200,
                          weight_decay=0.0, clip_norm=10.0)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = optim.adamw_update(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.05


def test_grad_clipping():
    params = {"w": torch.ones(4)}
    state = optim.init_opt_state(params)
    cfg = optim.OptConfig(clip_norm=1.0, warmup_steps=0)
    _, _, m = optim.adamw_update(params, {"w": torch.full((4,), 100.0)},
                                 state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_schedule_shape():
    cfg = optim.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    lrs = [float(optim.schedule(s, cfg)) for s in range(100)]
    assert lrs[0] < lrs[9] <= cfg.lr * 1.0001          # warmup rises
    assert max(lrs) <= cfg.lr * 1.0001
    assert lrs[-1] >= cfg.lr * cfg.min_lr_ratio * 0.99  # cosine floor


def test_weight_decay_follows_reference_stacked_leaves():
    """kimi-k2 (one prefix layer, a scanned body): with zero gradients a
    step is decay alone.  The reference decays a body layer's norm scale
    (2-D there, stacked over periods) and leaves the prefix layer's and
    ``final_norm``'s (1-D) alone; the port, whose layers are unrolled,
    follows the reference's ranks, and every leaf lands within 1e-6 of the
    reference's."""
    cfg_r, cfg_p, params_j, model = _params("kimi-k2-1t-a32b")
    assert cfg_p.prefix_layers == 1
    ocfg = dict(lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.5)
    zeros_j = jax.tree.map(jnp.zeros_like, params_j)
    new_j, _, _ = ref_optim.adamw_update(
        params_j, zeros_j, ref_optim.init_opt_state(params_j),
        ref_optim.OptConfig(**ocfg))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    zeros_t = {k: torch.zeros_like(p) for k, p in model.named_parameters()}
    optim.adamw_update(model, zeros_t, optim.init_opt_state(model),
                       optim.OptConfig(**ocfg), ranks=reference_ranks(cfg_p))
    after = dict(model.named_parameters())
    body, prefix = "layers.1.mixer_norm.scale", "layers.0.mixer_norm.scale"
    assert after[body].ndim == 1 and reference_ranks(cfg_p)[body] == 2
    assert not torch.equal(after[body], before[body])          # decayed
    assert torch.equal(after[prefix], before[prefix])          # not decayed
    assert torch.equal(after["final_norm.scale"], before["final_norm.scale"])
    assert np.asarray(new_j["body"]["0"]["mixer_norm"]["scale"]).ndim == 2
    want = _leaves_with_path(new_j)
    got = _leaves_with_path(params_to_reference(cfg_p, model))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # a port step by its own tensors' ranks would not decay the body norm
    model2 = params_from_reference(cfg_p, jax.tree.map(np.asarray, params_j),
                                   CPU)
    optim.adamw_update(model2, zeros_t, optim.init_opt_state(model2),
                       optim.OptConfig(**ocfg))
    assert torch.equal(model2.get_parameter(body), before[body])


# ----------------------------------------------------------------- data ----

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "musicgen-large",
                                  "internvl2-1b"],
                         ids=["tokens", "audio_codes", "vlm"])
def test_make_batch_matches_reference(arch):
    """The same arrays, bit for bit, over steps, shards and worlds."""
    cfg_r, cfg_p = ref_get_config(arch, smoke=True), get_config(arch,
                                                                 smoke=True)
    seq = 48 if cfg_p.input_mode == "vlm" else 32
    for step, shard, world in ((0, 0, 1), (7, 2, 4), (8, 3, 4), (100, 0, 2)):
        kw = dict(step=step, shard=shard, world=world, batch=3, seq=seq)
        a = ref_pipeline.make_batch(cfg_r, ref_pipeline.DataConfig(seed=11),
                                    **kw)
        b = pipeline.make_batch(cfg_p, pipeline.DataConfig(seed=11), **kw)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["musicgen-large", "internvl2-1b",
                                  "qwen2.5-14b"])
def test_batch_specs_match_reference(arch):
    for shape in SHAPES.values():
        want = ref_pipeline.batch_specs(ref_get_config(arch), shape)
        got = pipeline.batch_specs(get_config(arch), shape)
        assert want.keys() == got.keys()
        for k in want:
            assert tuple(want[k].shape) == got[k].shape
            assert np.dtype(want[k].dtype) == got[k].dtype


def test_prefetcher_keeps_order():
    items = list(range(50))
    assert list(pipeline.Prefetcher(iter(items), depth=3)) == items


# ------------------------------------------------------------ attention ----

ATTN_CASES = [
    # (B, S, H, KV, hd, causal, q_chunk, kv_chunk, causal_skip)
    (2, 32, 4, 2, 16, True, 8, 8, False),     # GQA 2, 4 x 4 blocks
    (2, 32, 8, 2, 16, True, 16, 8, False),    # GQA 4
    (1, 24, 4, 1, 8, False, 8, 12, False),    # non-causal, GQA 4
    (2, 32, 4, 2, 16, True, 8, 8, True),      # the triangular schedule
]


def _attn_inputs(b, s, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                       (b, s, h, hd))]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=["gqa2", "gqa4", "noncausal", "causal_skip"])
def test_flash_attention_gradients_match_reference(case):
    """``o`` and ``dq, dk, dv`` of ``Σ o·w`` through the port's
    ``FlashAttention`` on the CPU against ``jax.grad`` through the
    reference's ``ops.flash_attention(impl="chunked")``, within 2e-5."""
    b, s, h, kv, hd, causal, qc, kc, skip = case
    q, k, v, w = _attn_inputs(b, s, h, kv, hd, seed=s + h)

    def ref_loss(q, k, v):
        o = ref_ops.flash_attention(q, k, v, causal=causal, impl="chunked",
                                    q_chunk=qc, kv_chunk=kc,
                                    causal_skip=skip)
        return jnp.sum(o * w), o

    (_, o_r), g_r = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o_t = ops.flash_attention(qt, kt, vt, causal=causal, impl="auto",
                              q_chunk=qc, kv_chunk=kc, causal_skip=skip)
    g_t = torch.autograd.grad((o_t * torch.from_numpy(w)).sum(),
                              (qt, kt, vt))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_r),
                               atol=2e-5)
    for got, want in zip(g_t, g_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_chunked_matches_reference(causal):
    """The backward alone, from the same ``(o, lse, do)``."""
    q, k, v, do = _attn_inputs(2, 32, 8, 2, 16, seed=21)
    o, lse = ref_kernels.flash_fwd_chunked(q, k, v, causal=causal,
                                           q_chunk=8, kv_chunk=16)
    want = ref_kernels.flash_bwd_chunked(q, k, v, o, lse, do, causal=causal,
                                         q_chunk=8, kv_chunk=16)
    got = ref.flash_bwd_chunked(*(torch.from_numpy(np.array(a))
                                  for a in (q, k, v, o, lse, do)),
                                causal=causal, q_chunk=8, kv_chunk=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


# ----------------------------------------------------------------- scan ----

def _scan_inputs(b, s, di, n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.normal(size=(b, s, di)).astype(np.float32),
        dt=rng.uniform(0.001, 0.1, size=(b, s, di)).astype(np.float32),
        A=-rng.uniform(0.5, 2.0, size=(di, n)).astype(np.float32),
        Bmat=rng.normal(size=(b, s, n)).astype(np.float32),
        Cmat=rng.normal(size=(b, s, n)).astype(np.float32),
        D=rng.normal(size=(di,)).astype(np.float32),
        h0=rng.normal(size=(b, di, n)).astype(np.float32),
        wy=rng.normal(size=(b, s, di)).astype(np.float32),
        wh=rng.normal(size=(b, di, n)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "h0"])
def test_selective_scan_gradients_match_reference(with_h0):
    """The six input gradients (and ``h0``'s) of ``Σ y·wy + Σ h·wh`` through
    the port's ``SelectiveScan`` (its backward recomputes the chunks in
    reverse) against ``jax.grad`` of the reference's chunked scan, within
    1e-4; 4 chunks of 8."""
    a = _scan_inputs(2, 32, 12, 6, seed=5 + with_h0)
    names = ["x", "dt", "A", "Bmat", "Cmat", "D"] + (["h0"] if with_h0
                                                     else [])

    def ref_loss(*args):
        kw = dict(zip(names, args))
        y, h = ref_kernels.selective_scan_chunked(
            kw["x"], kw["dt"], kw["A"], kw["Bmat"], kw["Cmat"], kw["D"],
            h0=kw.get("h0"), chunk=8)
        return jnp.sum(y * a["wy"]) + jnp.sum(h * a["wh"])

    g_r = jax.grad(ref_loss, argnums=tuple(range(len(names))))(
        *(a[n] for n in names))
    ts = {n: torch.from_numpy(a[n]).requires_grad_() for n in names}
    y, h = ops.selective_scan(ts["x"], ts["dt"], ts["A"], ts["Bmat"],
                              ts["Cmat"], ts["D"], h0=ts.get("h0"),
                              impl="chunked", chunk=8)
    loss = (y * torch.from_numpy(a["wy"])).sum() \
        + (h * torch.from_numpy(a["wh"])).sum()
    g_t = torch.autograd.grad(loss, [ts[n] for n in names])
    for n, got, want in zip(names, g_t, g_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=n)


def test_selective_scan_gradient_of_y_alone():
    """Only ``y`` used (the model's case): the state's gradient is None."""
    a = _scan_inputs(1, 16, 8, 4, seed=9)
    names = ["x", "dt", "A", "Bmat", "Cmat", "D"]
    g_r = jax.grad(lambda *args: jnp.sum(ref_kernels.selective_scan_chunked(
        *args, chunk=4)[0] * a["wy"]), argnums=tuple(range(6)))(
        *(a[n] for n in names))
    ts = [torch.from_numpy(a[n]).requires_grad_() for n in names]
    y, _ = ops.selective_scan(*ts, impl="chunked", chunk=4)
    g_t = torch.autograd.grad((y * torch.from_numpy(a["wy"])).sum(), ts)
    for n, got, want in zip(names, g_t, g_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   err_msg=n)


# ----------------------------------------------------------------- loss ----

@pytest.mark.parametrize("arch", ref_list_archs())
def test_loss_and_gradients_match_reference(arch):
    """``loss_fn`` (cross-entropy, z-loss, router aux; the audio and vlm
    target moves) and every parameter gradient against the reference's
    ``jax.value_and_grad``: loss within 1e-5 relative, gradients within
    2e-5 + 1e-4 relative."""
    cfg_r, cfg_p, params_j, model = _params(arch, seed=2)
    batch = _batch(cfg_p, seed=3)
    (tot_r, m_r), g_r = jax.jit(jax.value_and_grad(
        ref_transformer.loss_fn, has_aux=True), static_argnums=1)(
        params_j, cfg_r, _j(batch))
    tot_t, m_t, g_t = _port_grads(model, cfg_p, batch)
    _assert_close_rel(float(tot_t.detach()), float(tot_r), 1e-5)
    for key in ("loss", "z_loss", "tokens"):
        _assert_close_rel(float(m_t[key].detach()), float(m_r[key]), 1e-5)
    assert abs(float(m_t["moe_aux"].detach()) - float(m_r["moe_aux"])) \
        <= 2e-5
    want = _leaves_with_path(g_r)
    got = _leaves_with_path(params_to_reference(cfg_p, g_t))
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["jamba-1.5-large-398b", "qwen2.5-14b"])
def test_remat_policies_give_the_same_gradients(arch, monkeypatch):
    """``"none"``, ``"dots"`` and ``"full"``: gradients within 1e-6.  Each
    layer's sequence op (the kernel on the card) runs once a step without
    remat and twice with it (forward + recompute): ``remat_passes``, which
    chip_smoke.py's launch checks use."""
    calls = {"flash": 0, "scan": 0}
    fwd = {"flash": ops.FlashAttention.forward,
           "scan": ops.SelectiveScan.forward}

    def counting(name):
        def f(*args, **kw):
            calls[name] += 1
            return fwd[name](*args, **kw)
        return staticmethod(f)

    monkeypatch.setattr(ops.FlashAttention, "forward", counting("flash"))
    monkeypatch.setattr(ops.SelectiveScan, "forward", counting("scan"))
    grads = {}
    for policy in ("none", "dots", "full"):
        _, cfg_p, _, model = _params(arch, seed=4, remat_policy=policy)
        calls.update(flash=0, scan=0)
        _, _, grads[policy] = _port_grads(model, cfg_p, _batch(cfg_p))
        attn = sum(spec.mixer == "attn" for spec in cfg_p.layout)
        want = remat_passes(cfg_p)
        assert want == (1 if policy == "none" else 2)
        assert calls == {"flash": want * attn,
                         "scan": want * (cfg_p.n_layers - attn)}, policy
    for policy in ("dots", "full"):
        for k, g in grads["none"].items():
            np.testing.assert_allclose(grads[policy][k].numpy(), g.numpy(),
                                       atol=1e-6, err_msg=f"{policy} {k}")


def test_prefill_and_decode_stay_without_grad():
    """Leaves that require grad (after a train step) leave prefill and
    decode outside autograd; the train mode records a graph."""
    cfg = get_config("falcon-mamba-7b", smoke=True)
    model = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    for p in model.parameters():
        p.requires_grad_(True)
    tokens = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16))}
    logits, caches = prefill(model, cfg, tokens, max_len=20)
    assert not logits.requires_grad
    assert not any(t.requires_grad for c in caches for t in c.values())
    logits, _, _ = forward(model, cfg, tokens, mode="train")
    assert logits.requires_grad


# ----------------------------------------------------------- train step ----

@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b"])
def test_train_step_matches_reference(arch):
    """Three ``make_train_step`` steps against the reference's: loss and
    ``grad_norm`` within 1e-5 relative at each step, parameters within
    2e-5 after three.  Adam divides by √v, so an entry whose gradient is at
    float noise can flip the sign of its update: only entries whose
    gradient magnitude at some step is below 1e-6 × the leaf's largest are
    excused, and they are counted (at most 1 in 1000)."""
    cfg_r, cfg_p, params_j, model = _params(arch, seed=6)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=100)
    step_r = ref_make_train_step(cfg_r, ref_optim.OptConfig(**ocfg),
                                 donate=False)
    step_p = make_train_step(cfg_p, optim.OptConfig(**ocfg))
    opt_r = ref_optim.init_opt_state(params_j)
    opt_p = optim.init_opt_state(model)
    tiny = {}
    for s in range(3):
        batch = _batch(cfg_p, seed=7, step=s, batch=2, seq=32)
        _, _, g = _port_grads(model, cfg_p, batch)
        for k, gk in _leaves_with_path(params_to_reference(cfg_p, g)).items():
            small = np.abs(gk) < 1e-6 * np.abs(gk).max()
            tiny[k] = small | tiny.get(k, np.zeros_like(small))
        params_j, opt_r, m_r = step_r(params_j, opt_r, _j(batch))
        model, opt_p, m_p = step_p(model, opt_p, batch)
        for key in ("loss", "grad_norm", "total_loss"):
            _assert_close_rel(float(m_p[key]), float(m_r[key]), 1e-5)
        _assert_close_rel(float(m_p["lr"]), float(m_r["lr"]), 1e-6)
        assert set(m_p) == set(m_r) | {"total_loss"}
    want = _leaves_with_path(params_j)
    got = _leaves_with_path(params_to_reference(cfg_p, model))
    excused = total = 0
    for k in want:
        bad = np.abs(got[k] - want[k]) > 2e-5
        assert not np.any(bad & ~tiny[k]), k
        excused += int(np.sum(bad))
        total += want[k].size
    assert excused <= total // 1000, (excused, total)


def test_train_step_improves_loss():
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    opt_state = optim.init_opt_state(params)
    step = make_train_step(cfg, optim.OptConfig(lr=3e-3, warmup_steps=2,
                                                total_steps=100),
                           donate=False)
    dcfg = pipeline.DataConfig(seed=0)
    losses = []
    for s in range(20):
        batch = pipeline.make_batch(cfg, dcfg, step=s, batch=4, seq=64)
        params, opt_state, metrics = step(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1
