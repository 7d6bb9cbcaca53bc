"""The port's sharding layer (``repro_torch.sharding``, the model's pspecs
and mesh hooks, the sharded step factories) against the reference's.

Spec parity runs at the production mesh sizes (16, 16) and (2, 16, 16)
without devices: the reference's ``repro.sharding._ACTIVE`` is set to a
stub mesh that has only ``.shape``, the port's context to one with
``mesh_dim_names`` and ``shape``.  The reference stacks its body layers
over periods, so a stacked leaf's spec there is the port's unrolled leaf's
with a leading ``None``.

The steps run on a 1-rank mesh over a gloo group that each test starts
and destroys: the DTensor path with every placement ``Replicate`` or a
size-1 ``Shard``, held to the same steps without a mesh and to the
reference, in float32, within the bars of ``test_torch_models.py`` (1e-4)
and ``test_torch_train.py`` (1e-5 relative).
"""

import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import repro.sharding as ref_sharding
from repro import optim as ref_optim
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.data.pipeline import batch_pspecs as ref_batch_pspecs
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import loss_fn as ref_loss_fn
from repro.models import prefill as ref_prefill
from repro.models import transformer as ref_tf
from repro.train.loop import make_train_step as ref_make_train_step

from repro_torch import optim, serving, sharding
from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import batch_pspecs
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import moe, transformer
from repro_torch.models.convert import _layer_source, params_from_reference
from repro_torch.train.loop import make_sharded_train_step, make_train_step

ARCHS = ref_list_archs()
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CPU = torch.device("cpu")


@contextlib.contextmanager
def both_active(sizes, fsdp=False, long_context=False, **over):
    """Both packages' contexts on a stub mesh of ``sizes``, under the
    single- or multi-pod rules that fit it."""
    mk = "multi_pod_rules" if "pod" in sizes else "single_pod_rules"
    r_ref = dataclasses.replace(getattr(ref_sharding, mk)(
        fsdp=fsdp, long_context=long_context), **over)
    r_port = dataclasses.replace(getattr(sharding, mk)(
        fsdp=fsdp, long_context=long_context), **over)
    token = ref_sharding._ACTIVE.set(
        (types.SimpleNamespace(shape=dict(sizes)), r_ref))
    try:
        with sharding.mesh_context(types.SimpleNamespace(
                mesh_dim_names=tuple(sizes), shape=tuple(sizes.values())),
                r_port):
            yield r_ref, r_port
    finally:
        ref_sharding._ACTIVE.reset(token)


def _ref_leaf(cfg, tree, path):
    """``(keys, spec)``: where the port leaf at ``path`` lives in the
    reference tree, and its spec there with a stacked leaf's leading
    ``None`` taken off."""
    parts = path.split(".")
    if parts[0] == "layers":
        where, key, p = _layer_source(cfg, int(parts[1]))
        keys = (where, key) + tuple(parts[2:])
    else:
        keys, p = tuple(parts), None
    leaf = tree
    for k in keys:
        leaf = leaf[k]
    leaf = tuple(leaf)
    if p is not None:
        assert leaf[0] is None, (path, leaf)
        leaf = leaf[1:]
    return keys, leaf


def _ref_paths(tree):
    """Every leaf's keys in a reference tree of specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tuple))[0]
    return {tuple(str(k.key) for k in path) for path, _ in flat}


# ------------------------------------------------------------ spec parity --

@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_batch_pspecs_match_reference(arch, mesh, fsdp):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    with both_active(MESHES[mesh], fsdp=fsdp) as (r_ref, r_port):
        want = ref_tf.param_pspecs(ref_cfg, r_ref)
        got = transformer.param_pspecs(cfg, r_port)
        reached = set()
        for path, spec in got.items():
            keys, leaf = _ref_leaf(cfg, want, path)
            assert tuple(spec) == leaf, path
            reached.add(keys)
        assert reached == _ref_paths(want)
        for name in REF_SHAPES:
            b_ref = ref_batch_pspecs(ref_cfg, REF_SHAPES[name], r_ref)
            b_port = batch_pspecs(cfg, SHAPES[name], r_port)
            assert {k: tuple(v) for k, v in b_port.items()} == \
                {k: tuple(v) for k, v in b_ref.items()}, name


@pytest.mark.parametrize("long_context", [False, True],
                         ids=["short", "long"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "fsdp"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspecs_match_reference(arch, mesh, fsdp, long_context):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    with both_active(MESHES[mesh], fsdp=fsdp,
                     long_context=long_context) as (r_ref, r_port):
        want = ref_tf.cache_pspecs(ref_cfg, r_ref, long_context)
        got = transformer.cache_pspecs(cfg, r_port, long_context)
        assert len(got) == cfg.n_layers
        reached = set()
        for i, layer in enumerate(got):
            for name, spec in layer.items():
                keys, leaf = _ref_leaf(cfg, want, f"layers.{i}.{name}")
                assert tuple(spec) == leaf, (i, name)
                reached.add(keys)
        assert reached == _ref_paths(want)


@pytest.mark.parametrize("attn_mode", ["none", "auto", "ulysses", "cp"])
@pytest.mark.parametrize("sizes", [
    {"data": 1, "model": 1}, {"data": 2, "model": 4},
    {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
    {"data": 4, "model": 3}], ids=lambda s: "x".join(map(str, s.values())))
def test_spec_helpers_match_reference(sizes, attn_mode):
    """``head_axis_spec``, ``flash_mode``, ``act_spec_btd``,
    ``kv_cache_spec`` and the rest over a grid of head counts, head dims,
    batches and sequence lengths."""
    for long_context in (False, True):
        with both_active(sizes, long_context=long_context,
                         attn_mode=attn_mode):
            for h in (1, 2, 3, 4, 8, 14, 16, 40, 64):
                for hd in (48, 64, 96, 128, 256):
                    assert sharding.head_axis_spec(h, hd) == \
                        ref_sharding.head_axis_spec(h, hd)
                    assert tuple(sharding.attn_act_spec(h, hd)) == \
                        tuple(ref_sharding.attn_act_spec(h, hd))
                    assert tuple(sharding.kv_cache_spec(
                        h, hd, long_context)) == tuple(
                        ref_sharding.kv_cache_spec(h, hd, long_context))
            for b in (1, 2, 8, 32, 128, 256, 512):
                for s in (1, 3, 16, 1024, 32768):
                    assert sharding.flash_mode(b, s) == \
                        ref_sharding.flash_mode(b, s)
            for s in (None, 1, 3, 16, 4096):
                assert tuple(sharding.act_spec_btd(s)) == \
                    tuple(ref_sharding.act_spec_btd(s))
            for rank in (2, 3, 4):
                for fn in ("ulysses_spec", "cp_q_spec", "cp_kv_spec"):
                    assert tuple(getattr(sharding, fn)(rank)) == \
                        tuple(getattr(ref_sharding, fn)(rank))
            for fn in ("mamba_state_spec", "mamba_conv_state_spec",
                       "moe_group_spec", "logits_spec"):
                assert tuple(getattr(sharding, fn)()) == \
                    tuple(getattr(ref_sharding, fn)())
            assert sharding.batch_axes() == ref_sharding.batch_axes()


def test_specs_outside_a_mesh_match_reference():
    assert sharding.active() is None and ref_sharding.active() is None
    assert sharding.flash_mode(8, 1024) == "none"
    assert tuple(sharding.act_spec_btd(16)) == \
        tuple(ref_sharding.act_spec_btd(16))
    assert sharding.head_axis_spec(16, 128) == (None, None)
    x = torch.ones(2, 3)
    assert sharding.constrain(x, sharding.P("data", None)) is x


def test_to_placements_on_mixed_specs():
    m = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                              shape=(2, 16, 16))
    P = sharding.P
    assert sharding.to_placements(P(("pod", "data"), None, "model"), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sharding.to_placements(P(None, "model"), m) == \
        [Replicate(), Replicate(), Shard(1)]
    assert sharding.to_placements(P(), m) == [Replicate()] * 3
    assert sharding.to_placements(P("data", None, ("pod",)), m) == \
        [Shard(2), Shard(0), Replicate()]
    assert P(("data",), None) == ("data", None)
    with pytest.raises(ValueError, match="twice"):
        sharding.to_placements(P("data", "data"), m)
    with pytest.raises(ValueError, match="twice"):
        sharding.to_placements(P(("pod", "model"), "model"), m)
    with pytest.raises(ValueError, match="no mesh axis"):
        sharding.to_placements(P("expert"), m)
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements(P(("data", "pod")), m)


# ---------------------------------------------------- 1-rank DTensor path --

@pytest.fixture
def mesh():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        m = make_local_mesh(device_type="cpu")
        assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
        yield m
    finally:
        dist.destroy_process_group()


def test_meshes_raise_without_a_card(monkeypatch):
    """With no card and no ``device_type`` the meshes raise rather than
    build a mesh on the CPU; ``device_type="cpu"`` still builds one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            make_local_mesh()
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            make_production_mesh()
        assert make_local_mesh(device_type="cpu").device_type == "cpu"
    finally:
        dist.destroy_process_group()


def _flags(fsdp=True):
    return dataclasses.replace(sharding.single_pod_rules(fsdp=fsdp),
                               attn_mode="auto", ep_shard_map=True)


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _configs(arch, **over):
    return (dataclasses.replace(ref_get_config(arch, smoke=True),
                                dtype="float32", **over),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype="float32", **over))


def _params(arch, seed, **over):
    cfg_r, cfg_p = _configs(arch, **over)
    params_j = ref_init_params(cfg_r, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_r, cfg_p, params_j, lambda: params_from_reference(
        cfg_p, tree, CPU)


def test_full_model_loss_invariant_under_mesh_flags(mesh):
    """The reference's failing test's statement: qwen3-moe smoke in
    float32 with ``attn_causal_skip``, the loss on a 1-rank mesh with
    ``fsdp``, ``attn_mode="auto"`` and ``ep_shard_map`` equals the no-mesh
    loss (rel 1e-6), which is the reference's no-mesh loss (rel 1e-5)."""
    cfg_r, cfg, params_j, fresh = _params("qwen3-moe-30b-a3b", 3,
                                          attn_causal_skip=True)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             "targets": rng.integers(0, cfg.vocab_size, (2, 16))}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = fresh()
    loss0, _ = transformer.loss_fn(model, cfg, tb)
    rules = _flags()
    with sharding.mesh_context(mesh, rules):
        transformer.distribute_params(
            model, transformer.param_pspecs(cfg, rules), mesh)
        assert all(isinstance(p, DTensor) for p in model.parameters())
        db = sharding.distribute_tree(
            tb, {k: sharding.P("data", None) for k in tb}, mesh)
        loss1, _ = transformer.loss_fn(model, cfg, db)
    assert isinstance(loss1, DTensor)
    assert float(_full(loss1)) == pytest.approx(float(loss0), rel=1e-6)
    ref_loss, _ = ref_loss_fn(params_j, cfg_r,
                              {k: jnp.asarray(v) for k, v in batch.items()})
    assert float(loss0) == pytest.approx(float(ref_loss), rel=1e-5)


def test_ep_local_map_matches_plain(mesh, monkeypatch):
    """The ``local_map`` expert path on a (1,1) mesh equals the plain
    ``moe_apply`` exactly (values, aux) and in its gradients (1e-6):
    E_local == E, so the drops are the same."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True),
                              dtype="float32")
    layer = transformer.init_params(
        cfg, torch.Generator().manual_seed(2), CPU).layers[0].ffn
    p0 = {k: v.detach().clone().requires_grad_()
          for k, v in layer.named_parameters()}
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2, 8, cfg.d_model)).astype(
        np.float32)) * 0.1

    y_plain, aux_plain = moe.moe_apply(p0, x, cfg)
    calls = []
    local = moe._moe_local
    monkeypatch.setattr(moe, "_moe_local",
                        lambda *a, **k: calls.append(1) or local(*a, **k))
    g_plain = torch.autograd.grad(torch.sin(y_plain).sum(), list(p0.values()))
    rules = dataclasses.replace(sharding.single_pod_rules(),
                                ep_shard_map=True)
    with sharding.mesh_context(mesh, rules):
        specs = {k: sharding.logical_to_pspec(pd.axes, rules)
                 for k, pd in moe.moe_schema(cfg).items()}
        pd_ = {k: sharding.distribute(v, specs[k], mesh)
               for k, v in p0.items()}
        xd = sharding.distribute(x, sharding.P("data", None, None), mesh)
        y_sm, aux_sm = moe.moe_apply(pd_, xd, cfg)
        g_sm = torch.autograd.grad(torch.sin(y_sm).sum(), list(p0.values()))
    np.testing.assert_array_equal(_full(y_sm).detach().numpy(),
                                  y_plain.detach().numpy())
    assert float(_full(aux_sm).detach()) == float(aux_plain.detach())
    for a, b in zip(g_plain, g_sm):
        np.testing.assert_allclose(_full(b).numpy(), a.numpy(), atol=1e-6)
    # the explicit path, not the plain one, ran on the mesh (once)
    assert calls == [1] and isinstance(y_sm, DTensor)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_expert_shares_sum_to_the_plain_output(n_shards):
    """What each model shard computes under ``ep_shard_map`` — its own
    experts' choices, zeros for the rest, ranks and drops of the whole
    group — summed over the shards is the plain routed output (1e-6), as
    the all-reduce over the model axis makes it; here with capacity drops
    (capacity factor 0.5)."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b", smoke=True),
                              dtype="float32", capacity_factor=0.5)
    layer = transformer.init_params(
        cfg, torch.Generator().manual_seed(5), CPU).layers[0].ffn
    p = dict(layer.named_parameters())
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 16, cfg.d_model)).astype(np.float32))
    _, gates, idx = moe.route(x, p["router"], cfg.n_experts_active)
    cap = moe.capacity(cfg, 16)
    whole = moe._moe_local(x, idx, gates, p["wg"], p["wu"], p["wd"], 0, cap,
                           cfg.n_experts_active)
    e_local = cfg.n_experts // n_shards
    parts = [moe._moe_local(x, idx, gates,
                            *(p[w][i * e_local:(i + 1) * e_local]
                              for w in ("wg", "wu", "wd")),
                            i * e_local, cap, cfg.n_experts_active)
             for i in range(n_shards)]
    plain, _ = moe.moe_apply(p, x, dataclasses.replace(cfg,
                                                       n_shared_experts=0))
    np.testing.assert_array_equal(whole.detach().numpy(),
                                  plain.detach().numpy())
    np.testing.assert_allclose(sum(parts).detach().numpy(),
                               plain.detach().numpy(), atol=1e-6)
    order, slot, _ = moe.dispatch(idx, cfg.n_experts, cap)
    assert int((slot == cfg.n_experts * cap).sum()) > 0     # drops happened


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b", "internvl2-1b"])
def test_sharded_prefill_and_decode_match(mesh, arch):
    """``make_sharded_prefill`` / ``_decode`` on the 1-rank mesh: logits and
    caches equal to the unsharded steps' (1e-6) and to the reference's
    (1e-4), three decode steps."""
    cfg_r, cfg, params_j, fresh = _params(arch, 0)
    rng = np.random.default_rng(0)
    B, S, steps = 2, 8, 3
    P = cfg.vision_prefix if cfg.input_mode == "vlm" else 0
    max_len = S + steps + P
    prompt = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.input_mode == "vlm":
        prompt["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    nexts = [{"tokens": rng.integers(0, cfg.vocab_size, (B, 1))}
             for _ in range(steps)]
    tp = {k: torch.from_numpy(v) for k, v in prompt.items()}

    plain = fresh()
    l0, c0 = serving.prefill_fn(plain, tp, cfg=cfg, max_len=max_len)
    lj, cj = ref_prefill(params_j, cfg_r,
                         {k: jnp.asarray(v) for k, v in prompt.items()},
                         max_len=max_len)
    rules = _flags(fsdp=False)
    shape = dataclasses.replace(SHAPES["prefill_32k"], global_batch=B,
                                seq_len=S + P)
    sharded = fresh()
    with sharding.mesh_context(mesh, rules):
        pre = serving.make_sharded_prefill(
            cfg, rules, batch_pspecs(cfg, shape, rules), max_len=max_len)
        dec = serving.make_sharded_decode(
            cfg, rules, batch_pspecs(cfg, SHAPES["decode_32k"], rules))
        l1, c1 = pre(sharded, prompt)
    assert isinstance(l1, DTensor) and isinstance(c1[0][next(iter(c1[0]))],
                                                  DTensor)
    np.testing.assert_allclose(_full(l1).numpy(), l0.numpy(), atol=1e-6)
    np.testing.assert_allclose(_full(l1).numpy(), np.asarray(lj), atol=1e-4)
    for i, nb in enumerate(nexts):
        pos = P + S + i
        l0, c0 = serving.decode_fn(plain, c0,
                                   {"tokens": torch.from_numpy(nb["tokens"])},
                                   pos, cfg=cfg)
        lj, cj = ref_decode_step(params_j, cfg_r, cj,
                                 {"tokens": jnp.asarray(nb["tokens"])},
                                 jnp.asarray(pos))
        l1, c1 = dec(sharded, c1, nb, pos)
        np.testing.assert_allclose(_full(l1).numpy(), l0.numpy(), atol=1e-6)
        np.testing.assert_allclose(_full(l1).numpy(), np.asarray(lj),
                                   atol=1e-4)
    for a, b in zip(c0, c1):
        for name in a:
            np.testing.assert_allclose(_full(b[name]).numpy(),
                                       a[name].numpy(), atol=1e-6)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "qwen3-moe-30b-a3b"])
def test_sharded_train_step_matches(mesh, arch):
    """Two ``make_sharded_train_step`` steps on the 1-rank mesh against
    ``make_train_step``'s and the reference's: loss, grad norm and lr
    within 1e-5 relative, parameters within 1e-6 of the unsharded ones."""
    cfg_r, cfg, params_j, fresh = _params(arch, 6)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=100)
    rules = _flags()
    step_r = ref_make_train_step(cfg_r, ref_optim.OptConfig(**ocfg),
                                 donate=False)
    step_p = make_train_step(cfg, optim.OptConfig(**ocfg))
    plain, sharded = fresh(), fresh()
    opt_r = ref_optim.init_opt_state(params_j)
    opt_p, opt_s = optim.init_opt_state(plain), optim.init_opt_state(sharded)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=2,
                                seq_len=32)
    from repro_torch.data import pipeline
    with jax.enable_x64(False), sharding.mesh_context(mesh, rules):
        step_s = make_sharded_train_step(cfg, optim.OptConfig(**ocfg), rules,
                                         batch_pspecs(cfg, shape, rules))
        for s in range(2):
            batch = pipeline.make_batch(cfg, pipeline.DataConfig(seed=7),
                                        step=s, batch=2, seq=32)
            params_j, opt_r, m_r = step_r(
                params_j, opt_r, {k: jnp.asarray(v) for k, v in batch.items()})
            plain, opt_p, m_p = step_p(plain, opt_p, batch)
            sharded, opt_s, m_s = step_s(sharded, opt_s, batch)
            for key in ("loss", "grad_norm", "total_loss", "lr"):
                got = float(_full(m_s[key]))
                assert got == pytest.approx(float(m_p[key]), rel=1e-5), key
                assert got == pytest.approx(float(m_r[key]), rel=1e-5), key
    assert all(isinstance(p, DTensor) for p in sharded.parameters())
    assert isinstance(opt_s["m"][next(iter(opt_s["m"]))], DTensor)
    for (name, a), b in zip(plain.named_parameters(), sharded.parameters()):
        np.testing.assert_allclose(_full(b).detach().numpy(),
                                   a.detach().numpy(), atol=1e-6,
                                   err_msg=name)
