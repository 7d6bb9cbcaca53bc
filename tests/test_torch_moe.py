"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU, in float32 at smoke size.

Parameters come from the reference's ``init_params``; inputs are drawn with
numpy and handed to both.  ``moe_apply`` must agree within ``2e-5`` (output
and aux), with the same top-k experts and the same kept slots as the
reference's dispatch, including where the router's probabilities tie
(``jax.lax.top_k`` puts the lower expert id first) and where the capacity
drops tokens.  The reference's dispatch runs inside ``moe_apply`` in a
closure; :func:`_ref_slots` restates its lines in jax to read the slots.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import active_params as ref_active_params
from repro.models import init_params as ref_init_params
from repro.models import moe as ref_moe
from repro_torch.configs import get_config
from repro_torch.models import active_params, count_params
from repro_torch.models import moe

TOL = 2e-5


def _configs(arch, **overrides):
    ref = dataclasses.replace(ref_get_config(arch, smoke=True),
                              dtype="float32", **overrides)
    port = dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               **overrides)
    return ref, port


def _moe_leaves(cfg_r, seed):
    """The first MoE layer's leaves of the reference's ``init_params``."""
    tree = jax.tree.map(np.asarray, ref_init_params(cfg_r,
                                                    jax.random.PRNGKey(seed)))
    for where in ("prefix", "body"):
        for _, sub in sorted(tree.get(where, {}).items()):
            ffn = sub.get("ffn", {})
            if "router" in ffn:
                return {k: (v[0] if where == "body" else v)
                        for k, v in ffn.items()}
    raise AssertionError("no MoE layer")


def _ref_slots(probs, cfg):
    """The reference's top-k and dispatch lines (``moe.py:60-96``), in jax:
    ``(gate_idx (B,S,k), inv (B,S·k))``."""
    e, k = cfg.n_experts, cfg.n_experts_active
    b, s = probs.shape[:2]
    c = ref_moe.capacity(cfg, s)
    _, gate_idx = jax.lax.top_k(probs, k)

    def group(idxg):
        flat_e = idxg.reshape(-1)
        order = jnp.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        starts = jnp.searchsorted(sorted_e, jnp.arange(e), side="left")
        rank = jnp.arange(s * k) - starts[sorted_e]
        slot = jnp.where(rank < c, sorted_e * c + rank, e * c)
        return jnp.zeros((s * k,), jnp.int32).at[order].set(slot)

    return np.asarray(gate_idx), np.asarray(jax.vmap(group)(gate_idx))


def _both(arch, x, seed=0, leaves=None, **overrides):
    cfg_r, cfg_p = _configs(arch, **overrides)
    leaves = _moe_leaves(cfg_r, seed) if leaves is None else leaves
    y_r, aux_r = ref_moe.moe_apply({k: jnp.asarray(v)
                                    for k, v in leaves.items()},
                                   jnp.asarray(x), cfg_r)
    p = {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
    y_p, aux_p = moe.moe_apply(p, torch.from_numpy(x), cfg_p)
    probs_r = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(leaves["router"]),
                             axis=-1)
    idx_r, inv_r = _ref_slots(probs_r, cfg_r)
    _, _, idx_p = moe.route(torch.from_numpy(x), p["router"],
                            cfg_p.n_experts_active)
    _, _, inv_p = moe.dispatch(idx_p, cfg_p.n_experts,
                               moe.capacity(cfg_p, x.shape[1]))
    return (np.asarray(y_r), float(aux_r), idx_r, inv_r, y_p.numpy(),
            float(aux_p), idx_p.numpy(), inv_p.numpy(), cfg_p)


def _x(cfg_arch, B, S, seed, scale=1.0):
    d = ref_get_config(cfg_arch, smoke=True).d_model
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("arch,overrides", [
    ("qwen3-moe-30b-a3b", {}),
    ("kimi-k2-1t-a32b", {}),
    ("qwen3-moe-30b-a3b", {"capacity_factor": 0.5}),
    ("jamba-1.5-large-398b", {}),
], ids=["qwen3-moe", "kimi-k2-shared", "qwen3-moe-drops", "jamba"])
def test_moe_apply_matches_reference(arch, overrides):
    x = _x(arch, 3, 24, seed=1)
    (y_r, aux_r, idx_r, inv_r, y_p, aux_p, idx_p, inv_p,
     cfg) = _both(arch, x, **overrides)
    np.testing.assert_array_equal(idx_p, idx_r)
    np.testing.assert_array_equal(inv_p, inv_r)
    np.testing.assert_allclose(y_p, y_r, atol=TOL)
    assert abs(aux_p - aux_r) <= TOL
    dropped = int((inv_p == cfg.n_experts * moe.capacity(cfg, 24)).sum())
    if overrides.get("capacity_factor", 1.25) < 1:
        assert dropped > 0
    if cfg.n_shared_experts:
        assert "shared_wg" in dict(moe.MoE(cfg, "cpu", torch.float32)
                                   .named_parameters())


def test_capacity_matches_reference():
    for arch in ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
                 "jamba-1.5-large-398b"):
        for cf in (0.25, 0.5, 1.0, 1.25, 2.0, 8.0):
            cfg_r = dataclasses.replace(ref_get_config(arch),
                                        capacity_factor=cf)
            cfg_p = dataclasses.replace(get_config(arch), capacity_factor=cf)
            for s in (1, 7, 512, 1024, 4096):
                assert moe.capacity(cfg_p, s) == ref_moe.capacity(cfg_r, s)


def test_tied_router_probabilities_pick_the_lower_ids():
    """Every expert tied (a zero router), and pairs of tied experts (two
    equal router columns): the port's top k is ``jax.lax.top_k``'s, where
    ``torch.topk`` would be free to differ."""
    cfg_r, _ = _configs("qwen3-moe-30b-a3b")
    leaves = _moe_leaves(cfg_r, 4)
    x = _x("qwen3-moe-30b-a3b", 2, 16, seed=4)
    zero = dict(leaves, router=np.zeros_like(leaves["router"]))
    router = leaves["router"].copy()
    router[:, 1::2] = router[:, 0::2]           # expert 2j+1 ties 2j
    pairs = dict(leaves, router=router)
    for case in (zero, pairs):
        (y_r, aux_r, idx_r, inv_r, y_p, aux_p, idx_p, inv_p,
         _cfg) = _both("qwen3-moe-30b-a3b", x, leaves=case)
        np.testing.assert_array_equal(idx_p, idx_r)
        np.testing.assert_array_equal(inv_p, inv_r)
        np.testing.assert_allclose(y_p, y_r, atol=TOL)
        assert abs(aux_p - aux_r) <= TOL
    assert (idx_p[..., 0] % 2 == 0).all()        # the lower of each pair


def test_moe_conservation_and_aux():
    """With a huge capacity nothing drops, and the output equals a dense
    per-token evaluation of the chosen experts (the reference suite's
    oracle, here in torch); the aux is the Switch formula."""
    cfg_r, cfg = _configs("qwen3-moe-30b-a3b", capacity_factor=8.0)
    leaves = _moe_leaves(cfg_r, 2)
    p = {k: torch.from_numpy(np.array(v)) for k, v in leaves.items()}
    x = torch.from_numpy(_x("qwen3-moe-30b-a3b", 2, 8, seed=2, scale=0.1))
    y, aux = moe.moe_apply(p, x, cfg)
    assert torch.isfinite(y).all() and torch.isfinite(aux)
    probs, gates, idx = moe.route(x, p["router"], cfg.n_experts_active)
    _, _, inv = moe.dispatch(idx, cfg.n_experts, moe.capacity(cfg, 8))
    assert int(inv.max()) < cfg.n_experts * moe.capacity(cfg, 8)
    oracle = torch.zeros_like(x)
    for b in range(2):
        for t in range(8):
            for j in range(cfg.n_experts_active):
                ex = int(idx[b, t, j])
                h = (torch.nn.functional.silu(x[b, t] @ p["wg"][ex])
                     * (x[b, t] @ p["wu"][ex]))
                oracle[b, t] += gates[b, t, j] * (h @ p["wd"][ex])
    np.testing.assert_allclose(y.numpy(), oracle.numpy(), atol=1e-4)
    frac = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts) \
        / idx.numel()
    want = cfg.n_experts * torch.sum(probs.mean(dim=(0, 1)) * frac)
    assert float(aux) == pytest.approx(float(want), abs=1e-6)


@pytest.mark.parametrize("arch", ref_list_archs())
def test_active_params_match_reference(arch):
    got = active_params(get_config(arch))
    assert got == ref_active_params(ref_get_config(arch))
    cfg = get_config(arch)
    assert (got < count_params(cfg)) == (cfg.n_experts > 0)
