"""The port's serving path (``repro_torch.models``, ``serving``,
``launch.serve``) against the reference package on the CPU.

Parameters come from the reference's ``init_params`` and are converted
with ``params_from_reference``; prompts and decode tokens are drawn with
numpy and handed to both.  Configs are the smoke ones in float32 (bf16
matmuls accumulate differently in JAX and PyTorch on the CPU; the kernels'
bf16 bars are held per kernel in ``test_torch_kernels.py`` and on the card).
Tolerance: logits and caches within ``1e-4`` of the reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import count_params as ref_count_params
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.serve import serve
from repro_torch.models import (count_params, decode_step, forward,
                                init_cache, init_params, prefill)
from repro_torch.models.convert import (caches_from_reference,
                                        caches_to_reference,
                                        params_from_reference)

NON_MOE = ["internlm2-1.8b", "falcon-mamba-7b", "stablelm-3b",
           "qwen2.5-14b", "qwen2.5-32b", "internvl2-1b", "musicgen-large"]
MOE = ["jamba-1.5-large-398b", "kimi-k2-1t-a32b", "qwen3-moe-30b-a3b"]
ALL_ARCHS = ref_list_archs()
CPU = torch.device("cpu")
TOL = 1e-4


def _configs(arch):
    ref = dataclasses.replace(ref_get_config(arch, smoke=True),
                              dtype="float32")
    port = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    return ref, port


def _params(arch, seed=0):
    cfg_r, cfg_p = _configs(arch)
    params_j = ref_init_params(cfg_r, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params_j)
    return cfg_r, cfg_p, params_j, params_from_reference(cfg_p, tree, CPU)


def _inputs(cfg, rng, B, S):
    """Prompt arrays (numpy) for ``cfg``'s input mode."""
    if cfg.input_mode == "audio_codes":
        return {"codes": rng.integers(0, cfg.vocab_size,
                                      (B, cfg.n_codebooks, S))}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.input_mode == "vlm":
        out["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", NON_MOE + MOE)
def test_prefill_and_decode_match_reference(arch):
    """prefill + 3 decode steps: logits of every step and the final caches
    within 1e-4 of the reference's."""
    cfg_r, cfg_p, params_j, params_t = _params(arch)
    rng = np.random.default_rng(0)
    B, S, steps = 2, 8, 3
    P = cfg_p.vision_prefix if cfg_p.input_mode == "vlm" else 0
    max_len = S + steps + P
    prompt = _inputs(cfg_p, rng, B, S)
    nexts = [_inputs(cfg_p, rng, B, 1) for _ in range(steps)]
    for nb in nexts:
        nb.pop("vision_embeds", None)

    lj, cj = ref_prefill(params_j, cfg_r, _j(prompt), max_len=max_len)
    lt, ct = prefill(params_t, cfg_p, _t(prompt), max_len=max_len)
    assert tuple(lt.shape) == lj.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    for i, nb in enumerate(nexts):
        lj, cj = ref_decode_step(params_j, cfg_r, cj, _j(nb),
                                 jnp.asarray(P + S + i))
        lt, ct = decode_step(params_t, cfg_p, ct, _t(nb), P + S + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)

    want = jax.tree.map(lambda a: np.asarray(a, np.float32), cj)
    got = caches_to_reference(cfg_p, ct)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=TOL)


def test_decode_from_converted_reference_caches():
    """A decode step on caches carried across from the reference equals the
    reference's step on its own caches."""
    cfg_r, cfg_p, params_j, params_t = _params("falcon-mamba-7b", seed=2)
    rng = np.random.default_rng(2)
    prompt = _inputs(cfg_p, rng, 2, 8)
    nb = _inputs(cfg_p, rng, 2, 1)
    _, cj = ref_prefill(params_j, cfg_r, _j(prompt), max_len=9)
    ct = caches_from_reference(cfg_p, jax.tree.map(np.asarray, cj), CPU)
    lj, _ = ref_decode_step(params_j, cfg_r, cj, _j(nb), jnp.asarray(8))
    lt, _ = decode_step(params_t, cfg_p, ct, _t(nb), 8)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)


@pytest.mark.parametrize("arch,plain", [("internlm2-1.8b",
                                         "attention_naive"),
                                        ("falcon-mamba-7b",
                                         "selective_scan_ref")])
def test_config_of_the_call_selects_the_implementation(arch, plain,
                                                      monkeypatch):
    """``attention_impl`` is read from the config handed to ``prefill``, not
    the one the modules were built with: ``"naive"`` routes every layer
    through the plain version it names."""
    from repro_torch.kernels import ref as port_ref
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    calls = []
    real = getattr(port_ref, plain)
    monkeypatch.setattr(port_ref, plain,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    prompt = _t(_inputs(cfg, np.random.default_rng(0), 2, 8))
    l_auto, _ = prefill(params, cfg, prompt, max_len=8)
    assert calls == []
    l_naive, _ = prefill(params, dataclasses.replace(
        cfg, attention_impl="naive"), prompt, max_len=8)
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(l_naive.numpy(), l_auto.numpy(), atol=TOL)


def test_registry_matches_reference():
    assert list_archs() == ALL_ARCHS
    assert sorted(NON_MOE + MOE) == ALL_ARCHS
    for arch in list_archs():
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                    == dataclasses.asdict(ref_get_config(arch, smoke=smoke)))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_count_params_matches_reference(arch):
    assert count_params(get_config(arch)) == \
        ref_count_params(ref_get_config(arch))


def test_init_params_follows_the_init_kinds():
    cfg = get_config("falcon-mamba-7b", smoke=True)
    gen = torch.Generator().manual_seed(0)
    model = init_params(cfg, gen, CPU)
    n = sum(p.numel() for p in model.parameters())
    assert n == count_params(cfg)
    mixer = model.layers[0].mixer
    assert torch.equal(mixer.a_log[0], torch.log(torch.arange(
        1, cfg.ssm_state + 1, dtype=torch.float32)))
    assert torch.all(mixer.dt_b == -4.6) and torch.all(mixer.d_skip == 1)
    assert torch.all(mixer.conv_b == 0)
    assert abs(float(model.embed.tok.std()) - 0.02) < 2e-3
    assert not any(p.requires_grad for p in model.parameters())


def test_init_cache_shapes():
    cfg = get_config("internlm2-1.8b", smoke=True)
    caches = init_cache(cfg, 2, 16, CPU)
    hd = cfg.resolved_head_dim
    assert len(caches) == cfg.n_layers
    assert caches[0]["k"].shape == (2, 16, cfg.n_kv_heads, hd)
    assert caches[0]["k"].dtype == torch.bfloat16


def _jax_serve(cfg, params, *, requests, batch, prompt_len, new_tokens,
               seed):
    """The reference's serving loop, driven by its jitted prefill and decode
    step, popping ``min(B, len(queue))`` requests."""
    rng = np.random.default_rng(seed)
    B, S, N = batch, prompt_len, new_tokens
    vp = cfg.vision_prefix if cfg.input_mode == "vlm" else 0
    max_len = S + N + vp
    pre = jax.jit(lambda p, b: ref_prefill(p, cfg, b, max_len=max_len))
    step = jax.jit(lambda p, c, t, pos: ref_decode_step(p, cfg, c, t, pos))
    queue, out = list(range(requests)), []
    while queue:
        n = min(B, len(queue))
        del queue[:n]
        if cfg.input_mode == "audio_codes":
            inputs = {"codes": jnp.asarray(rng.integers(
                0, cfg.vocab_size, (B, cfg.n_codebooks, S)))}
        elif cfg.input_mode == "vlm":
            inputs = {"tokens": jnp.asarray(rng.integers(
                0, cfg.vocab_size, (B, S))),
                "vision_embeds": jnp.asarray(rng.normal(
                    size=(B, vp, cfg.d_model)), jnp.float32)}
        else:
            inputs = {"tokens": jnp.asarray(rng.integers(
                0, cfg.vocab_size, (B, S)))}
        logits, caches = pre(params, inputs)
        nxt = jnp.argmax(logits[:, -1:, ...], axis=-1)
        gen = [nxt]
        for i in range(N):
            if cfg.input_mode == "audio_codes":
                inp = {"codes": jnp.moveaxis(nxt, 2, 1)}
            else:
                inp = {"tokens": nxt.reshape(B, -1)[:, :1]}
            logits, caches = step(params, caches, inp,
                                  jnp.asarray(S + vp + i))
            nxt = jnp.argmax(logits[:, -1:, ...], axis=-1)
            gen.append(nxt)
        out.append(np.asarray(jnp.concatenate(gen, axis=1))[:n])
    return out


@pytest.mark.parametrize("arch", NON_MOE + MOE)
def test_serve_greedy_tokens_match_reference_loop(arch):
    cfg_r, cfg_p, params_j, params_t = _params(arch, seed=1)
    kw = dict(requests=4, batch=2, prompt_len=8, new_tokens=4, seed=3)
    want = _jax_serve(cfg_r, params_j, **kw)
    got = serve(cfg_p, params_t, device="cpu", **kw)
    assert got["served"] == 4 and got["all_finite"]
    assert len(got["tokens"]) == len(want) == 2
    for g, w in zip(got["tokens"], want):
        np.testing.assert_array_equal(g, w)


def test_serve_partial_batch_serves_every_request():
    """``requests % batch != 0``: the last batch is padded, every request
    served (the reference loop raises IndexError here)."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    out = serve(cfg, params, requests=5, batch=2, prompt_len=8,
                new_tokens=3, seed=0, device="cpu")
    assert out["served"] == 5 and out["all_finite"]
    assert [b["batch"] for b in out["batches"]] == [2, 2, 1]
    assert [b["padded"] for b in out["batches"]] == [0, 0, 1]
    assert [t.shape for t in out["tokens"]] == [(2, 4), (2, 4), (1, 4)]
    assert all(((t >= 0) & (t < cfg.vocab_size)).all() for t in out["tokens"])


@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_aux_matches_reference(arch):
    """The train-mode forward's aux: the float32 sum of the MoE layers'
    load-balance losses over their count, with equal logits."""
    cfg_r, cfg_p, params_j, params_t = _params(arch, seed=5)
    prompt = _inputs(cfg_p, np.random.default_rng(5), 2, 12)
    lj, aux_j, _ = ref_forward(params_j, cfg_r, _j(prompt), mode="train")
    lt, aux_t, caches = forward(params_t, cfg_p, _t(prompt), mode="train")
    assert caches is None and aux_t.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    assert abs(float(aux_t) - float(aux_j)) <= 2e-5
    assert float(aux_t) > 0.5
    assert init_params(get_config(arch, smoke=True),
                       torch.Generator().manual_seed(0), CPU) is not None


def test_entry_points_run_on_the_card_or_raise():
    """No fallback: without ``device="cpu"`` the entry points ask for CUDA
    and raise on a host without it."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; chip_smoke.py drives the card")
    cfg = get_config("internlm2-1.8b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    params = init_params(cfg, None, CPU)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(cfg, params, requests=1, batch=1, prompt_len=4, new_tokens=1)
