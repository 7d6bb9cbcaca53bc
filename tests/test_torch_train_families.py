"""The cuts that the card trains (``chip_smoke.py``, phase 18) held to the
reference's ``make_train_step`` on the CPU, at smoke width.

Phase 18 trains jamba-1.5-large's ``(layout[2], layout[4])`` (a Mamba +
MLP layer, then the attention + MLP layer; one MoE layer alone does not
fit one card at float32 with AdamW), kimi-k2's ``layout[:1]`` (the dense
prefix layer, as a one-layer body) and internvl2-1b with its vision
prefix; the same cuts are taken of the smoke configs here, each with the
``prefix_layers`` / ``scan_period`` that make the reference's stack
periodic.  Parameters come from the reference's ``init_params`` through
``params_from_reference``; batches from the (shared) ``make_batch``.

A VLM step is 256 vision positions + the text long on the card (1280 at
1024 tokens), a length the attention chunks (``attn_chunk_q`` 1024) do
not divide: the port's chunked attention takes a shorter last block,
where the reference asserts.  That path is held to the reference run in
one block.

Bars: loss and ``grad_norm`` within 1e-5 relative at each step,
parameters within 2e-5 after three steps (entries whose gradient is at
float noise excused and counted, as ``test_torch_train.py`` does),
attention outputs and gradients within 2e-5.  The reference runs with
``jax_enable_x64`` off, whatever an earlier test in the worker set.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.models import active_params as ref_active_params
from repro.models import count_params as ref_count_params
from repro.models import init_params as ref_init_params
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.data import pipeline
from repro_torch.kernels import ops
from repro_torch.models import active_params, count_params, loss_fn
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.train.loop import make_train_step

CPU = torch.device("cpu")

#: name -> (arch, the layout's layers taken, the stack's fields; None for
#: the whole stack): the cuts phase 18 trains at full width
CUTS = {
    "qwen3-moe-layout[:4]": ("qwen3-moe-30b-a3b", (0, 1, 2, 3),
                             {"prefix_layers": 0, "scan_period": 1}),
    "jamba-(layout[2],layout[4])": ("jamba-1.5-large-398b", (2, 4),
                                    {"prefix_layers": 0, "scan_period": 2}),
    "kimi-layout[:1]": ("kimi-k2-1t-a32b", (0,),
                        {"prefix_layers": 0, "scan_period": 1}),
    "stablelm-3b": ("stablelm-3b", None, {}),
    "qwen2.5-14b-layout[:6]": ("qwen2.5-14b", tuple(range(6)),
                               {"prefix_layers": 0, "scan_period": 1}),
    "internvl2-1b": ("internvl2-1b", None, {}),
    "musicgen-large": ("musicgen-large", None, {}),
}
#: full-width (parameters, active parameters) of the cuts: phase 18's table
FULL_COUNTS = {
    "qwen3-moe-layout[:4]": (3_114_813_440, 849_889_280),
    "jamba-(layout[2],layout[4])": (2_853_068_800, 2_853_068_800),
    "kimi-layout[:1]": (2_860_798_976, 2_860_798_976),
    "stablelm-3b": (2_795_443_200, 2_795_443_200),
    "qwen2.5-14b-layout[:6]": (3_208_752_128, 3_208_752_128),
    "internvl2-1b": (493_803_392, 493_803_392),
    "musicgen-large": (3_255_177_216, 3_255_177_216),
}
#: the cuts stepped against the reference here (the smoke configs' depth
#: holds only these three of the seven: qwen3-moe's smoke stack has two
#: layers, and the dense families are stepped in test_torch_train.py's
#: loss and gradient tests)
STEPPED = ["jamba-(layout[2],layout[4])", "kimi-layout[:1]", "internvl2-1b"]


@pytest.fixture(autouse=True)
def x64_off():
    """The reference's training regime (its learning rate's last bits
    follow ``jax_enable_x64``), whatever an earlier test set."""
    with jax.enable_x64(False):
        assert not jax.config.jax_enable_x64
        yield


def _cut(cfg, layers, stack, **kw):
    if layers is not None:
        kw.update(n_layers=len(layers),
                  layout=tuple(cfg.layout[i] for i in layers), **stack)
    return dataclasses.replace(cfg, **kw).validate()


def _configs(name, smoke=True, **kw):
    arch, layers, stack = CUTS[name]
    return (_cut(ref_get_config(arch, smoke=smoke), layers, stack, **kw),
            _cut(get_config(arch, smoke=smoke), layers, stack, **kw))


def _leaves_with_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in flat}


def _assert_close_rel(got, want, rtol):
    got, want = np.float64(got), np.float64(want)
    assert abs(got - want) <= rtol * max(abs(want), 1e-30), (got, want)


@pytest.mark.parametrize("name", sorted(FULL_COUNTS))
def test_train_cut_counts_match_reference(name):
    """Each cut's parameters and active parameters (what the card's share
    of the bf16 peak counts) equal the reference's at full width, where
    they are phase 18's table, and at smoke width where the smoke stack
    has the cut's layers."""
    arch, layers, _ = CUTS[name]
    deep = layers is None or max(layers) < get_config(arch, smoke=True
                                                      ).n_layers
    for smoke in (True, False)[not deep:]:
        cfg_r, cfg_p = _configs(name, smoke=smoke)
        assert count_params(cfg_p) == ref_count_params(cfg_r)
        assert active_params(cfg_p) == ref_active_params(cfg_r)
    cfg_p = _configs(name, smoke=False)[1]
    assert (count_params(cfg_p), active_params(cfg_p)) == FULL_COUNTS[name]


def _port_grads(model, cfg, batch):
    """``{path: gradient}`` of the port's loss on ``batch``."""
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    total, _ = loss_fn(model, cfg, {k: torch.from_numpy(np.asarray(v))
                                    for k, v in batch.items()})
    return dict(zip(named, torch.autograd.grad(total, list(named.values()))))


def _steps_match(cfg_r, cfg_p, seed, seq=32):
    """Three ``make_train_step`` steps of both packages from the
    reference's parameters on the same batches."""
    params_j = ref_init_params(cfg_r, jax.random.PRNGKey(seed))
    model = params_from_reference(cfg_p, jax.tree.map(np.asarray, params_j),
                                  CPU)
    ocfg = dict(lr=3e-3, warmup_steps=2, total_steps=100)
    step_r = ref_make_train_step(cfg_r, ref_optim.OptConfig(**ocfg),
                                 donate=False)
    step_p = make_train_step(cfg_p, optim.OptConfig(**ocfg))
    opt_r = ref_optim.init_opt_state(params_j)
    opt_p = optim.init_opt_state(model)
    vp = cfg_p.vision_prefix if cfg_p.input_mode == "vlm" else 0
    tiny = {}
    for s in range(3):
        batch = pipeline.make_batch(cfg_p, pipeline.DataConfig(seed=seed),
                                    step=s, batch=2, seq=vp + seq)
        # Adam divides by sqrt(v): an entry whose gradient is at float
        # noise can flip the sign of its update
        for k, g in _leaves_with_path(params_to_reference(
                cfg_p, _port_grads(model, cfg_p, batch))).items():
            small = np.abs(g) < 1e-6 * np.abs(g).max()
            tiny[k] = small | tiny.get(k, np.zeros_like(small))
        params_j, opt_r, m_r = step_r(
            params_j, opt_r, {k: jnp.asarray(v) for k, v in batch.items()})
        model, opt_p, m_p = step_p(model, opt_p, batch)
        for key in ("loss", "grad_norm", "total_loss"):
            _assert_close_rel(float(m_p[key]), float(m_r[key]), 1e-5)
    want = _leaves_with_path(params_j)
    got = _leaves_with_path(params_to_reference(cfg_p, model))
    assert want.keys() == got.keys()
    excused = total = 0
    for k in want:
        bad = np.abs(got[k] - want[k]) > 2e-5
        assert not np.any(bad & ~tiny[k]), k
        excused += int(np.sum(bad))
        total += want[k].size
    assert excused <= total // 1000, (excused, total)
    return m_p


@pytest.mark.parametrize("name", STEPPED)
def test_train_steps_match_reference(name):
    """float32: three steps of the cut, through the Mamba scan's and the
    attention's gradients (jamba's two layers in one step), the VLM loss
    mask over the vision prefix, and AdamW's decay by each leaf's rank in
    the reference's stacked tree (a two-layer body: its norms are
    stacked and decayed there)."""
    cfg_r, cfg_p = _configs(name, dtype="float32")
    m = _steps_match(cfg_r, cfg_p, seed=24)
    if cfg_p.input_mode == "vlm":
        assert float(m["tokens"]) == 2 * 32      # the prefix is masked


def test_vlm_train_steps_with_ragged_chunks_match_reference():
    """internvl2 with attention chunks of 16 over its 8 + 32 positions
    (the card's 1280 over chunks of 1024): the port's last block is 8
    long, the reference runs its default chunks (one block)."""
    cfg_r = dataclasses.replace(ref_get_config("internvl2-1b", smoke=True),
                                dtype="float32")
    cfg_p = dataclasses.replace(get_config("internvl2-1b", smoke=True),
                                dtype="float32", attn_chunk_q=16,
                                attn_chunk_kv=16)
    assert (cfg_p.vision_prefix + 32) % cfg_p.attn_chunk_q
    _steps_match(cfg_r, cfg_p, seed=25)


RAGGED = [
    # (B, S, H, KV, hd, causal, q_chunk, kv_chunk, causal_skip)
    (2, 40, 4, 2, 16, True, 16, 16, False),   # 16 + 16 + 8
    (1, 37, 7, 1, 8, True, 16, 12, False),    # GQA 7, unequal chunks
    (1, 20, 4, 1, 8, False, 8, 12, False),    # non-causal
    (2, 40, 4, 2, 16, True, 16, 16, True),    # the triangular schedule
    (2, 72, 4, 2, 16, True, 16, 16, False),   # train_4k's VLM row: 4 + 8
]


@pytest.mark.parametrize("case", RAGGED,
                         ids=["causal", "gqa7", "noncausal", "causal_skip",
                              "train_4k_vlm"])
def test_flash_attention_gradients_at_a_ragged_length(case):
    """``o`` and ``dq, dk, dv`` of ``Σ o·w`` through the port's
    ``FlashAttention`` (``flash_fwd_chunked`` / ``flash_bwd_chunked`` with
    a shorter last block) against ``jax.grad`` through the reference's
    chunked attention in one block, within 2e-5."""
    b, s, h, kv, hd, causal, qc, kc, skip = case
    assert s % qc or s % kc
    rng = np.random.default_rng(s + h)
    q, k, v, w = (rng.normal(size=sh).astype(np.float32)
                  for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd),
                             (b, s, h, hd)))

    def ref_loss(q, k, v):
        o = ref_ops.flash_attention(q, k, v, causal=causal, impl="chunked",
                                    q_chunk=s, kv_chunk=s)
        return jnp.sum(o * w), o

    (_, o_r), g_r = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                       has_aux=True)(q, k, v)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o_t = ops.flash_attention(qt, kt, vt, causal=causal, impl="chunked",
                              q_chunk=qc, kv_chunk=kc, causal_skip=skip)
    g_t = torch.autograd.grad((o_t * torch.from_numpy(w)).sum(),
                              (qt, kt, vt))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_r),
                               atol=2e-5)
    for got, want in zip(g_t, g_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
