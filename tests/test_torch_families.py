"""The depth cuts that the card serves (``chip_smoke.py``, phase 17) held to
the reference on the CPU, at smoke width.

jamba's and kimi-k2's full stacks do not fit one card, so the card runs
cuts of them: jamba ``layout[:5]`` (four Mamba layers, two with MoE, and
the attention layer at period position 4) and ``layout[3:5]`` (Mamba +
MoE, attention + MLP), kimi ``layout[:2]`` (the dense prefix layer and
one MoE layer) and ``layout[:1]``.  Each cut keeps the layout's layers
and sets ``scan_period`` / ``prefix_layers`` so that the reference's
stack is periodic (``ModelConfig.n_periods``); the same cuts are taken of
the smoke configs here.  The MoE cuts serve with bfloat16 parameters on
the card, so each is also held with ``param_dtype="bfloat16"`` in both
packages (float32 compute), its leaves carried across by
``params_from_reference``.  internvl2's prefill runs over the vision
prefix and the prompt; a length that is no multiple of 64 or of
``attn_chunk_q`` is held through prefill and decode.

Parameters come from the reference's ``init_params``; prompts and decode
tokens are drawn with numpy and handed to both.  On the CPU both packages
take their plain attention and scan (the chunked versions).  Tolerance:
logits within ``1e-4`` of the reference's (float32 compute).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import count_params as ref_count_params
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import prefill as ref_prefill
from repro_torch.configs import get_config
from repro_torch.models import count_params, decode_step, prefill
from repro_torch.models.convert import params_from_reference

CPU = torch.device("cpu")
TOL = 1e-4

#: name -> (arch, first layer, end, the stack's fields): the card's cuts
CUTS = {
    "jamba-layout[:5]": ("jamba-1.5-large-398b", 0, 5,
                         {"prefix_layers": 0, "scan_period": 5}),
    "jamba-layout[3:5]": ("jamba-1.5-large-398b", 3, 5,
                          {"prefix_layers": 0, "scan_period": 2}),
    "kimi-layout[:1]": ("kimi-k2-1t-a32b", 0, 1,
                        {"prefix_layers": 0, "scan_period": 1}),
    "kimi-layout[:2]": ("kimi-k2-1t-a32b", 0, 2,
                        {"prefix_layers": 1, "scan_period": 1}),
}
#: full-width parameter counts of the cuts (the card's table)
FULL_COUNTS = {"jamba-layout[:5]": 24_045_707_264,
               "jamba-layout[3:5]": 11_912_896_512,
               "kimi-layout[:1]": 2_860_798_976,
               "kimi-layout[:2]": 19_934_645_248}


def _cut(cfg, lo, hi, stack, **kw):
    return dataclasses.replace(cfg, n_layers=hi - lo,
                               layout=cfg.layout[lo:hi], **stack,
                               **kw).validate()


def _configs(name, smoke=True, **kw):
    arch, lo, hi, stack = CUTS[name]
    return (_cut(ref_get_config(arch, smoke=smoke), lo, hi, stack, **kw),
            _cut(get_config(arch, smoke=smoke), lo, hi, stack, **kw))


def _inputs(cfg, rng, B, S):
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.input_mode == "vlm":
        out["vision_embeds"] = rng.normal(
            size=(B, cfg.vision_prefix, cfg.d_model)).astype(np.float32)
    return out


def _hold(cfg_r, cfg_p, seed, S, steps=3, B=2):
    """Prefill ``S`` tokens (after the vision prefix, if any) and take
    ``steps`` decode steps in both packages on the same parameters and
    tokens; returns the port's parameters."""
    params_j = ref_init_params(cfg_r, jax.random.PRNGKey(seed))
    params_t = params_from_reference(
        cfg_p, jax.tree.map(np.asarray, params_j), CPU)
    rng = np.random.default_rng(seed)
    P = cfg_p.vision_prefix if cfg_p.input_mode == "vlm" else 0
    prompt = _inputs(cfg_p, rng, B, S)
    nexts = [{"tokens": rng.integers(0, cfg_p.vocab_size, (B, 1))}
             for _ in range(steps)]
    max_len = P + S + steps
    lj, cj = ref_prefill(params_j, cfg_r,
                         {k: jnp.asarray(v) for k, v in prompt.items()},
                         max_len=max_len)
    lt, ct = prefill(params_t, cfg_p,
                     {k: torch.from_numpy(v) for k, v in prompt.items()},
                     max_len=max_len)
    assert tuple(lt.shape) == lj.shape == (B, P + S, cfg_p.vocab_size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    for i, nb in enumerate(nexts):
        lj, cj = ref_decode_step(params_j, cfg_r, cj,
                                 {"tokens": jnp.asarray(nb["tokens"])},
                                 jnp.asarray(P + S + i))
        lt, ct = decode_step(params_t, cfg_p, ct,
                             {"tokens": torch.from_numpy(nb["tokens"])},
                             P + S + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=TOL)
    return params_t


@pytest.mark.parametrize("name", sorted(CUTS))
def test_cut_counts_match_reference(name):
    """Each cut's parameter count equals the reference's, at smoke width
    and at full width (where it is the card's table's)."""
    for smoke in (True, False):
        cfg_r, cfg_p = _configs(name, smoke=smoke)
        assert count_params(cfg_p) == ref_count_params(cfg_r)
    assert count_params(_configs(name, smoke=False)[1]) == FULL_COUNTS[name]


@pytest.mark.parametrize("name", sorted(CUTS))
def test_cut_prefill_and_decode_match_reference(name):
    """float32 parameters and compute: prefill + 3 decode steps, the mixed
    KV / SSM caches carried from step to step."""
    cfg_r, cfg_p = _configs(name, dtype="float32")
    params = _hold(cfg_r, cfg_p, seed=7, S=8)
    assert all(p.dtype == torch.float32 for p in params.parameters())


@pytest.mark.parametrize("name", sorted(CUTS))
def test_bf16_param_cut_matches_reference(name):
    """``param_dtype="bfloat16"`` in both packages, float32 compute: the
    reference's bfloat16 leaves carried across exactly, every port leaf
    bfloat16, logits within 1e-4 through prefill and decode."""
    cfg_r, cfg_p = _configs(name, dtype="float32", param_dtype="bfloat16")
    params = _hold(cfg_r, cfg_p, seed=11, S=8)
    assert all(p.dtype == torch.bfloat16 for p in params.parameters())


@pytest.mark.parametrize("S", [13, 37])
def test_vlm_prefix_with_a_ragged_length_matches_reference(S):
    """internvl2: the vision prefix (8 embeddings at smoke width) ahead of
    a prompt of ``S`` tokens, ``8 + S`` a multiple neither of 64 (the
    kernel's query tile) nor of ``attn_chunk_q``; decode positions start
    at ``8 + S``."""
    cfg_r = dataclasses.replace(ref_get_config("internvl2-1b", smoke=True),
                                dtype="float32")
    cfg_p = dataclasses.replace(get_config("internvl2-1b", smoke=True),
                                dtype="float32")
    P = cfg_p.vision_prefix
    assert (P + S) % 64 and (P + S) % cfg_p.attn_chunk_q
    _hold(cfg_r, cfg_p, seed=S, S=S)
