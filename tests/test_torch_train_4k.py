"""The train_4k geometry that ``chip_smoke.py`` phase 23 trains on the
card, held to the reference's ``train_step_fn`` on the CPU at smoke width.

At the reference's train_4k shape (``SHAPES["train_4k"]``: S 4,096) a row
spans 4 attention query blocks of ``attn_chunk_q`` 1,024 and 16 scan
chunks of ``mamba_chunk`` 256; internvl2's 256 vision positions make its
row 4,352 long, four full blocks and a ragged one of 256.  Here the same
geometry is cut small: 64 tokens with ``attn_chunk_q`` / ``attn_chunk_kv``
16 and ``mamba_chunk`` 4 (internvl2's smoke prefix of 8 makes its last
block 8 long).  One ``make_train_step`` step of the smoke configs of
internlm2-1.8b, falcon-mamba-7b, jamba-1.5-large (the cut phase 23c
trains: ``(layout[2], layout[4])``, a Mamba + MLP and the attention + MLP
layer) and internvl2-1b, in float32, against the reference's step on the
same numpy-seeded batch and the same parameters (the port's seeded
``init_params``, converted to the reference's tree).  The reference takes the same chunks where
they divide the row and runs internvl2's ragged row in one block (its
chunked attention asserts there).  Its four steps run once a module, with
``jax_enable_x64`` off (its learning rate's last bits follow the flag).

Bars (``test_torch_train.py::test_train_step_matches_reference``'s): loss,
``grad_norm`` and ``total_loss`` within 1e-5 relative, the learning rate
within 1e-6, the updated parameters within 2e-5 (entries whose gradient
is below 1e-6 of their leaf's largest excused and counted, at most 1 in
1,000).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.train.loop import make_train_step as ref_make_train_step
from repro_torch import optim
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import pipeline
from repro_torch.models import init_params
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.train.loop import make_train_step

CPU = torch.device("cpu")
#: tokens a row, and the chunks that cut it as train_4k's 4,096 are cut
SEQ = 64
CHUNKS = dict(attn_chunk_q=16, attn_chunk_kv=16, mamba_chunk=4)
#: arch -> the layout's layers taken and the stack's fields (None: whole)
ARCHS = {
    "internlm2-1.8b": None,
    "falcon-mamba-7b": None,
    "jamba-1.5-large-398b": ((2, 4), {"prefix_layers": 0,
                                      "scan_period": 2}),
    "internvl2-1b": None,
}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=100)


def _cut(cfg, cut, **kw):
    if cut is not None:
        layers, stack = cut
        kw.update(n_layers=len(layers),
                  layout=tuple(cfg.layout[i] for i in layers), **stack)
    return dataclasses.replace(cfg, dtype="float32", **kw).validate()


def _configs(arch):
    """Both packages' configs: the port's at the cut chunks, the
    reference's at them too unless its chunked attention would assert."""
    cfg_p = _cut(get_config(arch, smoke=True), ARCHS[arch], **CHUNKS)
    vp = cfg_p.vision_prefix if cfg_p.input_mode == "vlm" else 0
    ragged = (vp + SEQ) % cfg_p.attn_chunk_q != 0
    cfg_r = _cut(ref_get_config(arch, smoke=True), ARCHS[arch],
                 **({"mamba_chunk": CHUNKS["mamba_chunk"]} if ragged
                    else CHUNKS))
    return cfg_r, cfg_p, vp + SEQ


def _leaves_with_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in flat}


def _close_rel(got, want, rtol):
    got, want = np.float64(got), np.float64(want)
    return abs(got - want) <= rtol * max(abs(want), 1e-30)


@pytest.fixture(scope="module")
def reference():
    """arch -> (the reference's parameters before its step, the batch, its
    parameters after, its metrics): one step of each arch, once a
    module."""
    out = {}
    with jax.enable_x64(False):
        for i, arch in enumerate(ARCHS):
            cfg_r, cfg_p, seq = _configs(arch)
            params = jax.tree.map(np.asarray, params_to_reference(
                cfg_p, init_params(cfg_p, torch.Generator().manual_seed(
                    40 + i), CPU)))
            # the reference's zero moments, made on the host
            opt = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                               jax.eval_shape(ref_optim.init_opt_state,
                                              params))
            batch = pipeline.make_batch(cfg_p, pipeline.DataConfig(seed=i),
                                        step=0, batch=2, seq=seq)
            step = ref_make_train_step(cfg_r, ref_optim.OptConfig(**OPT),
                                       donate=False)
            after, _, metrics = step(
                params, opt, {k: jnp.asarray(v) for k, v in batch.items()})
            out[arch] = (params, batch, _leaves_with_path(after),
                         {k: float(v) for k, v in metrics.items()})
    return out


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_4k_geometry(arch):
    """A row of each config spans 4 attention query blocks (internvl2 a
    fifth, ragged one as long as its prefix) and 16 scan chunks, as a
    4,096-token row does at full size."""
    cfg_p = _configs(arch)[1]
    full = get_config(arch)
    seq = SHAPES["train_4k"].seq_len
    kinds = {spec.mixer for spec in cfg_p.layout}
    vp = cfg_p.vision_prefix if cfg_p.input_mode == "vlm" else 0
    vp_full = full.vision_prefix if full.input_mode == "vlm" else 0
    if "attn" in kinds:
        assert (SEQ // cfg_p.attn_chunk_q == seq // full.attn_chunk_q == 4)
        assert (vp + SEQ) % cfg_p.attn_chunk_q == vp
        assert (vp_full + seq) % full.attn_chunk_q == vp_full
    if "mamba" in kinds:
        assert SEQ // cfg_p.mamba_chunk == seq // full.mamba_chunk == 16


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_4k_step_matches_reference(arch, reference):
    """One step at the cut geometry: the chunked attention's 4 query
    blocks (and internvl2's ragged fifth) forward and in
    ``flash_bwd_chunked``, the scan's 16 chunks forward and in
    ``scan_backward``'s reverse recompute, the loss over the vision prefix
    mask and AdamW, against the reference's step."""
    cfg_p = _configs(arch)[1]
    params, batch, want, m_r = reference[arch]
    model = params_from_reference(cfg_p, params, CPU)
    step = make_train_step(cfg_p, optim.OptConfig(**OPT))
    model, opt, m_p = step(model, optim.init_opt_state(model), batch)
    # after one step from zero moments, m is the gradient times one factor
    tiny = {k: np.abs(m) < 1e-6 * np.abs(m).max()
            for k, m in _leaves_with_path(params_to_reference(
                cfg_p, opt["m"])).items()}
    for key in ("loss", "grad_norm", "total_loss"):
        assert _close_rel(float(m_p[key]), m_r[key], 1e-5), (key, m_p, m_r)
    assert _close_rel(float(m_p["lr"]), m_r["lr"], 1e-6)
    if cfg_p.input_mode == "vlm":
        assert float(m_p["tokens"]) == 2 * SEQ       # the prefix is masked
    got = _leaves_with_path(params_to_reference(cfg_p, model))
    assert want.keys() == got.keys()
    excused = total = 0
    for k in want:
        bad = np.abs(got[k] - want[k]) > 2e-5
        assert not np.any(bad & ~tiny[k]), k
        excused += int(np.sum(bad))
        total += want[k].size
    assert excused <= total // 1000, (excused, total)

