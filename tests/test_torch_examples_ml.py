"""The port's model examples (``repro_torch.examples.serve_batched`` and
``.train_elastic_spot``) against the reference's ``examples/`` on the CPU.

``serve_batched``: the reference example runs through ``runpy`` with
``sys.argv`` patched and its smoke config in float32; the port's
``generate`` runs the same config on weights converted from the reference's
``PRNGKey(0)`` init (``models/convert.py``) and the example's prompt.  The
greedy continuations it prints must equal the reference's.

``train_elastic_spot``: ``model_100m`` is replaced in both packages by a
2-layer, d 64 float32 twin; the reference example (loaded as a module so
that its ``model_100m`` can be replaced) and the port's ``main`` train it
12 steps.  The event lines must be equal with the wall and recovery
seconds masked, and, the port's trainer starting from the reference's
initial weights, the losses within 1e-4 relative (as
``test_torch_elastic.py`` holds the trainer).  The port's solver backend
is ``"torch:cpu"``, the reference's ``numpy``; the reference runs with
``jax_enable_x64`` off.
"""

import dataclasses
import importlib.util
import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.configs.base import dense_layout as ref_dense_layout
from repro.core import backend as ref_backend_mod
from repro.models import init_params as ref_init_params
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.configs.base import dense_layout
from repro_torch.core import backend as backend_mod
from repro_torch.examples import serve_batched, train_elastic_spot
from repro_torch.models.convert import params_from_reference

CPU = torch.device("cpu")
EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")
SERVE_ARGS = dict(batch=2, prompt_len=8, new_tokens=4)
TRAIN_ARGV = ["--steps", "12", "--batch-rows", "1", "--seq-len", "16"]


@pytest.fixture(autouse=True)
def backends_on_host():
    saved = backend_mod._DEFAULT, ref_backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    ref_backend_mod.set_backend("numpy")
    with jax.enable_x64(False):
        yield
    backend_mod._DEFAULT, ref_backend_mod._DEFAULT = saved


def masked(text: str) -> str:
    """Walls (``0.22s``, ``'wall_s': 0.013``, ``'recovery_s': ...``, the
    recovery list), rates (``tok/s``) and the checkpoint directory masked."""
    text = re.sub(r"\d+\.\d\ds\b", "<s>", text)
    text = re.sub(r"\([\d.]+ tok/s", "(<rate> tok/s", text)
    text = re.sub(r"'(wall_s|recovery_s)': [^,}]+", r"'\1': <s>", text)
    text = re.sub(r"\(recovery: \[[^]]*\] s\)", "(recovery: <s>)", text)
    text = re.sub(r"loss [\d.]+ -> [\d.]+", "loss <losses>", text)
    return re.sub(r"checkpoints: .*", "checkpoints: <dir>", text)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b"])
def test_serve_batched_continuations_match_reference(arch, capsys,
                                                     monkeypatch):
    f32 = lambda cfg: dataclasses.replace(cfg, dtype="float32")  # noqa: E731
    ref_get = ref_configs.get_config
    monkeypatch.setattr(ref_configs, "get_config",
                        lambda name, smoke=False: f32(ref_get(name, smoke)))
    path = os.path.join(EXAMPLES, "serve_batched.py")
    monkeypatch.setattr(sys, "argv", [
        path, "--arch", arch, "--batch", "2", "--prompt-len", "8",
        "--new-tokens", "4"])
    capsys.readouterr()
    runpy.run_path(path, run_name="__main__")
    want = capsys.readouterr().out

    cfg_r = f32(ref_get(arch, smoke=True))
    cfg = f32(get_config(arch, smoke=True))
    params = params_from_reference(
        cfg, jax.tree.map(np.asarray,
                          ref_init_params(cfg_r, jax.random.PRNGKey(0))), CPU)
    prompt = serve_batched.make_prompt(cfg, SERVE_ARGS["batch"],
                                       SERVE_ARGS["prompt_len"], CPU)
    toks = serve_batched.generate(cfg, params, prompt,
                                  SERVE_ARGS["new_tokens"])
    got = capsys.readouterr().out
    assert toks.shape == (2, 4)
    assert "sampled continuations (greedy):" in got
    assert masked(got) == masked(want)


def test_serve_batched_main_runs_on_the_cpu_when_asked(capsys):
    """``main`` with ``--device cpu``: the reference's line structure and
    continuations of ids in the vocabulary; ``None`` is the card."""
    toks = serve_batched.main(["--arch", "internvl2-1b", "--batch", "2",
                               "--prompt-len", "8", "--new-tokens", "3",
                               "--device", "cpu"])
    cfg = get_config("internvl2-1b", smoke=True)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("note: internvl2-1b is vlm")
    assert lines[1].startswith(
        f"prefill: batch=2 len={8 + cfg.vision_prefix} in ")
    assert lines[-2] == f"  seq0: {toks[0].tolist()}"
    assert toks.shape == (2, 3) and toks.min() >= 0
    assert toks.max() < cfg.vocab_size
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve_batched.main([])


def _twin(cfg, layout):
    """``model_100m``'s 2-layer, d 64 float32 twin (GQA 4/2, d_ff 128)."""
    return dataclasses.replace(cfg, n_layers=2, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, layout=layout(2),
                               dtype="float32").validate()


def test_train_elastic_spot_matches_reference(capsys, monkeypatch,
                                              tmp_path):
    spec = importlib.util.spec_from_file_location(
        "reference_train_elastic_spot",
        os.path.join(EXAMPLES, "train_elastic_spot.py"))
    ref_example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_example)
    runs = {}

    class RefTrainer(ref_example.ElasticSpotTrainer):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs["init"] = jax.tree.map(np.asarray, self.params)
            runs["ref"] = self

        def run(self, *args, **kw):
            runs["ref_out"] = super().run(*args, **kw)
            return runs["ref_out"]

    class PortTrainer(train_elastic_spot.ElasticSpotTrainer):
        def __init__(self, cfg, *args, **kw):
            super().__init__(cfg, *args, **kw)
            self.params = params_from_reference(cfg, runs["init"],
                                                self.device)
            self.opt_state = optim.init_opt_state(self.params)
            runs["port"] = self

    for module, trainer, layout in (
            (ref_example, RefTrainer, ref_dense_layout),
            (train_elastic_spot, PortTrainer, dense_layout)):
        model_100m = module.model_100m
        monkeypatch.setattr(module, "model_100m",
                            lambda f=model_100m, lay=layout: _twin(f(), lay))
        monkeypatch.setattr(module, "ElasticSpotTrainer", trainer)

    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [
        "train_elastic_spot.py", *TRAIN_ARGV,
        "--ckpt-dir", str(tmp_path / "ref")])
    ref_example.main()
    want = capsys.readouterr().out
    out = train_elastic_spot.main([*TRAIN_ARGV, "--ckpt-dir",
                                   str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out

    assert masked(got) == masked(want)
    assert "\ntrained 12 steps; " in got and "  step    0  provision" in got
    tr_r, tr_p = runs["ref"], runs["port"]
    assert tr_p.cluster.recorder.dumps() == tr_r.cluster.recorder.dumps()
    assert tr_p.pool.total_pods >= 64
    assert out["steps"] == 12 and len(out["losses"]) == 12
    np.testing.assert_allclose(out["losses"], runs["ref_out"]["losses"],
                               rtol=1e-4)
