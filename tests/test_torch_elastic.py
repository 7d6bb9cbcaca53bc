"""The port's checkpoints, elastic spot trainer and training launcher
(``repro_torch.train.checkpoint``, ``runtime.elastic``, ``launch.train``)
against the reference on the CPU.

A checkpoint holds the reference's trees (keys are its pytree paths, body
leaves stacked over periods), so each package restores what the other
wrote.  The trainer's event stream comes from the decision plane and the
scenario engine, not the model: the reference's trainer (its default
backend, ``numpy``) and the port's (``"torch:cpu"``, the cover-DP kernel's
plain version, set by an autouse fixture) must write byte-equal cluster
traces and equal event logs, and, from the same initial parameters, losses
within 1e-4 relative.  Models are smoke configs; the parity run is in
float32.  The reference runs with ``jax_enable_x64`` off (its regime for
training; see ``tests/test_torch_train.py``).
"""

import contextlib
import dataclasses
import io
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import Request as RefRequest
from repro.core import SpotMarketSimulator as RefMarket
from repro.core import backend as ref_backend_mod
from repro.core import generate_catalog as ref_catalog
from repro.launch import train as ref_launch
from repro.models import init_params as ref_init_params
from repro.runtime import ElasticConfig as RefElasticConfig
from repro.runtime import ElasticSpotTrainer as RefTrainer
from repro.train import checkpoint as ref_ckpt
from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.core import Request, SpotMarketSimulator, generate_catalog
from repro_torch.core import backend as backend_mod
from repro_torch.launch import train as port_launch
from repro_torch.models import init_params
from repro_torch.models.convert import (opt_state_from_reference,
                                        opt_state_to_reference,
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.runtime import ElasticConfig, ElasticSpotTrainer
from repro_torch.train import checkpoint as ckpt

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def backends_on_host():
    """The port's default backend is the card: name the host; pin the
    reference's to its default, ``numpy``, and x64 off."""
    saved = backend_mod._DEFAULT, ref_backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    ref_backend_mod.set_backend("numpy")
    with jax.enable_x64(False):
        yield
    backend_mod._DEFAULT, ref_backend_mod._DEFAULT = saved


def _leaves_with_path(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in flat}


def _assert_trees_equal(got, want):
    got, want = _leaves_with_path(got), _leaves_with_path(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ----------------------------------------------------------- checkpoint ----

def test_checkpoint_roundtrip_and_retention():
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), CPU)
    opt_state = optim.init_opt_state(params)
    with tempfile.TemporaryDirectory() as d:
        for step in (1, 2, 3, 4, 5):
            ckpt.save_checkpoint(d, step, params, opt_state, keep=2)
        assert ckpt.latest_step(d) == 5
        assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 2
        template = init_params(cfg, torch.Generator().manual_seed(1), CPU)
        p2, o2, meta = ckpt.restore_checkpoint(d, template, opt_state)
        assert meta["step"] == 5
        for (k, a), (k2, b) in zip(params.named_parameters(),
                                   p2.named_parameters()):
            assert k == k2 and b.device == CPU
            assert torch.equal(a, b)
        assert int(o2["step"]) == 0 and o2["m"].keys() == opt_state["m"].keys()
        assert not any(n.startswith(".tmp") for n in os.listdir(d))


def test_checkpoint_no_partial_publish():
    with tempfile.TemporaryDirectory() as d:
        assert ckpt.latest_step(d) is None
        with pytest.raises(FileNotFoundError):
            ckpt.restore_checkpoint(d, {})


def _ref_state(cfg_r, seed):
    """Reference parameters and an AdamW state with nonzero moments."""
    params = ref_init_params(cfg_r, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    moments = lambda: jax.tree.map(  # noqa: E731
        lambda p: jnp.asarray(rng.normal(size=p.shape), jnp.float32), params)
    return params, {"m": moments(), "v": moments(),
                    "step": jnp.asarray(5, jnp.int32)}


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-1.5-large-398b"])
def test_checkpoints_cross_packages(arch):
    """A checkpoint the reference wrote restores in the port equal to the
    converted trees, one the port wrote restores in the reference, and the
    two packages' files hold the same keys, shapes and dtypes (kimi: a
    prefix layer and a stacked body; jamba: an 8-layer period)."""
    cfg_r = ref_get_config(arch, smoke=True)
    cfg_p = get_config(arch, smoke=True)
    params_j, opt_j = _ref_state(cfg_r, seed=1)
    template = init_params(cfg_p, torch.Generator().manual_seed(9), CPU)
    with tempfile.TemporaryDirectory() as d_ref, \
            tempfile.TemporaryDirectory() as d_port:
        ref_ckpt.save_checkpoint(d_ref, 5, params_j, opt_j)
        p_t, o_t, meta = ckpt.restore_checkpoint(
            d_ref, template, optim.init_opt_state(template))
        assert meta["step"] == 5 and int(o_t["step"]) == 5
        _assert_trees_equal(params_to_reference(cfg_p, p_t), params_j)
        _assert_trees_equal(opt_state_to_reference(cfg_p, o_t), opt_j)

        params_p = params_from_reference(
            cfg_p, jax.tree.map(np.asarray, _ref_state(cfg_r, seed=2)[0]),
            CPU)
        opt_p = opt_state_from_reference(
            cfg_p, jax.tree.map(np.asarray, _ref_state(cfg_r, seed=3)[1]),
            CPU)
        ckpt.save_checkpoint(d_port, 5, params_p, opt_p)
        p_j, o_j, meta = ref_ckpt.restore_checkpoint(d_port, params_j, opt_j)
        assert meta["step"] == 5
        _assert_trees_equal(p_j, params_to_reference(cfg_p, params_p))
        _assert_trees_equal(o_j, opt_state_to_reference(cfg_p, opt_p))

        for name in ("params_0.npz", "opt_0.npz"):
            with np.load(os.path.join(d_ref, "step_00000005", name)) as a, \
                    np.load(os.path.join(d_port, "step_00000005", name)) as b:
                assert {k: (a[k].shape, a[k].dtype) for k in a.files} == \
                    {k: (b[k].shape, b[k].dtype) for k in b.files}
        with np.load(os.path.join(d_port, "step_00000005",
                                  "params_0.npz")) as z:
            assert "body/0/mixer_norm/scale" in z.files


# -------------------------------------------------------------- trainer ----

def test_elastic_trainer_survives_interrupts():
    cfg = get_config("internlm2-1.8b", smoke=True)
    market = SpotMarketSimulator(generate_catalog(seed=3, max_offerings=300),
                                 seed=3)
    req = Request(pods=40, cpu_per_pod=2, mem_per_pod=4)
    with tempfile.TemporaryDirectory() as d:
        tr = ElasticSpotTrainer(cfg, req, market, d, ElasticConfig(
            total_steps=24, ckpt_every=6, market_check_every=3,
            market_hours_per_check=8.0, batch_rows=4, seq_len=64),
            device="cpu")
        out = tr.run()
    assert out["steps"] == 24
    assert np.isfinite(out["losses"]).all()
    assert np.mean(out["losses"][-6:]) < np.mean(out["losses"][:6])
    assert out["interrupts_handled"] > 0
    # pool recovered to cover the request after every event
    assert tr.pool.total_pods >= req.pods
    assert out["recovery_times"] and max(out["recovery_times"]) < 30


def test_elastic_trainer_restart_resumes():
    cfg = get_config("internlm2-1.8b", smoke=True)
    req = Request(pods=20, cpu_per_pod=2, mem_per_pod=4)
    with tempfile.TemporaryDirectory() as d:
        market = SpotMarketSimulator(
            generate_catalog(seed=4, max_offerings=200), seed=4)
        tr1 = ElasticSpotTrainer(cfg, req, market, d, ElasticConfig(
            total_steps=10, ckpt_every=5, market_check_every=100,
            batch_rows=2, seq_len=32), device="cpu")
        tr1.run()
        # process "dies"; a fresh trainer on the same dir resumes at step 10
        tr2 = ElasticSpotTrainer(cfg, req, market, d, ElasticConfig(
            total_steps=14, ckpt_every=5, market_check_every=100,
            batch_rows=2, seq_len=32), device="cpu")
        out = tr2.run()
        assert any(e["event"] == "resume" and e["detail"]["from"] == 10
                   for e in out["events"])
        assert out["steps"] == 14


def _events(out):
    """The event log without its wall times."""
    return [{**e, "detail": {k: v for k, v in e["detail"].items()
                             if k not in ("wall_s", "recovery_s")}}
            for e in out["events"]]


#: chip_smoke.py phase 14's market, request and ElasticConfig (its
#: ``market_hours_per_check`` of 2 h fires interrupts at steps 3 and 12;
#: 8 h adds a straggler), with smoke-sized batches
MARKET_SEED = 7
ELASTIC = dict(total_steps=12, ckpt_every=12, market_check_every=3,
               batch_rows=2, seq_len=32, keep_checkpoints=1)


@pytest.mark.parametrize("hours,kinds", [
    (2.0, ["provision", "interrupt", "interrupt"]),
    (8.0, ["provision", "interrupt", "straggler", "interrupt", "interrupt"])])
def test_elastic_trainer_matches_reference(hours, kinds):
    """The same smoke config (float32), market and ``ElasticConfig``, the
    port's trainer started from the reference's initial parameters:
    byte-equal cluster traces, equal event logs (without wall times),
    losses within 1e-4 relative.  The events are the ones chip_smoke.py's
    phase 14 expects on the card (2 h), and at 8 h a straggler too."""
    arch = "internlm2-1.8b"
    cfg_r = dataclasses.replace(ref_get_config(arch, smoke=True),
                                dtype="float32")
    cfg_p = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    req = dict(pods=64, cpu_per_pod=4, mem_per_pod=8)
    with tempfile.TemporaryDirectory() as d_ref, \
            tempfile.TemporaryDirectory() as d_port:
        tr_r = RefTrainer(cfg_r, RefRequest(**req),
                          RefMarket(ref_catalog(seed=MARKET_SEED),
                                    seed=MARKET_SEED), d_ref,
                          RefElasticConfig(**ELASTIC,
                                           market_hours_per_check=hours))
        tr_p = ElasticSpotTrainer(
            cfg_p, Request(**req),
            SpotMarketSimulator(generate_catalog(seed=MARKET_SEED),
                                seed=MARKET_SEED), d_port,
            ElasticConfig(**ELASTIC, market_hours_per_check=hours),
            device="cpu")
        tr_p.params = params_from_reference(
            cfg_p, jax.tree.map(np.asarray, tr_r.params), CPU)
        tr_p.opt_state = optim.init_opt_state(tr_p.params)
        out_r, out_p = tr_r.run(), tr_p.run()
    assert tr_p.cluster.recorder.dumps() == tr_r.cluster.recorder.dumps()
    assert _events(out_p) == _events(out_r)
    assert [e["event"] for e in out_p["events"]] == kinds
    assert tr_p.pool.total_pods >= req["pods"]
    assert out_p["steps"] == out_r["steps"] == 12
    assert out_p["trace_records"] == out_r["trace_records"]
    np.testing.assert_allclose(out_p["losses"], out_r["losses"], rtol=1e-4)


def test_elastic_trainer_default_device_is_the_card():
    """``device=None`` means the card: without CUDA the trainer raises
    rather than running on the host."""
    cfg = get_config("internlm2-1.8b", smoke=True)
    market = SpotMarketSimulator(generate_catalog(seed=4, max_offerings=50),
                                 seed=4)
    req = Request(pods=4, cpu_per_pod=2, mem_per_pod=4)
    with tempfile.TemporaryDirectory() as d:
        if torch.cuda.is_available():
            tr = ElasticSpotTrainer(cfg, req, market, d)
            assert tr.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                ElasticSpotTrainer(cfg, req, market, d)


# ------------------------------------------------------------- launcher ----

def test_launcher_prints_the_reference_json():
    """``launch.train.main(..., "--device", "cpu")`` prints the reference's
    JSON keys, with the same steps and events handled."""
    outs = []
    for main, extra in ((ref_launch.main, []),
                        (port_launch.main, ["--device", "cpu"])):
        with tempfile.TemporaryDirectory() as d:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main(["--steps", "12", "--seq-len", "32", "--batch-rows", "2",
                      "--ckpt-dir", d] + extra)
            outs.append(json.loads(buf.getvalue()))
    want, got = outs
    assert got.keys() == want.keys()
    assert got["arch"] == want["arch"] and got["steps"] == want["steps"] == 12
    assert got["interrupts_handled"] == want["interrupts_handled"]
    assert np.isfinite([got["first_loss"], got["final_loss"]]).all()
