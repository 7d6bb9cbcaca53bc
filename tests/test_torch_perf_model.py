"""ServeSim's roofline mode in the port (``repro_torch.serve_sim.perf_model``):
the statement of the reference's ``test_roofline_matches_analytic_ranking``
(roofline and analytic agree on everything scale-invariant — offering
ranking, SLO mask, relative latency — and differ in the absolute step
time), the ``"auto"`` resolution and its env pin, the step and table
caches, and a count that is the same in two processes.

The roofline mode counts a reduced decode cell on abstract tensors through
``make_sharded_decode`` on a 1x1 mesh; with no process group initialised it
starts a fake one of one rank for the count and destroys it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.core import generate_catalog
from repro_torch.serve_sim import perf_model as pm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANALYTIC = pm.ServingProfile(mode="analytic")
ROOFLINE = pm.ServingProfile(mode="roofline")


@pytest.fixture(autouse=True)
def fresh_caches():
    pm.clear_caches()
    yield
    pm.clear_caches()


def test_roofline_matches_analytic_ranking():
    offs = generate_catalog(seed=3, max_offerings=60)
    ana = pm.serving_table(ANALYTIC, offs)
    roof = pm.serving_table(ROOFLINE, offs)
    assert roof.mode == "roofline" and ana.mode == "analytic"
    assert roof.token_s_ref != ana.token_s_ref
    assert np.isfinite(roof.token_s_ref) and roof.token_s_ref > 0
    np.testing.assert_array_equal(np.argsort(-roof.qps_per_pod),
                                  np.argsort(-ana.qps_per_pod))
    np.testing.assert_array_equal(roof.slo_mask(pm.default_slo_ms(ROOFLINE)),
                                  ana.slo_mask(pm.default_slo_ms(ANALYTIC)))
    np.testing.assert_allclose(roof.request_ms / roof.token_s_ref,
                               ana.request_ms / ana.token_s_ref)
    assert not dist.is_initialized()       # the count's group is gone


def test_auto_resolves_to_roofline_and_the_env_pins_analytic(monkeypatch):
    monkeypatch.delenv(pm.ENV_MODE, raising=False)
    auto = pm.default_profile()
    assert auto.mode == "auto" and auto.resolved_mode() == "roofline"
    token_s, mode = pm.reference_token_s(auto)
    assert mode == "roofline"
    assert token_s == pm.reference_token_s(ROOFLINE)[0]
    monkeypatch.setenv(pm.ENV_MODE, "analytic")
    pinned = pm.default_profile()
    assert pinned.resolved_mode() == "analytic"
    assert pm.reference_token_s(pinned) == (pm.analytic_token_s(pinned),
                                            "analytic")
    # the cache keys carry the resolved mode: one entry per mode
    assert sorted(k[-1] for k in pm._STEP_CACHE) == ["analytic", "roofline"]
    with pytest.raises(ValueError, match="unknown perf-model mode"):
        pm.ServingProfile(mode="compiled")


def test_step_and_table_caches_hit_and_miss():
    offs = generate_catalog(seed=3, max_offerings=60)
    pm.serving_table(ROOFLINE, offs)
    assert pm.cache_stats() == {"step_hits": 0, "step_misses": 1,
                                "table_hits": 0, "table_misses": 1}
    pm.serving_table(ROOFLINE, offs)
    assert pm.cache_stats()["table_hits"] == 1
    pm.serving_table(ROOFLINE, offs[:30])           # new market, same step
    assert pm.cache_stats() == {"step_hits": 1, "step_misses": 1,
                                "table_hits": 1, "table_misses": 2}
    pm.reference_qps_per_pod(ROOFLINE)
    pm.default_slo_ms(ROOFLINE)
    assert pm.cache_stats()["step_hits"] == 3


def test_auto_degrades_with_a_warning_but_explicit_roofline_raises(
        monkeypatch):
    def broken(profile):
        raise RuntimeError("no count")
    monkeypatch.setattr(pm, "_roofline_token_s", broken)
    with pytest.raises(RuntimeError, match="no count"):
        pm.reference_token_s(ROOFLINE)
    with pytest.warns(UserWarning, match="falling back to analytic"):
        token_s, mode = pm.reference_token_s(pm.ServingProfile(mode="auto"))
    assert mode == "analytic" and token_s == pm.analytic_token_s(ANALYTIC)


def test_roofline_token_s_is_the_same_in_two_processes():
    """The count is deterministic: a fresh process gives the same
    ``token_s_ref`` to the last bit."""
    here = pm.reference_token_s(ROOFLINE)[0]
    code = ("import json; from repro_torch.serve_sim import perf_model as pm;"
            "print(json.dumps(pm.reference_token_s("
            "pm.ServingProfile(mode='roofline'))[0]))")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == here


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "qwen3-moe-30b-a3b",
                                  "musicgen-large"])
def test_roofline_mode_counts_other_archs(arch):
    """Mamba, MoE and audio-code decode cells count too (a finite,
    positive efficiency factor over the analytic bound)."""
    prof = pm.ServingProfile(arch=arch, mode="roofline")
    token_s, mode = pm.reference_token_s(prof)
    assert mode == "roofline" and np.isfinite(token_s) and token_s > 0
    assert token_s != pm.analytic_token_s(prof)
