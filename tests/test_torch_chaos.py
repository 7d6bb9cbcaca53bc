"""The port's hardened policy (``repro_torch.chaos.guard``) against the
reference's ``repro.chaos.guard``.

The guard is NumPy host code copied from the reference; every solve it
makes goes through the port's backend registry.  The bar is bitwise:
JSONL traces, decision records and ``cache_stats`` (the ``chaos_*``
ladder counters included) byte-equal to the reference's under each fault
storm, and the guard's helpers (backoff schedule, quarantine mask,
invariant monitor, safe pool, ICE caps) equal value for value.  The
ladder's ``"default"`` rung is the process backend, the card in the
port: an autouse fixture sets it to ``"torch:cpu"`` (the cover-DP
kernel's plain version) and restores it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.chaos as ref_chaos
import repro.chaos.guard as ref_guard
import repro.serve_sim as ref_serve
import repro.sim as ref_sim
import repro_torch.chaos as port_chaos
import repro_torch.chaos.guard as port_guard
import repro_torch.serve_sim as port_serve
import repro_torch.sim as port_sim
from repro.core.efficiency import NodePool as RefNodePool
from repro.core.efficiency import decision_metrics as ref_metrics
from repro.core.provisioner import ProvisioningDecision as RefDecision
from repro.core.provisioner import preprocess as ref_preprocess
from repro_torch.core import backend as backend_mod
from repro_torch.core import catalog_from_reference, items_from_reference
from repro_torch.core.efficiency import NodePool, decision_metrics
from repro_torch.core.provisioner import ProvisioningDecision
from repro_torch.sim import scenario_from_reference

from tests.strategies import mk_item

STORMS = ["feed", "ice", "solver", "combined"]


@pytest.fixture(autouse=True)
def port_on_host(monkeypatch):
    """The port's default backend is the card; these tests name the host."""
    monkeypatch.setenv("KUBEPACS_SERVE_PERF", "analytic")
    ref_serve.clear_caches()
    port_serve.clear_caches()
    saved = backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    yield
    backend_mod._DEFAULT = saved
    ref_serve.clear_caches()
    port_serve.clear_caches()


def chaos_scenario(storm="combined", policy="hardened", **overrides):
    """The reference test suite's compact 24 h / 3 h-step storm: the
    ``fault_storm`` presets at scale 0.5 land every window inside the
    horizon (``tests/test_chaos.py``)."""
    base = dict(name="chaos_test", duration_hours=24.0, step_hours=3.0,
                pods=60, cpu_per_pod=2, mem_per_pod=2,
                demand_schedule=((6.0, 110), (12.0, 70), (18.0, 115)),
                interrupt_model="pressure", policy=policy,
                catalog_seed=7, max_offerings=80, market_seed=7,
                interrupt_seed=7,
                faults=ref_chaos.fault_storm(storm, 0.5) if storm else ())
    base.update(overrides)
    return ref_sim.Scenario(**base)


def _decisions(result):
    return [(r, d.pool.as_dict(), d.alpha, d.metrics)
            for r, d in result.decisions]


def _run_both(ref_sc, **kw):
    ref_res = ref_sim.ClusterSim(ref_sc, clock=lambda: 0.0, **kw).run()
    port_res = port_sim.ClusterSim(scenario_from_reference(ref_sc),
                                   clock=lambda: 0.0, **kw).run()
    return ref_res, port_res


def _assert_runs_equal(ref_res, port_res):
    """Trace bytes, decisions, ladder counters and float totals."""
    assert port_res.recorder.dumps() == ref_res.recorder.dumps()
    assert _decisions(port_res) == _decisions(ref_res)
    assert port_res.decision_records() == ref_res.decision_records()
    assert port_res.cache_stats == ref_res.cache_stats
    assert port_res.total_cost == ref_res.total_cost
    assert port_res.total_perf_hours == ref_res.total_perf_hours


# ------------------------------------------------------ trace parity ----

@pytest.mark.parametrize("policy", ["hardened", "kubepacs"])
@pytest.mark.parametrize("storm", STORMS)
def test_storm_trace_matches_reference(storm, policy):
    ref_res, port_res = _run_both(chaos_scenario(storm, policy))
    _assert_runs_equal(ref_res, port_res)
    if policy == "hardened":
        assert any(k.startswith("chaos_") for k in port_res.cache_stats)
    faults = [r for r in port_res.records if r["type"] == "fault"]
    assert faults


def test_hardened_inert_without_faults():
    h_ref, h = _run_both(chaos_scenario(None, "hardened"))
    _, k = _run_both(chaos_scenario(None, "kubepacs"))
    _assert_runs_equal(h_ref, h)
    assert h.recorder.dumps().replace(
        '"policy": "hardened"', '"policy": "kubepacs"') \
        == k.recorder.dumps()
    assert not any(key.startswith("chaos_") for key in h.cache_stats)


def test_solver_fault_fails_naive_but_not_hardened():
    naive = port_sim.ClusterSim(
        scenario_from_reference(chaos_scenario("solver", "kubepacs")),
        clock=lambda: 0.0).run()
    failed = [d for _, d in naive.decisions
              if d is not None and d.metrics.get("decision_failed")]
    assert failed
    assert all(not port_guard.decision_available(d) for d in failed)
    hard = port_sim.ClusterSim(
        scenario_from_reference(chaos_scenario("solver", "hardened")),
        clock=lambda: 0.0).run()
    assert all(port_guard.decision_available(d) for _, d in hard.decisions)
    assert hard.cache_stats.get("chaos_solve_errors", 0) > 0
    # the numpy rung serves only what the injected faults push down to it
    assert hard.cache_stats.get("chaos_solver_rung_1", 0) > 0


@pytest.mark.parametrize("policy", ["hardened", "kubepacs"])
def test_replay_and_fleet_match_standalone_under_faults(policy):
    sc = scenario_from_reference(chaos_scenario(policy=policy))
    live = port_sim.ClusterSim(sc, clock=lambda: 0.0).run()
    rep = port_sim.ClusterSim.replay(live.records).run()
    assert rep.recorder.dumps() == live.recorder.dumps()
    seeds = [0, 1]
    ref_fleet = ref_sim.run_fleet(chaos_scenario(policy=policy), seeds,
                                  record_traces=True, clock=lambda: 0.0)
    fleet = port_sim.run_fleet(sc, seeds, record_traces=True,
                               clock=lambda: 0.0, backend="torch:fused:cpu")
    alone = port_sim.run_replicas(sc, seeds)
    for f, s, r in zip(fleet, alone, ref_fleet):
        assert f.recorder.dumps() == s.recorder.dumps() \
            == r.recorder.dumps()
        assert f.cache_stats.get("device_cache_fallback_solves", 0) == 0


# --------------------------------------------------------- the ladder ----

def _tainted_feed():
    """The feed storm's catalog and a controller observing a corrupt
    snapshot at t = 4.5 h (inside the corrupt window)."""
    sc = chaos_scenario("feed", "hardened")
    catalog = catalog_from_reference(sc.build_catalog())
    chaos = port_chaos.ChaosController(
        scenario_from_reference(sc).faults, catalog)
    spot = np.array([o.spot_price for o in catalog], dtype=np.float64)
    t3 = np.array([o.t3 for o in catalog])
    chaos.observe(0, 4.5, spot, t3)
    assert chaos.snapshot_tainted
    return sc, catalog, chaos


def test_rung_descends_to_equal_decision():
    """Every rung the port can name picks the pool the reference picks."""
    sc, catalog, chaos = _tainted_feed()
    ref_catalog = sc.build_catalog()
    ref_ctrl = ref_chaos.ChaosController(sc.faults, ref_catalog)
    ref_ctrl.observe(0, 4.5, np.array([o.spot_price for o in ref_catalog],
                                      dtype=np.float64),
                     np.array([o.t3 for o in ref_catalog]))
    ref_hp = ref_guard.HardenedPolicy(clock=lambda: 0.0, ladder=("numpy",))
    ref_hp.bind(ref_catalog)
    ref_hp.bind_chaos(ref_ctrl)
    want = ref_hp.provision(sc.request(), ref_catalog, 4.5)
    request = scenario_from_reference(sc).request()
    for ladder in (("default",), ("torch:cpu",), ("torch:fused:cpu",),
                   ("numpy",)):
        hp = port_guard.HardenedPolicy(clock=lambda: 0.0, ladder=ladder)
        hp.bind(catalog)
        hp.bind_chaos(chaos)
        d = hp.provision(request, catalog, 4.5)
        assert isinstance(d, ProvisioningDecision)
        assert d.metrics["chaos_rung"] == 0.0
        assert d.pool.as_dict() == want.pool.as_dict()
        assert d.metrics == want.metrics
        assert hp.counters == ref_hp.counters


@pytest.mark.parametrize("spec", ["jax:fused", "jax", "jax:fused:pallas"])
def test_reference_ladder_spec_raises(spec):
    """A ``jax*`` rung raises from the port's ``make_backend`` the first
    time the ladder reaches it, never falling through to ``numpy``."""
    _, catalog, chaos = _tainted_feed()
    hp = port_guard.HardenedPolicy(clock=lambda: 0.0,
                                   ladder=(spec, "numpy"))
    hp.bind(catalog)
    hp.bind_chaos(chaos)
    request = scenario_from_reference(chaos_scenario("feed")).request()
    with pytest.raises(ValueError, match="unknown solver backend spec"):
        hp.provision(request, catalog, 4.5)
    assert "solve_errors" not in hp.counters


def test_card_failure_raises_out_of_the_ladder(monkeypatch):
    """Without a card the default rung raises out of ``provision()``: a
    failed kernel is never counted as a solve error and served by
    ``numpy``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KUBEPACS_SOLVER_BACKEND", raising=False)
    backend_mod._DEFAULT = None
    sim = port_sim.ClusterSim(
        scenario_from_reference(chaos_scenario("solver", "hardened")),
        clock=lambda: 0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.run()
    assert port_guard.DEFAULT_LADDER == ("default", "numpy")


# ----------------------------------------------------------- helpers ----

def test_backoff_schedule_matches_reference():
    rng = np.random.default_rng(41)
    for _ in range(60):
        seed = int(rng.integers(0, 2 ** 32))
        now = float(rng.uniform(0.0, 1e5))
        attempts = int(rng.integers(1, 13))
        got = port_guard.backoff_schedule(seed, now, attempts)
        assert got == ref_guard.backoff_schedule(seed, now, attempts)
        assert got[0] == 0.0 and all(0.05 <= d <= 1.0 for d in got[1:])


def _corrupt_market():
    """A real catalog's items with NaN, floor, spike and T3 rows mixed in."""
    ref_sc = chaos_scenario(None)
    ref_items = ref_preprocess(ref_sc.build_catalog(), ref_sc.request())
    rng = np.random.default_rng(5)
    out = []
    for i, it in enumerate(ref_items):
        kind = rng.integers(0, 6)
        if kind == 0:
            it = dataclasses.replace(it, spot_price=float("nan"))
        elif kind == 1:
            it = dataclasses.replace(it, spot_price=it.offering.od_price
                                     * 0.01)
        elif kind == 2:
            it = dataclasses.replace(it, spot_price=it.offering.od_price
                                     * 3.0)
        elif kind == 3:
            it = dataclasses.replace(it, t3=60)
        out.append(it)
    return ref_sc, out


@pytest.mark.parametrize("rate", [0.0, 0.4])
def test_quarantine_check_and_safe_pool_match_reference(rate):
    ref_sc, ref_items = _corrupt_market()
    items = items_from_reference(ref_items)
    ref_cfg = ref_guard.GuardConfig(hazard_quarantine_rate=rate)
    cfg = port_guard.GuardConfig(hazard_quarantine_rate=rate)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    hazard = np.random.default_rng(3).uniform(0.0, 0.8, len(items))
    want = ref_guard.quarantine_mask(ref_items, ref_cfg, hazard=hazard)
    got = port_guard.quarantine_mask(items, cfg, hazard=hazard)
    assert got.tolist() == want.tolist() and got.any() and not got.all()
    request = scenario_from_reference(ref_sc).request()
    ref_pool = ref_guard.safe_pool(ref_items, want, ref_sc.request())
    pool = port_guard.safe_pool(items, got, request)
    assert pool.as_dict() == ref_pool.as_dict()
    assert pool.total_pods >= request.pods
    assert port_guard.check_decision(pool, request, cfg) \
        == ref_guard.check_decision(ref_pool, ref_sc.request(), ref_cfg) \
        is True
    # an unsanitized pool over the spiked and NaN rows fails the monitor
    bad = [i for i in range(len(items)) if got[i]][:3]
    for i in bad:
        ref_bad = RefNodePool(items=[ref_items[i]], counts=[1])
        port_bad = NodePool(items=[items[i]], counts=[1])
        assert port_guard.check_decision(port_bad, request, cfg) \
            == ref_guard.check_decision(ref_bad, ref_sc.request(), ref_cfg)
    assert port_guard.check_decision(None, request, cfg) is False


def test_ice_caps_and_fulfillment_match_reference():
    ref_items = [mk_item(0, pods=4, bs=1e4, sp=0.5, t3=5),
                 mk_item(1, pods=4, bs=1e4, sp=0.6, t3=2)]
    items = items_from_reference(ref_items)
    f = dict(kind="ice", time=0.0, duration=6.0, magnitude=0.7, seed=1)
    ref_hp = ref_guard.HardenedPolicy(clock=lambda: 0.0)
    hp = port_guard.HardenedPolicy(clock=lambda: 0.0)
    for pol, chaos, its in (
            (ref_hp, ref_chaos.ChaosController(
                (ref_chaos.Fault(**f),), [it.offering for it in ref_items]),
             ref_items),
            (hp, port_chaos.ChaosController(
                (port_chaos.Fault(**f),), [it.offering for it in items]),
             items)):
        pol.bind([it.offering for it in its])
        pol.bind_chaos(chaos)
    a, b = items[0].offering.offering_id, items[1].offering.offering_id
    req = {a: 10, b: 4, "c@az": 0}
    assert hp.chaos.ice_caps(6.0, req) == ref_hp.chaos.ice_caps(6.0, req)
    assert hp.chaos.ice_caps(3.0, req) == ref_hp.chaos.ice_caps(3.0, req)
    request = scenario_from_reference(chaos_scenario()).request()
    ref_request = chaos_scenario().request()
    for t, grants in ((1.0, {a: 3, b: 1}), (2.0, {a: 10, b: 0})):
        hp.observe_fulfillment(t, {a: 10, b: 4}, grants)
        ref_hp.observe_fulfillment(t, {a: 10, b: 4}, grants)
        assert hp._grant_ratio == ref_hp._grant_ratio
        assert hp.provisioner.cache.excluded(t) \
            == ref_hp.provisioner.cache.excluded(t)
        pool = NodePool(items=items, counts=[3, 1])
        ref_pool = RefNodePool(items=ref_items, counts=[3, 1])
        got = hp._inflate(request, ProvisioningDecision(
            pool=pool, trace=None, alpha=None, wall_seconds=0.0,
            excluded_offerings=set(), metrics=decision_metrics(pool, 40)))
        want = ref_hp._inflate(ref_request, RefDecision(
            pool=ref_pool, trace=None, alpha=None, wall_seconds=0.0,
            excluded_offerings=set(),
            metrics=ref_metrics(ref_pool, 40)))
        assert got.pool.as_dict() == want.pool.as_dict()
        assert got.metrics == want.metrics
    assert hp.counters == ref_hp.counters
    assert hp.counters["ice_market_wide"] == 1
    assert hp.counters["ice_excluded"] == 1
