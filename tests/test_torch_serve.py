"""The port's serving co-simulation (``repro_torch.serve_sim.sim``) against
the reference's ``repro.serve_sim.sim``.

``run_serving`` drives a ``ClusterSim`` whose policies solve inline through
the process backend, the card in the port: an autouse fixture sets it to
``"torch:cpu"`` (the cover-DP kernel's plain version).  Both packages pin
``KUBEPACS_SERVE_PERF=analytic`` (the reference's ``"auto"`` is its
roofline mode whenever jax imports, which the port does not have) and
clear both perf-model caches around each test.  The bar is bitwise:
``ServeReport.as_dict()``, the pool timelines and the provisioning traces
equal to the reference's.
"""

import dataclasses
import types

import numpy as np
import pytest

import repro.serve_sim as ref_serve
import repro.sim as ref_sim
import repro_torch.serve_sim as port_serve
import repro_torch.sim as port_sim
from repro.serve_sim.sim import PoolTimeline as RefTimeline
from repro.serve_sim.sim import ServeScenario as RefServeScenario
from repro_torch.core import backend as backend_mod
from repro_torch.core import catalog_from_reference
from repro_torch.serve_sim.sim import PoolTimeline, ServeScenario

#: the policies of ``benchmarks/bench_serve.py``
POLICIES = ["serving_slo", "karpenter_like", "kubepacs", "fixed_alpha:0.5",
            "kubepacs_risk"]


@pytest.fixture(autouse=True)
def port_on_host(monkeypatch):
    """The port's default backend is the card; these tests name the host,
    and pin the analytic perf model in both packages."""
    monkeypatch.setenv("KUBEPACS_SERVE_PERF", "analytic")
    ref_serve.clear_caches()
    port_serve.clear_caches()
    saved = backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    yield
    backend_mod._DEFAULT = saved
    ref_serve.clear_caches()
    port_serve.clear_caches()


def _scenarios(policy, **kw):
    return (ref_serve.build_serve_scenario("diurnal", policy=policy, **kw),
            port_serve.build_serve_scenario("diurnal", policy=policy, **kw))


def _assert_serve_scenarios_equal(ref_ss, ss):
    assert ss.scenario.to_dict() == ref_ss.scenario.to_dict()
    assert dataclasses.asdict(ss.workload) \
        == dataclasses.asdict(ref_ss.workload)
    assert dataclasses.asdict(ss.profile) == dataclasses.asdict(ref_ss.profile)
    assert (ss.slo_ms, ss.recovery_hours) \
        == (ref_ss.slo_ms, ref_ss.recovery_hours)


# ---------------------------------------------------- run_serving parity ----

@pytest.mark.parametrize("policy", POLICIES)
def test_run_serving_matches_reference(policy):
    """``bench_serve``'s five policies on the diurnal workload at 12 h:
    equal reports, pool timelines and provisioning traces."""
    ref_ss, ss = _scenarios(policy, duration_hours=12.0)
    _assert_serve_scenarios_equal(ref_ss, ss)
    want = ref_serve.run_serving(ref_ss, clock=lambda: 0.0)
    got = port_serve.run_serving(ss, clock=lambda: 0.0)
    assert got.as_dict() == want.as_dict()
    assert got.perf_mode == "analytic"
    ref_tl, tl = RefTimeline(), PoolTimeline()
    ref_res = ref_sim.ClusterSim(ref_ss.scenario, observers=[ref_tl],
                                 clock=lambda: 0.0).run()
    res = port_sim.ClusterSim(ss.scenario, observers=[tl],
                              clock=lambda: 0.0).run()
    assert res.recorder.dumps() == ref_res.recorder.dumps()
    assert tl.events == ref_tl.events and tl.events
    assert res.cache_stats == ref_res.cache_stats


def test_serving_slo_beats_karpenter_and_is_deterministic():
    """The reference suite's serving contracts, held on the port."""
    kw = dict(base_qps=400.0, duration_hours=8.0, max_offerings=120)
    a = port_serve.run_serving(
        port_serve.build_serve_scenario("diurnal", **kw), clock=lambda: 0.0)
    b = port_serve.run_serving(
        port_serve.build_serve_scenario("diurnal", **kw), clock=lambda: 0.0)
    assert a.as_dict() == b.as_dict()
    assert a.infeasible_decisions == 0
    karp = port_serve.run_serving(
        port_serve.build_serve_scenario("diurnal", policy="karpenter_like",
                                        **kw), clock=lambda: 0.0)
    assert a.slo_attainment >= karp.slo_attainment - 1e-9
    assert a.slo_qps_hours_per_dollar > karp.slo_qps_hours_per_dollar
    sc = port_serve.build_serve_scenario("diurnal", **kw).scenario
    res = port_sim.ClusterSim(sc, clock=lambda: 0.0).run()
    blob = res.recorder.dumps()
    rep = port_sim.ClusterSim.replay(port_sim.loads_trace(blob)).run()
    assert rep.recorder.dumps() == blob
    assert rep.decision_records() == res.decision_records()


# ------------------------------------------------- evaluate_serving ----

def _random_timeline(rng, oids, horizon):
    events, t = [], 0.0
    while t < horizon:
        k = int(rng.integers(1, 4))
        pick = rng.choice(len(oids), size=k, replace=False)
        alloc = tuple((oids[i], int(rng.integers(0, 5)),
                       int(rng.integers(1, 9))) for i in sorted(pick))
        events.append((t, "launch" if not events else "rebalance", alloc))
        t += float(rng.uniform(0.3, 3.0))
    return events


@pytest.mark.parametrize("recovery", [0.0, 0.25, 1.5])
def test_evaluate_serving_matches_reference(recovery):
    rng = np.random.default_rng(int(recovery * 100) + 9)
    ref_ss, ss = _scenarios("serving_slo", duration_hours=12.0,
                            recovery_hours=recovery)
    ref_cat = ref_ss.scenario.build_catalog()
    cat = catalog_from_reference(ref_cat)
    ref_table = ref_serve.serving_table(ref_ss.profile, ref_cat)
    table = port_serve.serving_table(ss.profile, cat)
    events = _random_timeline(rng, list(table.offering_ids), 12.0)
    result = types.SimpleNamespace(decisions=[], total_cost=37.5,
                                   interrupted_nodes=3)
    ref_tl, tl = RefTimeline(), PoolTimeline()
    ref_tl.events = list(events)
    tl.events = list(events)
    want = ref_serve.evaluate_serving(ref_ss, ref_table, ref_tl, result)
    got = port_serve.evaluate_serving(ss, table, tl, result)
    assert got.as_dict() == want.as_dict()
    assert got.served_qps_hours > 0
    assert (got.recovery_lost_qps_hours > 0) == (recovery > 0)


# ---------------------------------------------- recovery accounting ----

def _flat(mod, scenario_cls, recovery_hours):
    profile = mod.ServingProfile(mode="analytic")
    spec = mod.WorkloadSpec(kind="diurnal", base_qps=100.0, peak_factor=1.0,
                            noise=0.0, duration_hours=12.0)
    sim_mod = ref_sim if mod is ref_serve else port_sim
    scenario = sim_mod.serving_scenario("diurnal", base_qps=100.0,
                                        duration_hours=12.0,
                                        profile=profile)
    return profile, scenario_cls(workload=spec, scenario=scenario,
                                 profile=profile, slo_ms=1e9,
                                 recovery_hours=recovery_hours)


@pytest.mark.parametrize("recovery", [0.0, 0.5])
def test_recovery_accounting_and_initial_exemption(recovery):
    """Doubled capacity at t = 6 warms up for ``recovery`` hours; the
    initial provisioning at t = 0 is exempt (reference suite's
    hand-computed case), equal in both packages."""
    reports = []
    for mod, tl_cls, ss_cls in ((ref_serve, RefTimeline, RefServeScenario),
                                (port_serve, PoolTimeline, ServeScenario)):
        profile, ss = _flat(mod, ss_cls, recovery)
        offs = ref_sim.Scenario(name="x", max_offerings=8,
                                catalog_seed=3).build_catalog()
        if mod is port_serve:
            offs = catalog_from_reference(offs)
        table = mod.serving_table(profile, offs)
        oid = table.offering_ids[0]
        qps1 = 4 * float(table.qps_per_pod[table.index[oid]])
        result = types.SimpleNamespace(decisions=[], total_cost=10.0,
                                       interrupted_nodes=0)
        tl = tl_cls()
        tl.events = [(0.0, "launch", ((oid, 1, 4),)),
                     (6.0, "launch", ((oid, 2, 4),))]
        grown = mod.evaluate_serving(ss, table, tl, result)
        tl0 = tl_cls()
        tl0.events = [(0.0, "launch", ((oid, 2, 4),))]
        initial = mod.evaluate_serving(ss, table, tl0, result)
        reports.append((grown.as_dict(), initial.as_dict()))
        lam = 100.0
        exp_base = min(lam, qps1) * 6.0 + min(lam, 2 * qps1) * 6.0
        exp_lost = (min(lam, 2 * qps1) - min(lam, qps1)) * recovery
        assert np.isclose(grown.recovery_lost_qps_hours, exp_lost)
        assert np.isclose(grown.served_qps_hours, exp_base - exp_lost)
        assert np.isclose(grown.nominal_served_qps_hours, exp_base)
        assert initial.recovery_lost_qps_hours == 0.0
        assert initial.served_qps_hours \
            == initial.nominal_served_qps_hours > 0
    assert reports[0] == reports[1]


# --------------------------------------------------------- policy specs ----

@pytest.mark.parametrize("spec", ["serving_slo", "serving_slo:12",
                                  "serving_slo:0"])
def test_make_policy_serving_specs_match_reference(spec):
    got, want = port_sim.make_policy(spec), ref_sim.make_policy(spec)
    assert got.name == want.name and got.name.startswith("serving_slo")
    assert type(got).__name__ == type(want).__name__
    assert got.horizon == want.horizon
    with pytest.raises(ValueError):
        port_sim.make_policy("serving_slo:not_a_number")


def test_lazy_serving_names_resolve():
    from repro_torch.serve_sim import sim as port_sim_mod
    for name in ("DEFAULT_RECOVERY_HOURS", "PoolTimeline", "ServeReport",
                 "ServeScenario", "build_serve_scenario",
                 "evaluate_serving", "run_serving"):
        assert getattr(port_serve, name) is getattr(port_sim_mod, name)
    assert port_serve.DEFAULT_RECOVERY_HOURS \
        == ref_serve.DEFAULT_RECOVERY_HOURS
