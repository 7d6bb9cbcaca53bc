"""The port's ``FleetSim`` against its own standalone runs and against the
reference's ``run_fleet``.

The fleet's contract (``repro_torch/sim/fleet.py``) is per-seed equality
with a standalone ``ClusterSim``: decisions, rounds, float totals bit for
bit, and with ``record_traces=True`` the JSONL trace byte for byte.  Here
it is held three ways for every replica: port fleet ≡ port standalone ≡
reference fleet.  The batched tick runs through ``"torch:cpu"`` (the
cover-DP kernel's plain version) and ``"torch:fused:cpu"`` (the fused row
solver's plain version, which must end with zero host-fallback solves);
the kernels themselves are held to those plain versions on the card by
``chip_smoke.py``.  Standalone runs solve inline through the port's
process default, which an autouse fixture sets to ``"torch:cpu"``.
"""

import dataclasses

import pytest
import torch

import repro.chaos as ref_chaos
import repro.region as ref_region
import repro.serve_sim as ref_serve
import repro.sim as ref_sim
import repro_torch.serve_sim as port_serve
import repro_torch.sim as port_sim
from repro.risk import backtest as ref_backtest
from repro_torch.core import backend as backend_mod
from repro_torch.risk import backtest as port_backtest
from repro_torch.sim import scenario_from_reference

SEEDS = [0, 1, 2]
BACKENDS = ["torch:cpu", "torch:fused:cpu"]
HOME = "us-east-1"

#: the fleet scenarios of ``benchmarks/bench_fleet.py``, cut to unit-test
#: size (fewer offerings, a shorter horizon; the storm keeps 36 h so its
#: 2 h-lead rebalance notices mature into reclaims)
SCENARIOS = {
    "hetero": lambda **kw: ref_sim.heterogeneous_demand_scenario(
        **{"duration_hours": 30.0, "max_offerings": 50, **kw}),
    "storm": lambda **kw: ref_backtest.interrupt_storm_scenario(
        **{"duration_hours": 36.0, "max_offerings": 60, **kw}),
    "crunch": lambda **kw: ref_backtest.pressure_crunch_scenario(
        **{"duration_hours": 24.0, "max_offerings": 60, **kw}),
}


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


def _standalone(sim_mod, scenario, seed, **kw):
    return sim_mod.ClusterSim(
        dataclasses.replace(scenario, interrupt_seed=int(seed)), **kw).run()


def _rounds(result):
    """Each round's fields, notices as trace records (the two packages'
    notice classes differ)."""
    return [(r.time, [n.to_record() for n in r.notices],
             [n.to_record() for n in r.effective], r.lost_nodes,
             r.lost_pods, r.shortfall, r.lost_perf, r.pool.as_dict())
            for r in result.rounds]


def _assert_result_equal(a, b):
    """Field-by-field SimResult equality — floats bit for bit."""
    assert a.total_cost == b.total_cost
    assert a.total_perf_hours == b.total_perf_hours
    assert a.total_egress == b.total_egress
    assert a.lost_perf_total == b.lost_perf_total
    assert a.interrupted_nodes == b.interrupted_nodes
    assert a.pool.as_dict() == b.pool.as_dict()
    assert _rounds(a) == _rounds(b)
    assert [(r, d.pool.as_dict(), d.alpha, d.metrics)
            for r, d in a.decisions] == \
           [(r, d.pool.as_dict(), d.alpha, d.metrics)
            for r, d in b.decisions]


def _fleet_counters(stats):
    """The counters both packages report (the port's fused backend adds
    ``device_cache_*``, which the reference's NumPy backend lacks)."""
    return {k: v for k, v in stats.items()
            if not k.startswith("device_cache_")}


@pytest.mark.parametrize("scenario_name,policy", [
    ("hetero", "kubepacs"), ("storm", "kubepacs"),
    ("storm", "kubepacs_risk:12"), ("crunch", "kubepacs_risk:12")])
@pytest.mark.parametrize("spec", BACKENDS)
def test_fleet_matches_standalone_and_reference(spec, scenario_name, policy):
    ref_sc = SCENARIOS[scenario_name](policy=policy)
    sc = scenario_from_reference(ref_sc)
    sim = port_sim.FleetSim(sc, SEEDS, record_traces=True, backend=spec)
    assert sim.solve_batch.backend.name == spec
    fleet = sim.run()
    ref_fleet = ref_sim.run_fleet(ref_sc, SEEDS, record_traces=True)
    assert len(fleet) == len(ref_fleet) == len(SEEDS)
    for seed, f, r in zip(SEEDS, fleet, ref_fleet):
        single = _standalone(port_sim, sc, seed)
        assert f.scenario.interrupt_seed == seed
        _assert_result_equal(f, single)
        _assert_result_equal(f, r)
        assert f.recorder.dumps() == single.recorder.dumps()
        assert f.recorder.dumps() == r.recorder.dumps()
        assert f.decision_records() == r.decision_records()
    stats = sim.stats()
    assert _fleet_counters(stats) == _fleet_counters(ref_fleet[0].cache_stats)
    if spec.startswith("torch:fused"):
        assert stats["device_cache_fallback_solves"] == 0
        # only the plain KubePACS policy batches its solves; the risk
        # policies solve inline through the process default
        assert (stats["device_cache_misses"] >= 1) == (policy == "kubepacs")


@pytest.mark.parametrize("spec", BACKENDS)
def test_fleet_batched_and_sequential_ticks_agree(spec):
    """Collect-then-solve changes no decision: batched-on ≡ batched-off."""
    sc = scenario_from_reference(SCENARIOS["hetero"]())
    on = port_sim.run_fleet(sc, SEEDS[:2], record_traces=True, backend=spec)
    off = port_sim.run_fleet(sc, SEEDS[:2], record_traces=True,
                             batch_decisions=False)
    for a, b in zip(on, off):
        assert a.recorder.dumps() == b.recorder.dumps()


def test_fleet_baseline_policies_match_reference():
    for policy in ("karpenter_like", "fixed_alpha:0.5"):
        ref_sc = SCENARIOS["storm"](policy=policy)
        fleet = port_sim.run_fleet(scenario_from_reference(ref_sc), SEEDS,
                                   record_traces=True, backend="torch:cpu")
        for f, r in zip(fleet, ref_sim.run_fleet(ref_sc, SEEDS,
                                                 record_traces=True)):
            _assert_result_equal(f, r)
            assert f.recorder.dumps() == r.recorder.dumps()


@pytest.mark.parametrize("spec", BACKENDS)
def test_run_fleet_paths_matches_reference(spec):
    """Correlated regional market paths (three regions, a hazard regime,
    egress) under the region storm, swept over two shock seeds."""
    ref_sc = ref_sim.Scenario(
        name="region_fleet", duration_hours=24.0, step_hours=3.0, pods=60,
        demand_schedule=((6.0, 110), (12.0, 70)),
        interrupt_model="pressure", policy="kubepacs",
        catalog_seed=7, max_offerings=80, market_seed=7, interrupt_seed=7,
        region=ref_region.RegionConfig(
            regions=(HOME, "us-west-2", "eu-west-1"), rho=0.7, vol=0.25,
            home_region=HOME, egress_per_pod_hour=0.002,
            hazard_scale=((HOME, 1.5),)),
        faults=ref_chaos.region_storm(HOME, 0.5))
    kw = dict(record_traces=True, clock=lambda: 0.0)
    paths = port_sim.run_fleet_paths(scenario_from_reference(ref_sc),
                                     [11, 23], [0, 1], backend=spec, **kw)
    ref_paths = ref_sim.run_fleet_paths(ref_sc, [11, 23], [0, 1], **kw)
    for path, ref_path in zip(paths, ref_paths):
        for f, r in zip(path, ref_path):
            _assert_result_equal(f, r)
            assert f.recorder.dumps() == r.recorder.dumps()
            assert f.total_egress > 0.0


def test_fleet_calibration_matches_reference():
    ref_sc = SCENARIOS["crunch"]()
    port_out = port_backtest.fleet_calibration(
        scenario_from_reference(ref_sc), SEEDS)
    assert port_out == ref_backtest.fleet_calibration(ref_sc, SEEDS)


def test_fleet_memo_collapses_identical_replicas():
    """On the bid-crossing storm every replica coincides: one unique solve
    per decision event, every other replica a memo hit."""
    sim = port_sim.FleetSim(scenario_from_reference(SCENARIOS["storm"]()),
                            list(range(6)), backend="torch:fused:cpu")
    sim.run()
    stats = sim.stats()
    assert stats["memo_unique_solves"] == stats["memo_misses"]
    assert stats["memo_hits"] == 5 * stats["memo_misses"]
    assert stats["device_cache_fallback_solves"] == 0


def test_fleet_without_backend_solves_on_the_card(monkeypatch):
    """``backend=None`` is the process default, the card: on a CUDA-less
    host construction succeeds and the first solve raises, never falls
    back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KUBEPACS_SOLVER_BACKEND", raising=False)
    backend_mod._DEFAULT = None
    sim = port_sim.FleetSim(scenario_from_reference(SCENARIOS["crunch"]()),
                            SEEDS)
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.run()
    for spec in ("torch", "torch:fused"):
        with pytest.raises(RuntimeError, match="CUDA"):
            port_sim.FleetSim(scenario_from_reference(SCENARIOS["crunch"]()),
                              SEEDS, backend=spec)


def test_fleet_rejects_reference_specs_and_fulfillment():
    sc = scenario_from_reference(SCENARIOS["storm"]())
    with pytest.raises(ValueError, match="jax:fused"):
        port_sim.FleetSim(sc, SEEDS, backend="jax:fused")
    with pytest.raises(ValueError, match="apply_fulfillment"):
        port_sim.FleetSim(dataclasses.replace(sc, apply_fulfillment=True),
                          SEEDS, backend="torch:cpu")
