"""The port's simulation layer (``repro_torch.sim`` and the host modules it
loads: chaos, region, risk, serve_sim) against the reference.

Every module here is NumPy host code copied from ``src/repro/``; the parity
bar is the reference's own determinism contract: JSONL traces byte-equal,
floats bit for bit.  ``ClusterSim``'s policies solve inline through the
process-default backend, which in the port is the card: an autouse fixture
sets it to ``"torch:cpu"`` (the cover-DP kernel's plain version) and
restores it.  Serving runs pin ``KUBEPACS_SERVE_PERF=analytic`` in both
packages (the reference's ``"auto"`` is its roofline mode whenever jax
imports) and clear both perf-model caches around each test.
"""

import ast
import dataclasses
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.chaos as ref_chaos
import repro.core as ref_core
import repro.region as ref_region
import repro.risk as ref_risk
import repro.serve_sim as ref_serve
import repro.sim as ref_sim
import repro_torch.chaos as port_chaos
import repro_torch.core as port_core
import repro_torch.region as port_region
import repro_torch.risk as port_risk
import repro_torch.serve_sim as port_serve
import repro_torch.sim as port_sim
from repro.core import (CandidateItem, Offering, Request, generate_catalog,
                        preprocess)
from repro.core.gss import bracketed_gss as ref_gss
from repro.risk import backtest as ref_backtest
from repro_torch.core import backend as backend_mod
from repro_torch.core import (catalog_from_reference, items_from_reference,
                              make_backend)
from repro_torch.risk import backtest as port_backtest
from repro_torch.sim import scenario_from_reference

HOME = "us-east-1"
REGIONS = ("us-east-1", "us-west-2", "eu-west-1")

#: the three standard stress scenarios, cut to unit-test size (the storm
#: keeps 36 h so its 2 h-lead rebalance notices mature into reclaims)
_SMALL = dict(duration_hours=24.0, max_offerings=60)
SCENARIOS = {
    "storm": lambda **kw: ref_backtest.interrupt_storm_scenario(
        **{**_SMALL, "duration_hours": 36.0, **kw}),
    "price_shock": lambda **kw: ref_backtest.price_shock_scenario(
        **{**_SMALL, **kw}),
    "crunch": lambda **kw: ref_backtest.pressure_crunch_scenario(
        **{**_SMALL, **kw}),
}
POLICIES = ["kubepacs", "kubepacs_risk:12", "karpenter_like",
            "fixed_alpha:0.5"]


@pytest.fixture(autouse=True)
def port_on_host(monkeypatch):
    """The port's default backend is the card; these tests name the host
    explicitly, and pin the analytic perf model in both packages."""
    monkeypatch.setenv("KUBEPACS_SERVE_PERF", "analytic")
    ref_serve.clear_caches()
    port_serve.clear_caches()
    saved = backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    yield
    backend_mod._DEFAULT = saved
    ref_serve.clear_caches()
    port_serve.clear_caches()


def region_scenario(policy="kubepacs", *, storm=False, **overrides):
    """A compact 24 h / 3 h-step three-region scenario (the reference's
    ``tests/test_region.py`` shape)."""
    base = dict(
        name="region_test", duration_hours=24.0, step_hours=3.0, pods=60,
        demand_schedule=((6.0, 110), (12.0, 70)),
        interrupt_model="pressure", policy=policy,
        catalog_seed=7, max_offerings=80, market_seed=7, interrupt_seed=7,
        region=ref_region.RegionConfig(
            regions=REGIONS, rho=0.7, vol=0.25, shock_seed=11,
            home_region=HOME, egress_per_pod_hour=0.002,
            hazard_scale=((HOME, 1.5),)),
        faults=ref_chaos.region_storm(HOME, 0.5) if storm else ())
    base.update(overrides)
    return ref_sim.Scenario(**base)


def feed_storm_scenario(**overrides):
    """The chaos plane's ``feed`` storm (corrupt prices, an outage, a NaN
    burst) over a 48 h / 3 h-step run, under the plain KubePACS policy."""
    base = dict(
        name="feed_storm", duration_hours=48.0, step_hours=3.0, pods=60,
        interrupt_model="pressure", policy="kubepacs",
        catalog_seed=5, max_offerings=60, market_seed=5, interrupt_seed=5,
        faults=ref_chaos.fault_storm("feed"))
    base.update(overrides)
    return ref_sim.Scenario(**base)


def _decisions(result):
    return [(r, d.pool.as_dict(), d.alpha, d.metrics)
            for r, d in result.decisions]


def _assert_runs_equal(ref_res, port_res):
    """Trace bytes, decisions and float totals: bit for bit."""
    assert port_res.recorder.dumps() == ref_res.recorder.dumps()
    assert _decisions(port_res) == _decisions(ref_res)
    assert port_res.total_cost == ref_res.total_cost
    assert port_res.total_perf_hours == ref_res.total_perf_hours
    assert port_res.total_egress == ref_res.total_egress
    assert port_res.interrupted_nodes == ref_res.interrupted_nodes


# ------------------------------------------------------ spec round trips ----

@pytest.mark.parametrize("make", [
    lambda: SCENARIOS["storm"](),
    lambda: region_scenario(storm=True),
    lambda: feed_storm_scenario(),
    lambda: ref_sim.heterogeneous_demand_scenario(max_offerings=60),
    lambda: ref_sim.serving_scenario("bursty"),
], ids=["storm", "region_storm", "feed_storm", "hetero", "serving"])
def test_scenario_round_trips_through_to_dict(make):
    ref_sc = make()
    port_sc = scenario_from_reference(ref_sc)
    assert port_sc.to_dict() == ref_sc.to_dict()
    assert port_sim.Scenario.from_dict(port_sc.to_dict()) == port_sc
    assert [dataclasses.asdict(f) for f in port_sc.faults] == \
           [dataclasses.asdict(f) for f in ref_sc.faults]
    if ref_sc.region is not None:
        cfg = port_region.RegionConfig.from_dict(ref_sc.region.to_dict())
        assert cfg == port_sc.region and cfg.to_dict() == \
            ref_sc.region.to_dict()
    for f in ref_sc.faults:
        assert port_chaos.Fault(**dataclasses.asdict(f)) in port_sc.faults
    # the port builds the same catalog from the spec
    port_cat, ref_cat = port_sc.build_catalog(), ref_sc.build_catalog()
    assert [dataclasses.asdict(o) for o in port_cat] == \
           [dataclasses.asdict(o) for o in ref_cat]
    assert port_sim.events.catalog_digest(port_cat) == \
        ref_sim.events.catalog_digest(ref_cat)


# ------------------------------------------------------- chaos transforms ----

def _states(n_states, catalog, seed):
    rng = np.random.default_rng(seed)
    spot0 = np.array([o.spot_price for o in catalog])
    t30 = np.array([o.t3 for o in catalog], dtype=np.int64)
    for _ in range(n_states):
        yield (spot0 * rng.uniform(0.7, 1.4, len(catalog)),
               np.maximum(t30 + rng.integers(-3, 4, len(catalog)), 0))


@pytest.mark.parametrize("storm", ["feed", "combined", "region"])
def test_chaos_controller_feed_transforms(storm):
    faults = (ref_chaos.region_storm(HOME) if storm == "region"
              else ref_chaos.fault_storm(storm))
    catalog = generate_catalog(seed=3, max_offerings=80)
    ref_c = ref_chaos.ChaosController(faults, catalog)
    port_c = port_chaos.ChaosController(
        [port_chaos.Fault(**dataclasses.asdict(f)) for f in faults],
        catalog_from_reference(catalog))
    assert port_c.has_region_faults == ref_c.has_region_faults
    for idx, (spot, t3) in enumerate(_states(17, catalog, 9)):
        t = 3.0 * idx
        rs, rt, rtr = ref_c.observe(idx, t, spot, t3)
        ps, pt, ptr = port_c.observe(idx, t, spot, t3)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pt, rt)
        assert ps.dtype == rs.dtype and pt.dtype == rt.dtype
        assert ptr == rtr
        assert (port_c.stale_age, port_c.snapshot_tainted) == \
               (ref_c.stale_age, ref_c.snapshot_tainted)
        requested = {o.offering_id: 3 + k % 5
                     for k, o in enumerate(catalog)}
        assert port_c.ice_caps(t, requested) == ref_c.ice_caps(t, requested)
        assert port_c.region_fault_regions(t) == \
            ref_c.region_fault_regions(t)
        assert (port_c.solver_faulted(t) is None) == \
               (ref_c.solver_faulted(t) is None)
        assert [port_c.attempt_outcome(t, a) for a in range(3)] == \
               [ref_c.attempt_outcome(t, a) for a in range(3)]
        assert port_c.attempt_cost_s(t) == ref_c.attempt_cost_s(t)


# ----------------------------------------------- region market helpers ----

def test_region_overlay_hazard_rows_and_egress():
    ref_cfg = region_scenario(storm=True).region
    port_cfg = port_region.RegionConfig.from_dict(ref_cfg.to_dict())
    catalog = generate_catalog(seed=7, max_offerings=80)
    pcat = catalog_from_reference(catalog)
    faults = ref_chaos.region_storm(HOME, 0.5)
    pfaults = [port_chaos.Fault(**dataclasses.asdict(f)) for f in faults]
    ref_ov = ref_region.make_overlay(ref_cfg, catalog, faults)
    port_ov = port_region.make_overlay(port_cfg, pcat, pfaults)
    assert port_region.make_overlay(None, pcat, ()) is None
    for idx, (spot, t3) in enumerate(_states(9, catalog, 4)):
        rs, rt = ref_ov.apply(spot, t3, 3.0 * idx)
        ps, pt = port_ov.apply(spot, t3, 3.0 * idx)
        np.testing.assert_array_equal(ps, rs)
        np.testing.assert_array_equal(pt, rt)
        assert port_region.regional_price_factors(
            port_cfg, port_ov.regions, 3.0 * idx) == \
            ref_region.regional_price_factors(ref_cfg, ref_ov.regions,
                                              3.0 * idx)
    np.testing.assert_array_equal(
        port_region.hazard_scale_rows(port_cfg, pcat),
        ref_region.hazard_scale_rows(ref_cfg, catalog))
    p = np.linspace(0.0, 0.5, 11)
    np.testing.assert_array_equal(
        port_region.apply_hazard_scale(p, np.full(11, 1.5)),
        ref_region.apply_hazard_scale(p, np.full(11, 1.5)))
    items = preprocess(catalog, Request(pods=60, cpu_per_pod=2,
                                        mem_per_pod=2))
    pitems = items_from_reference(items)
    np.testing.assert_array_equal(
        port_region.egress_row_costs(port_cfg, pitems),
        ref_region.egress_row_costs(ref_cfg, items))
    assert port_region.egress_row_costs(port_region.RegionConfig(),
                                        pitems) is None


def _ritem(i, region, sp, pods=4, bs=1e4, t3=10):
    o = Offering(offering_id=f"t{i}@{region}", instance_type=f"t{i}",
                 family="m", generation=6, vendor="i",
                 specialization="general", size="large", region=region,
                 az=f"{region}a", vcpus=2, mem_gib=8.0, od_price=sp * 3,
                 spot_price=sp, bs_core=bs, sps_single=3, t3=t3,
                 interruption_freq=1)
    return CandidateItem(offering=o, pods=pods, bs=bs, spot_price=sp, t3=t3)


def _region_items():
    return [_ritem(r * 4 + j, region, sp=0.5 + 0.1 * r + 0.01 * j)
            for r, region in enumerate(REGIONS) for j in range(4)]


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(regions=REGIONS, home_region=HOME, caps=((HOME, 2),)),
    dict(regions=REGIONS, min_spread=3),
    dict(regions=REGIONS, home_region=HOME, egress_per_pod_hour=0.1),
], ids=["inert", "caps", "min_spread", "egress"])
def test_solve_with_regions_matches_reference(cfg):
    items = _region_items()
    ref_cfg = ref_region.RegionConfig(**cfg)
    port_cfg = port_region.RegionConfig(**cfg)
    rp, rtr, rinfo = ref_region.solve_with_regions(
        items, 40, ref_cfg, timer=lambda: 0.0)
    pp, ptr, pinfo = port_region.solve_with_regions(
        items_from_reference(items), 40, port_cfg, timer=lambda: 0.0,
        backend=make_backend("torch:cpu"))
    assert pp.as_dict() == rp.as_dict()
    assert pp.alpha == rp.alpha
    assert pinfo == rinfo
    assert dataclasses.asdict(ptr) == dataclasses.asdict(rtr)
    assert port_region.region_pool_shares(pp) == \
        ref_region.region_pool_shares(rp)


# -------------------------------------------------------------- risk ----

def test_risk_estimators_objective_and_survival():
    sc = SCENARIOS["storm"]()
    records = ref_sim.ClusterSim(sc).run().records
    catalog = sc.build_catalog()
    ref_est = ref_risk.replay_observations(
        ref_risk.RiskEstimators(catalog), records)
    port_est = port_risk.replay_observations(
        port_risk.RiskEstimators(catalog_from_reference(catalog)), records)
    for name in ("hazard", "drift", "shortfall"):
        np.testing.assert_array_equal(getattr(port_est, name)(),
                                      getattr(ref_est, name)())
    assert port_est.digest() == ref_est.digest()
    items = preprocess(catalog, sc.request())
    pitems = items_from_reference(items)
    ref_adj = ref_risk.risk_adjustment(items, ref_est, 12.0)
    port_adj = port_risk.risk_adjustment(pitems, port_est, 12.0)
    for f in ("perf", "price", "hazard"):
        np.testing.assert_array_equal(getattr(port_adj, f),
                                      getattr(ref_adj, f))
    ref_items, ref_mkt = ref_risk.reweight_candidates(
        items, ref_adj, market=ref_core.compile_market(items))
    port_items, port_mkt = port_risk.reweight_candidates(
        pitems, port_adj, market=port_core.compile_market(pitems))
    assert [dataclasses.asdict(it) for it in port_items] == \
           [dataclasses.asdict(it) for it in ref_items]
    assert port_mkt.digest == ref_mkt.digest
    pool, _ = ref_gss(items, sc.pods, 0.01)
    port_pool = port_core.NodePool(items=items_from_reference(pool.items),
                                   counts=list(pool.counts))
    assert port_risk.e_risk(port_pool, sc.pods, port_items) == \
        ref_risk.e_risk(pool, sc.pods, ref_items)
    h = ref_est.hazard()
    for fn in ("expected_uptime_fraction", "interrupt_probability"):
        np.testing.assert_array_equal(getattr(port_risk, fn)(h, 12.0),
                                      getattr(ref_risk, fn)(h, 12.0))
    counts = np.arange(len(h)) % 3
    np.testing.assert_array_equal(
        port_risk.expected_interrupted_nodes(h, counts, 6.0),
        ref_risk.expected_interrupted_nodes(h, counts, 6.0))


# ----------------------------------------------------------- serve_sim ----

@pytest.mark.parametrize("kind", ["diurnal", "bursty", "flash"])
def test_serving_table_and_demand_schedule(kind):
    ref_prof = ref_serve.default_profile()
    port_prof = port_serve.default_profile()
    assert ref_prof.mode == port_prof.mode == "analytic"
    assert port_prof.digest == ref_prof.digest
    assert port_serve.analytic_token_s(port_prof) == \
        ref_serve.analytic_token_s(ref_prof)
    assert port_serve.reference_token_s(port_prof) == \
        ref_serve.reference_token_s(ref_prof)
    assert port_serve.default_slo_ms(port_prof) == \
        ref_serve.default_slo_ms(ref_prof)
    catalog = generate_catalog(seed=11, max_offerings=80)
    rt = ref_serve.serving_table(ref_prof, catalog)
    pt = port_serve.serving_table(port_prof, catalog_from_reference(catalog))
    assert (pt.mode, pt.token_s_ref, pt.offering_ids) == \
           (rt.mode, rt.token_s_ref, rt.offering_ids)
    for f in ("speed", "qps_per_pod", "request_ms"):
        np.testing.assert_array_equal(getattr(pt, f), getattr(rt, f))
    slo = ref_serve.default_slo_ms(ref_prof)
    assert port_serve.default_slo_ms(port_prof) == slo
    np.testing.assert_array_equal(pt.slo_mask(slo), rt.slo_mask(slo))
    spec = dict(kind=kind, base_qps=800.0, seed=5, duration_hours=24.0,
                step_hours=1.0)
    ref_spec = ref_serve.WorkloadSpec(**spec)
    port_spec = port_serve.WorkloadSpec(**spec)
    assert port_serve.trace_digest(port_spec) == \
        ref_serve.trace_digest(ref_spec)
    qps = ref_serve.reference_qps_per_pod(ref_prof)
    assert port_serve.reference_qps_per_pod(port_prof) == qps
    assert port_serve.demand_schedule_from_trace(port_spec, qps) == \
        ref_serve.demand_schedule_from_trace(ref_spec, qps)
    assert port_serve.cache_stats() == ref_serve.cache_stats()


def test_perf_model_modes(monkeypatch):
    """``auto`` is the roofline model in the port, as in the reference
    whenever jax imports; the env pin gives the analytic model, whose
    carried constants are the reference's."""
    monkeypatch.delenv("KUBEPACS_SERVE_PERF")
    prof = port_serve.default_profile()
    assert prof.mode == "auto" and prof.resolved_mode() == "roofline"
    assert port_serve.reference_token_s(prof)[1] == "roofline"
    assert port_serve.reference_token_s(port_serve.ServingProfile(
        mode="roofline"))[1] == "roofline"
    monkeypatch.setenv("KUBEPACS_SERVE_PERF", "analytic")
    assert port_serve.default_profile().resolved_mode() == "analytic"
    from repro.roofline import HBM_BW, PEAK_FLOPS
    from repro_torch.serve_sim import perf_model
    assert (perf_model.PEAK_FLOPS, perf_model.HBM_BW) == (PEAK_FLOPS,
                                                          HBM_BW)


# --------------------------------------------------- ClusterSim parity ----

@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("scenario_name", sorted(SCENARIOS))
def test_cluster_sim_trace_matches_reference(scenario_name, policy):
    ref_sc = SCENARIOS[scenario_name](policy=policy)
    ref_res = ref_sim.ClusterSim(ref_sc).run()
    port_res = port_sim.ClusterSim(scenario_from_reference(ref_sc)).run()
    assert len(port_res.rounds) == len(ref_res.rounds) > 0
    _assert_runs_equal(ref_res, port_res)


@pytest.mark.parametrize("make", [
    lambda: ref_sim.serving_scenario("diurnal", duration_hours=24.0,
                                     max_offerings=80),
    lambda: region_scenario("kubepacs"),
    lambda: feed_storm_scenario(),
], ids=["serving_slo_diurnal", "region_kubepacs", "feed_fault_storm"])
def test_cluster_sim_scenario_families_match_reference(make):
    ref_sc = make()
    ref_res = ref_sim.ClusterSim(ref_sc, clock=lambda: 0.0).run()
    port_res = port_sim.ClusterSim(scenario_from_reference(ref_sc),
                                   clock=lambda: 0.0).run()
    _assert_runs_equal(ref_res, port_res)
    assert any(d.pool.total_pods > 0 for _, d in port_res.decisions)


def test_replay_source_replays_port_trace_byte_exactly():
    sc = scenario_from_reference(SCENARIOS["storm"](policy="kubepacs_risk"))
    live = port_sim.ClusterSim(sc).run()
    text = live.recorder.dumps()
    replayed = port_sim.ClusterSim.replay(port_sim.loads_trace(text))
    assert isinstance(replayed.source, port_sim.ReplaySource)
    rep = replayed.run()
    assert rep.recorder.dumps() == text
    assert rep.decision_records() == live.decision_records()
    assert rep.total_cost == live.total_cost


def test_run_replicas_matches_reference():
    ref_sc = SCENARIOS["crunch"]()
    ref_runs = ref_sim.run_replicas(ref_sc, [0, 1])
    port_runs = port_sim.run_replicas(scenario_from_reference(ref_sc),
                                      [0, 1])
    for r, p in zip(ref_runs, port_runs):
        _assert_runs_equal(r, p)


def test_backtest_compare_policies_matches_reference():
    ref_sc = SCENARIOS["price_shock"]()
    kw = dict(seeds=[0, 1], policies=("kubepacs", "kubepacs_risk:12"))
    ref_out = ref_backtest.compare_policies(ref_sc, **kw)
    port_out = port_backtest.compare_policies(scenario_from_reference(ref_sc),
                                              **kw)
    assert port_out == ref_out


# ------------------------------------------ the lazily imported layers ----

@pytest.mark.parametrize("spec,module", [
    ("hardened", "repro_torch.chaos.guard"),
    ("kubepacs_region", "repro_torch.region.policy"),
    ("region_pinned:us-east-1", "repro_torch.region.policy"),
])
def test_make_policy_builds_the_ported_policies(spec, module):
    """The lazy specs resolve to the port's class of the reference's name,
    built with the same knobs."""
    ref_cfg = region_scenario().region
    want = ref_sim.make_policy(spec, tolerance=0.02, ttl_hours=3.0,
                               region=ref_cfg)
    got = port_sim.make_policy(spec, tolerance=0.02, ttl_hours=3.0,
                               region=scenario_from_reference(
                                   region_scenario()).region)
    assert type(got).__module__ == module
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name


@pytest.mark.parametrize("package,ref_package,name", [
    (port_chaos, ref_chaos, "HardenedPolicy"),
    (port_region, ref_region, "RegionAwarePolicy"),
    (port_serve, ref_serve, "run_serving")])
def test_lazy_package_symbols_resolve_to_the_port(package, ref_package,
                                                  name):
    got, want = getattr(package, name), getattr(ref_package, name)
    assert got.__module__.startswith(package.__name__ + ".")
    assert got.__name__ == want.__name__
    assert got.__module__.split(".")[-1] == want.__module__.split(".")[-1]


def _code(path: str) -> str:
    """The module's code: its AST without docstrings (comments never
    reach it)."""
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["sim/policy.py", "chaos/__init__.py",
                                    "region/__init__.py",
                                    "serve_sim/__init__.py"])
def test_lazy_import_sites_are_the_reference_code(module):
    """The modules that cut the import cycles do so with the reference's
    in-function imports: their code equals the reference's."""
    import repro
    import repro_torch
    assert (_code(os.path.join(repro_torch.__path__[0], module))
            == _code(os.path.join(repro.__path__[0], module)))


def test_lazy_helper_module_is_gone():
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module("repro_torch._lazy")


def test_sim_packages_import_without_jax_or_reference():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import repro_torch.sim, repro_torch.risk, repro_torch.region\n"
            "import repro_torch.chaos, repro_torch.serve_sim\n"
            "import repro_torch.risk.backtest, repro_torch.sim.convert\n"
            "import repro_torch.chaos.guard, repro_torch.region.policy\n"
            "import repro_torch.serve_sim.sim, repro_torch.models.moe\n"
            "assert repro_torch.chaos.HardenedPolicy\n"
            "assert repro_torch.serve_sim.run_serving\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_cluster_sim_default_backend_is_the_card(monkeypatch):
    """Without a backend the port's solves go to the card: on a CUDA-less
    host the run raises at its first solve, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("KUBEPACS_SOLVER_BACKEND", raising=False)
    backend_mod._DEFAULT = None           # resolved at the first solve
    sim = port_sim.ClusterSim(scenario_from_reference(SCENARIOS["crunch"]()))
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.run()
