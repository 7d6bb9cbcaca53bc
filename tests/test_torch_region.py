"""The port's region-aware policies (``repro_torch.region.policy``) and the
hardened policy's regional failover rung against the reference.

``RegionPinnedPolicy`` and ``RegionAwarePolicy`` are NumPy host code
copied from ``src/repro/region/policy.py``; they solve inline through
``bracketed_gss`` / ``solve_with_regions`` and so through the process
backend, the card in the port: an autouse fixture sets it to
``"torch:cpu"`` (the cover-DP kernel's plain version).  The bar is
bitwise: traces, decision records and ``cache_stats`` (the
``chaos_region*`` counters included) byte-equal to the reference's, plus
the reference suite's inertness and failover contracts
(``tests/test_region.py``) held on the port.
"""

import dataclasses
import json

import numpy as np
import pytest

import repro.chaos as ref_chaos
import repro.region as ref_region
import repro.serve_sim as ref_serve
import repro.sim as ref_sim
import repro_torch.chaos.guard as port_guard
import repro_torch.region as port_region
import repro_torch.serve_sim as port_serve
import repro_torch.sim as port_sim
from repro.core import CandidateItem, Offering
from repro_torch.core import backend as backend_mod
from repro_torch.core import catalog_from_reference, items_from_reference
from repro_torch.sim import scenario_from_reference

HOME = "us-east-1"
REGIONS = ("us-east-1", "us-west-2", "eu-west-1")
POLICIES = ["hardened", f"region_pinned:{HOME}", "kubepacs_region"]


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


def region_scenario(policy="hardened", *, storm=True, shock_seed=11,
                    **overrides):
    """The reference suite's compact 24 h / 3 h-step regional storm
    (``bench_region``'s shape scaled down)."""
    base = dict(
        name="region_test", duration_hours=24.0, step_hours=3.0, pods=60,
        demand_schedule=((6.0, 110), (12.0, 70)),
        interrupt_model="pressure", policy=policy,
        catalog_seed=7, max_offerings=80, market_seed=7, interrupt_seed=7,
        region=ref_region.RegionConfig(
            regions=REGIONS, rho=0.7, vol=0.25, shock_seed=shock_seed,
            home_region=HOME, egress_per_pod_hour=0.002),
        faults=ref_chaos.region_storm(HOME, 0.5) if storm else ())
    base.update(overrides)
    return ref_sim.Scenario(**base)


def strip_region_header(trace: str) -> str:
    """The trace with its header's declared region/name/policy cleared."""
    lines = trace.splitlines()
    head = json.loads(lines[0])
    head["scenario"]["region"] = None
    head["scenario"]["name"] = ""
    head["scenario"]["policy"] = ""
    lines[0] = json.dumps(head, sort_keys=True)
    return "\n".join(lines)


def _decisions(result):
    return [(r, d.pool.as_dict(), d.alpha, d.metrics)
            for r, d in result.decisions]


def _run_both(ref_sc, ref_catalog=None):
    """One scenario through both packages; ``ref_catalog`` (reference
    offerings) is carried across for the port."""
    kw = {} if ref_catalog is None else {"catalog": ref_catalog}
    ref_res = ref_sim.ClusterSim(ref_sc, clock=lambda: 0.0, **kw).run()
    if ref_catalog is not None:
        kw = {"catalog": catalog_from_reference(ref_catalog)}
    port_res = port_sim.ClusterSim(scenario_from_reference(ref_sc),
                                   clock=lambda: 0.0, **kw).run()
    return ref_res, port_res


def _assert_runs_equal(ref_res, port_res):
    assert port_res.recorder.dumps() == ref_res.recorder.dumps()
    assert _decisions(port_res) == _decisions(ref_res)
    assert port_res.decision_records() == ref_res.decision_records()
    assert port_res.cache_stats == ref_res.cache_stats
    assert port_res.total_cost == ref_res.total_cost
    assert port_res.total_egress == ref_res.total_egress
    assert port_res.total_perf_hours == ref_res.total_perf_hours


# ------------------------------------------------------ trace parity ----

@pytest.mark.parametrize("storm", [True, False], ids=["storm", "clean"])
@pytest.mark.parametrize("policy", POLICIES)
def test_region_trace_matches_reference(policy, storm):
    ref_res, port_res = _run_both(region_scenario(policy, storm=storm))
    _assert_runs_equal(ref_res, port_res)
    if policy == "hardened":
        assert all(port_guard.decision_available(d)
                   for _, d in port_res.decisions)


def test_region_shock_paths_and_fleet_match_reference():
    """``run_fleet_paths`` over two shock seeds: the port's fleet (its
    batched tick through ``torch:fused:cpu``) equals its standalone runs
    and the reference's fleet, replica for replica."""
    ref_sc = region_scenario("kubepacs_region")
    sc = scenario_from_reference(ref_sc)
    ref_paths = ref_sim.run_fleet_paths(ref_sc, [11, 23], [3, 7],
                                        record_traces=True,
                                        clock=lambda: 0.0)
    paths = port_sim.run_fleet_paths(sc, [11, 23], [3, 7],
                                     record_traces=True, clock=lambda: 0.0,
                                     backend="torch:fused:cpu")
    for shock, ref_runs, runs in zip([11, 23], ref_paths, paths):
        alone = port_sim.run_replicas(dataclasses.replace(
            sc, region=dataclasses.replace(sc.region, shock_seed=shock)),
            [3, 7])
        for r, f, s in zip(ref_runs, runs, alone):
            assert f.recorder.dumps() == s.recorder.dumps() \
                == r.recorder.dumps()
            assert f.total_egress == s.total_egress == r.total_egress
    assert paths[0][0].recorder.dumps() != paths[1][0].recorder.dumps()


# ----------------------------------------------------------- inertness ----

def test_single_region_scenario_is_byte_inert():
    plain = region_scenario("kubepacs", storm=False, region=None,
                            name="plain")
    k1 = dataclasses.replace(plain,
                             region=ref_region.RegionConfig(regions=(HOME,)))
    cat = k1.build_catalog()
    ref_k1, rk1 = _run_both(k1)
    ref_pl, rpl = _run_both(plain, ref_catalog=cat)
    _assert_runs_equal(ref_k1, rk1)
    _assert_runs_equal(ref_pl, rpl)
    assert strip_region_header(rk1.recorder.dumps()) \
        == strip_region_header(rpl.recorder.dumps())
    assert rk1.total_egress == 0.0


def test_identity_region_config_is_byte_inert():
    bare = region_scenario("hardened", storm=False, region=None)
    ident = dataclasses.replace(
        bare, region=ref_region.RegionConfig(regions=REGIONS,
                                             hazard_scale=((HOME, 1.0),)))
    cat = ident.build_catalog()
    ref_id, rid = _run_both(ident)
    ref_bare, rbare = _run_both(bare, ref_catalog=cat)
    _assert_runs_equal(ref_id, rid)
    _assert_runs_equal(ref_bare, rbare)
    assert strip_region_header(rid.recorder.dumps()) \
        == strip_region_header(rbare.recorder.dumps())
    assert not any(k.startswith("chaos_region") for k in rid.cache_stats)


# ---------------------------------------------------------- failover ----

def test_failover_rung_fires_only_under_region_faults():
    ref_res, res = _run_both(region_scenario("hardened"))
    _assert_runs_equal(ref_res, res)
    assert res.cache_stats.get("chaos_region_failover", 0) > 0
    assert all(port_guard.decision_available(d) for _, d in res.decisions)
    failover = [d for _, d in res.decisions
                if d.metrics.get("chaos_rung") == -1.0]
    assert failover
    assert all(d.metrics["chaos_region_failover"] >= 1.0 for d in failover)
    # the same scenario without the regional storm never fails over
    _, clean = _run_both(region_scenario("hardened", storm=False))
    assert not any(k.startswith("chaos_region") for k in clean.cache_stats)


def _mk_ritem(i, region, sp, pods=4, bs=1e4, t3=10):
    o = Offering(offering_id=f"t{i}@{region}", instance_type=f"t{i}",
                 family="m", generation=6, vendor="i",
                 specialization="general", size="large", region=region,
                 az=f"{region}a", vcpus=2, mem_gib=8.0, od_price=sp * 3,
                 spot_price=sp, bs_core=bs, sps_single=3, t3=t3,
                 interruption_freq=1)
    return CandidateItem(offering=o, pods=pods, bs=bs, spot_price=sp, t3=t3)


def _region_items(per_region=4, base_sp=0.5, spread=0.1):
    return [_mk_ritem(r_i * per_region + j, region,
                      sp=base_sp + spread * r_i + 0.01 * j)
            for r_i, region in enumerate(REGIONS)
            for j in range(per_region)]


def test_hazard_quarantine_band_defaults_off():
    items = items_from_reference(_region_items())
    hazard = np.full(len(items), 0.9)
    assert port_guard.quarantine_mask(items, port_guard.GuardConfig(),
                                      hazard=hazard) is None
    cfg = port_guard.GuardConfig(hazard_quarantine_rate=0.5)
    mask = port_guard.quarantine_mask(items, cfg, hazard=hazard)
    assert mask is not None and mask.all()
    hazard[0] = 0.1
    assert not port_guard.quarantine_mask(items, cfg, hazard=hazard)[0]
    catalog = [it.offering for it in items]
    off = port_guard.HardenedPolicy(clock=lambda: 0.0)
    off.bind(catalog)
    assert off.estimators is None and off.memo_digest() is None
    on = port_guard.HardenedPolicy(
        clock=lambda: 0.0,
        config=port_guard.GuardConfig(hazard_quarantine_rate=0.2))
    on.bind(catalog)
    assert on.estimators is not None and on.memo_digest() is not None


@pytest.mark.parametrize("spec", POLICIES + ["region_pinned"])
def test_make_policy_region_specs_match_reference(spec):
    ref_cfg = region_scenario().region
    cfg = scenario_from_reference(region_scenario()).region
    want = ref_sim.make_policy(spec, region=ref_cfg)
    got = port_sim.make_policy(spec, region=cfg)
    assert type(got).__name__ == type(want).__name__
    assert type(got).__module__ == type(want).__module__.replace(
        "repro.", "repro_torch.", 1)
    assert got.name == want.name
    if getattr(want, "region", None) is not None:
        assert dataclasses.asdict(got.region) \
            == dataclasses.asdict(want.region)
    assert port_region.RegionPinnedPolicy is type(
        port_sim.make_policy(f"region_pinned:{HOME}"))
