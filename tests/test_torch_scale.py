"""The coarsening ladder (DESIGN.md §14) at ``benchmarks/bench_scale.py``'s
size: the port against the reference from 5 k to 1 M pods.

The market is bench_scale's: ``generate_catalog(seed=17,
max_offerings=1600)`` preprocessed for quarter-vCPU / quarter-GiB pods
(1,597 items, 6,606 bundles, ``pods_gcd`` 8).  The reference side takes it
from ``benchmarks.bench_scale.build_market``; the port builds its own from
the same catalog, and the two must be the same market.  Then, per scale,
the port's ``numpy``, ``"torch:cpu"`` and ``"torch:fused:cpu"`` (the kernels'
plain versions) are held to the reference's NumPy engine:

* every prescan α's pool and ``IlpStats`` bitwise, and the default ladder
  on the tiers bench_scale records;
* ``bracketed_gss_many`` pools and traces equal, ``torch:fused:cpu``
  taking a fused record at 5 k and 20 k and declining the approx regime
  from 50 k up, with zero fallback solves;
* the exact engine (coarsening off) at 20 k and 50 k, whose DP rows are
  wider than ``SMEM_DP_WIDTH``, and the pinned gcd tier at 200 k, whose
  gcd rows must also equal the exact engine's;
* every approx row inside its certificate against the reference's exact
  optimum (bench_scale's ``verify_scale`` bar);
* ``FleetSim`` over ``high_demand_scenario()`` byte-equal to the
  reference's ``run_fleet``.

No exact 1 M decision runs here; ``chip_smoke.py`` phase 16 runs it on the
card.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as ref
import repro.sim as ref_sim
import repro_torch.core as port
import repro_torch.sim as port_sim
from benchmarks.bench_scale import build_market
from repro.core.gss import bracketed_gss_many as ref_gss_many
from repro_torch.core import backend as backend_mod
from repro_torch.core import cover_dp as cdp
from repro_torch.core import fused_rows as fr
from repro_torch.core.gss import bracketed_gss_many as port_gss_many
from repro_torch.sim import scenario_from_reference

SCALES = (5_000, 20_000, 50_000, 200_000, 1_000_000)
SPECS = ("numpy", "torch:cpu", "torch:fused:cpu")
GRID = [i / 8 for i in range(9)]
TOLERANCE = 0.01
#: the ladder's tiers over the prescan grid (BENCH_scale.json's ``tiers``)
TIERS = {5_000: {"exact": 9}, 20_000: {"gcd": 2, "exact": 7},
         50_000: {"approx": 2, "exact": 7},
         200_000: {"approx": 2, "gcd": 1, "exact": 6},
         1_000_000: {"approx": 5, "exact": 4}}
#: coarsening configs by name: the default ladder, the exact engine, and
#: the pinned gcd tier that ``high_demand_scenario``'s docstring names
CONFIGS = {"default": {}, "exact": {"enabled": False},
           "pinned": {"max_rows": 1 << 20}}
REF_NUMPY = ref.NumpyBackend()


def fake_timer():
    return 0.0


@pytest.fixture(autouse=True)
def port_on_host(monkeypatch):
    """The port's default backend is the card; these tests name the host
    (the fleet's inline solves take the process default)."""
    monkeypatch.setenv("KUBEPACS_SERVE_PERF", "analytic")
    saved = backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    yield
    backend_mod._DEFAULT = saved


@pytest.fixture(scope="module")
def markets():
    """``(reference items, reference market, port items, port market)``."""
    items_r, m_r = build_market()
    cat = port.generate_catalog(seed=17, max_offerings=1600)
    items_p = port.preprocess(cat, port.Request(
        pods=5_000, cpu_per_pod=0.25, mem_per_pod=0.25))
    return items_r, m_r, items_p, port.compile_market(items_p)


@pytest.fixture(scope="module")
def reference(markets):
    """The reference engine's per-α ``(pools, stats)`` and its GSS output
    at ``(demand, config name)``, each computed once."""
    items_r, m_r = markets[:2]
    rows, gss = {}, {}

    def per_alpha(demand, name):
        if (demand, name) not in rows:
            pools, stats = ref.solve_ilp_many(
                items_r, [demand], [GRID], market=m_r, backend=REF_NUMPY,
                return_stats=True,
                coarsening=ref.CoarseningConfig(**CONFIGS[name]))
            rows[demand, name] = (pools[0], stats[0])
        return rows[demand, name]

    def decision(demand, name):
        if (demand, name) not in gss:
            gss[demand, name] = ref_gss_many(
                items_r, [demand], tolerance=TOLERANCE, market=m_r,
                timer=fake_timer, backend=REF_NUMPY,
                coarsening=ref.CoarseningConfig(**CONFIGS[name]))
        return gss[demand, name]

    return per_alpha, decision


def _port_rows(markets, demand, name, backend):
    items_p, m_p = markets[2:]
    pools, stats = port.solve_ilp_many(
        items_p, [demand], [GRID], market=m_p, backend=backend,
        return_stats=True,
        coarsening=port.CoarseningConfig(**CONFIGS[name]))
    return pools[0], stats[0]


def _port_gss(markets, demand, name, backend):
    items_p, m_p = markets[2:]
    return port_gss_many(items_p, [demand], tolerance=TOLERANCE, market=m_p,
                         timer=fake_timer, backend=backend,
                         coarsening=port.CoarseningConfig(**CONFIGS[name]))


def _assert_rows_equal(got, want):
    assert got[0] == want[0]
    assert [dataclasses.asdict(s) for s in got[1]] == \
        [dataclasses.asdict(s) for s in want[1]]


def _assert_gss_equal(got, want):
    assert len(got) == len(want)
    for (pp, tp), (pr, tr) in zip(got, want):
        assert (pp is None) == (pr is None)
        if pp is not None:
            assert (pp.as_dict(), pp.counts, pp.alpha) == \
                (pr.as_dict(), pr.counts, pr.alpha)
        assert dataclasses.asdict(tp) == dataclasses.asdict(tr)


def _tiers(stats):
    out = {}
    for s in stats:
        out[s.coarse] = out.get(s.coarse, 0) + 1
    return out


def _fused_ok(be, records):
    if isinstance(be, port.FusedTorchBackend):
        assert be.fused_records == records
        assert be.device_cache_info()["fallback_solves"] == 0


def test_market_equals_bench_scale(markets):
    _items_r, m_r, _items_p, m_p = markets
    assert (m_r.n, m_r.n_bundles, m_r.pods_gcd, m_r.digest) == \
        (m_p.n, m_p.n_bundles, m_p.pods_gcd, m_p.digest)
    assert (m_p.n, m_p.n_bundles, m_p.pods_gcd) == (1_597, 6_606, 8)
    assert int(np.sum(m_p.pods * m_p.bound)) == 1_641_560


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("demand", SCALES)
def test_ladder_equals_reference(markets, reference, demand, spec):
    """The default ladder: every prescan α's pool and stats bitwise the
    reference's, on bench_scale's tiers; one decision's pool and trace
    equal; the fused plane takes the exact and gcd regimes (5 k, 20 k) and
    declines the approx regime to the per-dispatch path."""
    per_alpha, decision = reference
    be = port.make_backend(spec)
    _assert_gss_equal(_port_gss(markets, demand, "default", be),
                      decision(demand, "default"))
    _fused_ok(be, 1 if demand <= 20_000 else 0)
    got = _port_rows(markets, demand, "default", be)
    _assert_rows_equal(got, per_alpha(demand, "default"))
    assert _tiers(got[1]) == TIERS[demand]


@pytest.mark.parametrize("spec", ["torch:cpu", "torch:fused:cpu"])
@pytest.mark.parametrize("demand", [20_000, 50_000])
def test_exact_wide_rows_equal_reference(markets, reference, demand, spec):
    """Coarsening off: DP targets of 20,000 and 50,000, wider than
    ``SMEM_DP_WIDTH`` (the kernels' global-memory rows), through the plain
    versions; the fused plane accepts the batch (``fused_rows_plain`` at
    width ``demand + 1``)."""
    per_alpha, decision = reference
    assert demand + 1 > cdp.SMEM_DP_WIDTH
    be = port.make_backend(spec)
    _assert_gss_equal(_port_gss(markets, demand, "exact", be),
                      decision(demand, "exact"))
    _fused_ok(be, 1)
    _assert_rows_equal(_port_rows(markets, demand, "exact", be),
                       per_alpha(demand, "exact"))


def test_pinned_gcd_equals_reference_and_exact(markets, reference):
    """``CoarseningConfig(max_rows=1 << 20)`` at 200 k: the fused plane
    accepts the batch at DP width 25,001, the decision equals the
    reference's under the same config, and every gcd row's pool is the
    exact engine's (the gcd theorem of DESIGN.md §14)."""
    per_alpha, decision = reference
    demand = 200_000
    be = port.make_backend("torch:fused:cpu")
    _assert_gss_equal(_port_gss(markets, demand, "pinned", be),
                      decision(demand, "pinned"))
    _fused_ok(be, 1)
    coarse = be._coarse(markets[3], port.CoarseningConfig(**CONFIGS["pinned"]))
    assert fr.dp_width(demand, coarse) == 25_000
    got = _port_rows(markets, demand, "pinned", be)
    _assert_rows_equal(got, per_alpha(demand, "pinned"))
    exact_pools, exact_stats = per_alpha(demand, "exact")
    gcd = [i for i, s in enumerate(got[1]) if s.coarse == "gcd"]
    assert len(gcd) == 3
    for i in gcd:
        assert got[0][i] == exact_pools[i]
        assert got[1][i].objective == exact_stats[i].objective


@pytest.mark.parametrize("demand", [50_000, 200_000])
def test_approx_rows_within_certificate(markets, reference, demand):
    """bench_scale's ``verify_scale`` bar for the port's ladder against the
    reference's exact engine: exact, gcd and fallback rows bitwise; every
    approx row's true gap within its ``gap_bound`` and within ``rel_gap``
    of the exact objective."""
    per_alpha, _decision = reference
    pools, stats = _port_rows(markets, demand, "default",
                              port.make_backend("torch:cpu"))
    exact_pools, exact_stats = per_alpha(demand, "exact")
    rel_gap = port.DEFAULT_COARSENING.rel_gap
    n_approx = 0
    for pc, sc, pe, se in zip(pools, stats, exact_pools, exact_stats):
        assert (pc is None) == (pe is None)
        if sc.coarse in ("exact", "gcd", "approx_fallback"):
            assert pc == pe
            continue
        n_approx += 1
        true_gap = sc.objective - se.objective
        assert true_gap <= sc.gap_bound + 1e-6 * max(1.0, abs(se.objective))
        assert true_gap <= rel_gap * max(abs(se.objective), 1e-9) + 1e-9
    assert n_approx == 2


@pytest.fixture(scope="module")
def high_demand_reference():
    """The reference's ``high_demand_scenario()`` fleet over 4 seeds."""
    sc = ref_sim.high_demand_scenario()
    return sc, ref_sim.run_fleet(sc, [0, 1, 2, 3], record_traces=True)


@pytest.mark.parametrize("spec", SPECS)
def test_high_demand_fleet_equals_reference(high_demand_reference, spec):
    """250,000 pods +-20%, 400 offerings, 24 h at 6 h steps: every
    replica's trace byte-equal to the reference's.  The fused fleet takes
    a record only for the batch it can (the rest is the approx regime,
    declined to the per-dispatch path) and never falls back."""
    ref_sc, ref_fleet = high_demand_reference
    sim = port_sim.FleetSim(scenario_from_reference(ref_sc), [0, 1, 2, 3],
                            record_traces=True, backend=spec)
    fleet = sim.run()
    assert len(fleet) == len(ref_fleet) == 4
    for f, r in zip(fleet, ref_fleet):
        assert f.recorder.dumps() == r.recorder.dumps()
        assert f.decision_records() == r.decision_records()
        assert (f.total_cost, f.interrupted_nodes) == \
            (r.total_cost, r.interrupted_nodes)
    be = sim.solve_batch.backend
    if isinstance(be, port.FusedTorchBackend):
        assert be.fused_records >= 1
        assert be.device_cache_info()["fallback_solves"] == 0


def _wide_groups():
    """Two cover groups, one wider than ``SMEM_DP_WIDTH``, with +inf costs,
    ``pods == 1`` and ``pods > T`` present."""
    rng = np.random.default_rng(21)
    T = cdp.SMEM_DP_WIDTH + 807
    pods = rng.integers(1, T // 3, size=14).astype(np.int64)
    pods[[2, 9]] = [1, T + 5]
    costs = rng.uniform(0.01, 3.0, size=14)
    costs[[4, 11]] = np.inf
    return [(pods, costs, T), (pods[:5].copy(), costs[:5].copy(), 300)]


def test_wide_cover_dp_plain_equals_host_and_reference():
    groups = _wide_groups()
    batch = cdp.CoverBatch.build(groups, torch.device("cpu"))
    assert int(batch.scr_off[-1]) == groups[0][2] + 1   # a scratch row
    dp, bits = cdp.cover_dp_plain(batch, True)
    got = batch.split(dp.numpy(), bits.numpy())
    host = port.NumpyBackend()
    for (d, b), (dh, bh), (dr, br), g in zip(
            got, host.cover_bits(groups), REF_NUMPY.cover_bits(groups),
            groups):
        one_d, one_b = port.NumpyBackend._one(g[0], g[1], g[2])
        for dd, bb in ((dh, bh), (dr, br), (one_d, one_b)):
            assert d.tobytes() == dd.tobytes() and np.array_equal(b, bb)


#: one 1,000,001-wide group through ``cover_dp_plain`` in a fresh process:
#: the growth of its peak resident memory over the bits it returns
_PLAIN_MEMORY = """
import resource, sys
import numpy as np, torch
from repro_torch.core import cover_dp as cdp
rng = np.random.default_rng(5)
T, B = 1_000_000, 48
pods = rng.integers(1, 400_000, size=B).astype(np.int64)
batch = cdp.CoverBatch.build([(pods, rng.uniform(0.01, 3.0, size=B), T)],
                             torch.device("cpu"))
before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
_dp, bits = cdp.cover_dp_plain(batch, True)
after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print((after - before) * 1024 / bits.numel())
"""


def test_cover_dp_plain_memory_stays_a_few_bytes_a_bit():
    """The plain version at a million-wide row (the exact 1 M decision's
    width) writes its bits into one block and slices each group out: a few
    bytes of peak memory a bit.  Indexing the block with a boolean mask
    took 24 bytes a bit of int64 coordinates and ran an 80 GB card out of
    memory at the exact 1 M dispatch (2,921 bundles)."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(os.path.dirname(__file__), "..", "src"),
                    os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-c", _PLAIN_MEMORY], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert float(out.stdout) < 8.0


def test_wide_fused_rows_plain_equals_reference_rows(markets, reference):
    """``fused_rows_plain`` over the prescan rows at 20,000 pods with
    coarsening off: DP width 20,001 (both dp rows past shared memory on the
    card, ``rows_smem`` 0), counts equal to the reference row engine's."""
    per_alpha, _decision = reference
    m_p = markets[3]
    demand = 20_000
    dm = fr.DeviceMarket.build(m_p, torch.device("cpu"))
    coefs = torch.from_numpy(m_p.coefficients(np.array(GRID)))
    actives = torch.from_numpy(np.tile(m_p.structural, (len(GRID), 1)))
    reqs = torch.full((len(GRID),), demand, dtype=torch.int64)
    coarse = backend_mod.FusedTorchBackend._coarse(
        m_p, port.CoarseningConfig(enabled=False))
    assert fr.rows_smem(fr.dp_width(demand, coarse) + 1)[0] == 0
    info = []
    counts, status = fr.fused_rows_plain(dm, coefs, actives, reqs, coarse,
                                         demand, info)
    pools, _stats = per_alpha(demand, "exact")
    assert max(r["eff_res"] for r in info) == demand
    for c, s, want in zip(counts.tolist(), status.tolist(), pools):
        assert s == (fr.FEASIBLE if want is not None else fr.INFEASIBLE)
        if want is not None:
            assert c == want
