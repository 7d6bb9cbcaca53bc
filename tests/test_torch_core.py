"""The port's host layer and engine (``repro_torch.core``) against the
reference package: catalogs, preprocessing and compiled markets equal field
by field; ``solve_ilp_many`` / ``bracketed_gss_many`` pools, stats and GSS
traces identical over the ``tests/strategies.py`` markets in all three
coarsening tiers; the port's backend inside the reference engine; and the
two entry points of the slice — ``KubePACSProvisioner.provision`` and the
``SolveBatch`` fleet tick — returning the reference's decisions.

The port's engine runs ``TorchBackend("cpu")``: the cover-DP kernel's plain
version, as on every host without a card.
"""

import dataclasses

import numpy as np
import pytest

import repro.core as ref
import repro_torch.core as port
from repro.core.gss import bracketed_gss_many as ref_gss_many
from repro_torch.core.gss import bracketed_gss_many as port_gss_many

from .strategies import big_market, gcd_market, random_exclude, random_market

TORCH_CPU = port.TorchBackend("cpu")
REF_NUMPY = ref.NumpyBackend()
GRID = [i / 8 for i in range(9)]


def fake_timer():
    return 0.0


def _market_arrays(m):
    return {f: getattr(m, f) for f in (
        "pods", "bound", "perf", "price", "perf_norm", "price_norm",
        "structural", "b_item", "b_pods", "b_copies")}


def _port_market(items):
    p_items = port.items_from_reference(items)
    return p_items, port.compile_market(p_items)


def _pools_equal(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a.as_dict() == b.as_dict() and a.counts == b.counts
            and a.alpha == b.alpha)


def _gss_equal(ref_out, port_out):
    assert len(ref_out) == len(port_out)
    for (pr, tr), (pp, tp) in zip(ref_out, port_out):
        assert _pools_equal(pr, pp)
        assert dataclasses.asdict(tr) == dataclasses.asdict(tp)


@pytest.mark.parametrize("seed", [0, 3])
def test_catalog_preprocess_and_market_equal_reference(seed):
    cat_r = ref.generate_catalog(seed=seed, max_offerings=600)
    cat_p = port.generate_catalog(seed=seed, max_offerings=600)
    assert [dataclasses.asdict(o) for o in cat_r] == \
        [dataclasses.asdict(o) for o in cat_p]
    assert port.catalog_from_reference(cat_r) == cat_p
    req = dict(pods=300, cpu_per_pod=2, mem_per_pod=2, workload={"network"})
    items_r = ref.preprocess(cat_r, ref.Request(**req))
    items_p = port.preprocess(cat_p, port.Request(**req))
    assert [dataclasses.asdict(i) for i in items_r] == \
        [dataclasses.asdict(i) for i in items_p]
    assert port.items_from_reference(items_r) == items_p
    m_r, m_p = ref.compile_market(items_r), port.compile_market(items_p)
    for name, arr in _market_arrays(m_r).items():
        other = _market_arrays(m_p)[name]
        assert arr.dtype == other.dtype and arr.tobytes() == other.tobytes(), \
            name
    assert (m_r.perf_min, m_r.sp_min, m_r.pods_gcd, m_r.digest) == \
        (m_p.perf_min, m_p.sp_min, m_p.pods_gcd, m_p.digest)


def _tier_case(tier, rng):
    """(items, demands, excludes, reference config, port config) for one
    coarsening tier at test size."""
    if tier == "exact":
        items = random_market(rng)
        n_dec = int(rng.integers(1, 5))
        demands = [int(rng.integers(0, 90)) for _ in range(n_dec)]
        excludes = [random_exclude(rng, len(items)) for _ in range(n_dec)]
        kw = {}
    elif tier == "gcd":
        items = gcd_market(rng, n_items=30, pod_mult=8)
        demands = [700, 1000]
        excludes = [None, None]
        kw = dict(threshold=512, max_rows=1_000_000)
    else:
        items = big_market(rng, n_items=12, t3_lo=50, t3_hi=400)
        demands = [600, 1000]
        excludes = [None, None]
        kw = dict(threshold=256, max_rows=16, approx_rows=128)
    return (items, demands, excludes, ref.CoarseningConfig(**kw),
            port.CoarseningConfig(**kw))


@pytest.mark.parametrize("tier,n_cases", [("exact", 12), ("gcd", 2),
                                          ("approx", 2)])
def test_solve_ilp_many_equals_reference(tier, n_cases):
    rng = np.random.default_rng({"exact": 11, "gcd": 23, "approx": 31}[tier])
    seen = set()
    for _ in range(n_cases):
        items, demands, excludes, cfg_r, cfg_p = _tier_case(tier, rng)
        alphas = [[0.0, 1.0] + [float(a) for a in rng.uniform(0, 1, 3)]
                  for _ in demands]
        m_r = ref.compile_market(items)
        p_items, m_p = _port_market(items)
        out_r, st_r = ref.solve_ilp_many(
            items, demands, alphas, market=m_r, excludes=excludes,
            backend=REF_NUMPY, return_stats=True, coarsening=cfg_r)
        out_p, st_p = port.solve_ilp_many(
            p_items, demands, alphas, market=m_p, excludes=excludes,
            backend=TORCH_CPU, return_stats=True, coarsening=cfg_p)
        assert out_r == out_p
        assert [[dataclasses.asdict(s) for s in row] for row in st_r] == \
            [[dataclasses.asdict(s) for s in row] for row in st_p]
        seen |= {s.coarse for row in st_p for s in row if s.residual_demand}
    want = {"exact": {"exact"}, "gcd": {"gcd"},
            "approx": {"approx", "approx_fallback"}}[tier]
    assert seen & want


@pytest.mark.parametrize("tier,n_cases", [("exact", 6), ("gcd", 1),
                                          ("approx", 1)])
def test_bracketed_gss_many_equals_reference(tier, n_cases):
    rng = np.random.default_rng({"exact": 5, "gcd": 8, "approx": 13}[tier])
    for _ in range(n_cases):
        items, demands, excludes, cfg_r, cfg_p = _tier_case(tier, rng)
        p_items, m_p = _port_market(items)
        out_r = ref_gss_many(items, demands, market=ref.compile_market(items),
                             excludes=excludes, timer=fake_timer,
                             backend=REF_NUMPY, coarsening=cfg_r)
        out_p = port_gss_many(p_items, demands, market=m_p,
                              excludes=excludes, timer=fake_timer,
                              backend=TORCH_CPU, coarsening=cfg_p)
        _gss_equal(out_r, out_p)


def test_port_backend_inside_reference_engine():
    """The reference engine duck-types its backend: with the port's
    backend injected it selects exactly what its own NumPy backend does."""
    rng = np.random.default_rng(41)
    for _ in range(8):
        items = random_market(rng)
        demands = [int(rng.integers(0, 90)) for _ in range(3)]
        excludes = [random_exclude(rng, len(items)) for _ in demands]
        market = ref.compile_market(items)
        assert ref.solve_ilp_many(items, demands, GRID, market=market,
                                  excludes=excludes, backend=TORCH_CPU) == \
            ref.solve_ilp_many(items, demands, GRID, market=market,
                               excludes=excludes, backend=REF_NUMPY)
        _gss_equal(
            ref_gss_many(items, demands, market=market, excludes=excludes,
                         timer=fake_timer, backend=REF_NUMPY),
            ref_gss_many(items, demands, market=market, excludes=excludes,
                         timer=fake_timer, backend=TORCH_CPU))


def test_provision_equals_reference(catalog):
    """The quickstart entry point on the 600-offering catalog at 100 pods."""
    req = dict(pods=100, cpu_per_pod=2, mem_per_pod=2, workload={"network"})
    d_r = ref.KubePACSProvisioner(timer=fake_timer, backend=REF_NUMPY) \
        .provision(ref.Request(**req), catalog)
    d_p = port.KubePACSProvisioner(timer=fake_timer, backend=TORCH_CPU) \
        .provision(port.Request(**req), port.catalog_from_reference(catalog))
    assert d_r.pool.items and d_r.metrics["e_total"] > 0
    assert dataclasses.asdict(d_r) == dataclasses.asdict(d_p)


def test_solve_batch_tick_equals_reference(catalog):
    """The fleet-tick entry point: jittered decisions collected into one
    ``SolveBatch`` and solved by one batched search."""
    rng = np.random.default_rng(0)
    demands = [int(300 * (1 + 0.15 * (2 * rng.random() - 1)))
               for _ in range(4)]
    shape = dict(cpu_per_pod=2, mem_per_pod=2)
    items_r = ref.preprocess(catalog, ref.Request(pods=300, **shape))[:40]
    p_items, m_p = _port_market(items_r)
    p_catalog = port.catalog_from_reference(catalog)

    def tick(pkg, backend, cat, items, market):
        prov = pkg.KubePACSProvisioner(timer=fake_timer)
        prov.solve_batch = pkg.SolveBatch(backend)
        toks = [prov.provision(pkg.Request(pods=r, **shape), cat,
                               precompiled=(items, market)) for r in demands]
        assert prov.solve_batch.execute() == len(demands)
        return [dataclasses.asdict(t.resolve()) for t in toks]

    assert tick(ref, REF_NUMPY, catalog, items_r,
                ref.compile_market(items_r)) == \
        tick(port, "torch:cpu", p_catalog, p_items, m_p)
