"""The port's fused decision plane (``torch:fused``) against the reference.

On this host ``make_backend("torch:fused:cpu")`` runs the row solver's and
the score's plain versions (``fused_rows_plain``, ``score_plain``); the
batched guarded GSS through it must select bitwise what the reference's
NumPy engine, ``jax:fused`` (scan path) and ``jax:fused:pallas`` (both
Pallas kernels in interpret mode) select, with zero host-fallback solves.
The CUDA kernels themselves are held to those plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.gss import bracketed_gss_many as ref_gss_many
from repro_torch.core import backend as backend_mod
from repro_torch.core.fused_rows import (FEASIBLE, TOO_WIDE, DeviceMarket,
                                         dp_width, fused_rows,
                                         fused_rows_plain, seq_cumsum)
from repro_torch.core.gss import bracketed_gss_many as port_gss_many
from repro_torch.core.score import score, score_plain

from .strategies import big_market, gcd_market, random_exclude, random_market

REF_NUMPY = ref.NumpyBackend()
GRID = [i / 8 for i in range(9)]


def fake_timer():
    return 0.0


def _summary(results):
    """(pool dict, alpha, trace) per decision: the whole decision record."""
    return [((None if p is None else p.as_dict()),
             (None if p is None else p.alpha), dataclasses.asdict(t))
            for p, t in results]


def _port(items):
    p_items = port.items_from_reference(items)
    return p_items, port.compile_market(p_items)


def _both(items, reqs, excludes, ref_backend, port_backend, **kw):
    p_items, m_p = _port(items)
    ref_kw = dict(kw)
    port_kw = dict(kw)
    if "coarsening" in kw:
        ref_kw["coarsening"] = ref.CoarseningConfig(**kw["coarsening"])
        port_kw["coarsening"] = port.CoarseningConfig(**kw["coarsening"])
    got_r = ref_gss_many(items, reqs, market=ref.compile_market(items),
                         excludes=excludes, timer=fake_timer,
                         backend=ref_backend, **ref_kw)
    got_p = port_gss_many(p_items, reqs, market=m_p, excludes=excludes,
                          timer=fake_timer, backend=port_backend, **port_kw)
    return _summary(got_r), _summary(got_p)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gss_many_equals_reference_numpy(seed):
    """12 random markets a seed (48 in all): masks, infeasible and zero
    demands; pools, alphas and traces bitwise, every probe from the
    device record."""
    rng = np.random.default_rng(100 + seed)
    be = port.make_backend("torch:fused:cpu")
    n_inf = n_masked = n_zero = n_rec = 0
    for k in range(12):
        items = random_market(rng)
        reqs = [int(rng.integers(0, 90))
                for _ in range(int(rng.integers(1, 4)))]
        if k % 4 == 0:
            reqs[0] = 0
        excludes = [random_exclude(rng, len(items)) for _ in reqs]
        got_r, got_p = _both(items, reqs, excludes, REF_NUMPY, be)
        assert got_r == got_p
        n_inf += sum(p is None for p, _a, _t in got_r)
        n_masked += sum(e is not None for e in excludes)
        n_zero += reqs.count(0)
        n_rec += ref.compile_market(items).n_bundles > 0   # else declined
    info = be.device_cache_info()
    assert info["fallback_solves"] == 0
    assert be.fused_records == n_rec == info["verify_solves"] >= 10
    assert n_inf > 0 and n_masked > 0 and n_zero > 0


def test_gss_many_gcd_tier_equals_reference_numpy():
    """Rows above the threshold run at the market gcd on the device, as
    the host's gcd tier does, and select bitwise the same."""
    rng = np.random.default_rng(23)
    be = port.make_backend("torch:fused:cpu")
    cfg = dict(threshold=512, max_rows=1_000_000)
    items = gcd_market(rng, n_items=30, pod_mult=8)
    assert ref.compile_market(items).pods_gcd > 1
    got_r, got_p = _both(items, [700, 1000, 300], [None] * 3, REF_NUMPY, be,
                         coarsening=cfg)
    assert got_r == got_p and all(p is not None for p, _a, _t in got_p)
    assert be.fused_records == 1
    assert be.device_cache_info()["fallback_solves"] == 0


def test_core_bound_rows_equal_reference_numpy():
    """A deep market whose greedy bound keeps more than 160 bundles: its
    rows take the core-DP stage, and the prescan still equals the host
    engine row for row."""
    rng = np.random.default_rng(2)
    items = big_market(rng, n_items=40, t3_lo=20, t3_hi=200)
    reqs = [1500, 3000]
    be = port.make_backend("torch:fused:cpu")
    got_r, got_p = _both(items, reqs, [None, None], REF_NUMPY, be)
    assert got_r == got_p
    _p_items, m = _port(items)
    counts, feas = be._run_prescan(m, reqs, [None, None], GRID)
    want = ref.solve_ilp_many(items, reqs, GRID,
                              market=ref.compile_market(items),
                              backend=REF_NUMPY)
    for d, row in enumerate(want):
        for g, c in enumerate(row):
            assert feas[d, g] == (c is not None)
            assert c is None or list(counts[d, g]) == c
    info = []
    fused_rows_plain(DeviceMarket.build(m, torch.device("cpu")),
                     torch.from_numpy(m.coefficients(np.array(GRID))),
                     torch.from_numpy(np.stack([m.structural] * len(GRID))),
                     torch.full((len(GRID),), 3000), (2 ** 62, 1, 1), 3000,
                     info)
    assert any(r["core"] > 0 for r in info)


def test_approx_tier_batch_is_declined_and_equals_numpy():
    rng = np.random.default_rng(31)
    be = port.make_backend("torch:fused:cpu")
    cfg = dict(threshold=256, max_rows=16, approx_rows=128)
    items = random_market(rng, max_items=12, max_t3=400)
    got_r, got_p = _both(items, [600, 1000], [None, None], REF_NUMPY, be,
                         coarsening=cfg)
    assert got_r == got_p
    assert be.fused_records == 0          # the per-dispatch path ran it


def _bucket_markets(rng, k):
    """Markets that share one reference shape bucket (<= 16 items, <= 32
    bundles), so ``jax:fused`` compiles its two programs once."""
    out = []
    while len(out) < k:
        items = random_market(rng, max_items=8, max_t3=5)
        if 0 < ref.compile_market(items).n_bundles <= 32:
            out.append(items)
    return out


@pytest.fixture(scope="module")
def jax_fused():
    return ref.make_backend("jax:fused")


def test_gss_many_equals_reference_jax_fused(jax_fused):
    rng = np.random.default_rng(5)
    be = port.make_backend("torch:fused:cpu")
    for items in _bucket_markets(rng, 4):
        reqs = [int(rng.integers(1, 90)), int(rng.integers(0, 90))]
        excludes = [random_exclude(rng, len(items)), None]
        got_r, got_p = _both(items, reqs, excludes, jax_fused, be)
        assert got_r == got_p
    assert be.device_cache_info()["fallback_solves"] == 0
    assert jax_fused.device_cache_info()["fallback_solves"] == 0


def test_prescan_and_golden_equal_reference_jax_fused(jax_fused):
    """The two device stages, read back, against the reference's own:
    prescan counts and feasibility; the golden events ev_a / ev_c / ev_f /
    evn."""
    rng = np.random.default_rng(9)
    be = port.make_backend("torch:fused:cpu")
    for items in _bucket_markets(rng, 2):
        p_items, m_p = _port(items)
        m_r = ref.compile_market(items)
        reqs = [int(rng.integers(1, 90)), int(rng.integers(1, 90))]
        excludes = [random_exclude(rng, len(items)), None]
        c_r, f_r = jax_fused._run_prescan(m_r, reqs, excludes, GRID)
        c_p, f_p = be._run_prescan(m_p, reqs, excludes, GRID)
        assert np.array_equal(c_r, c_p) and np.array_equal(f_r, f_p)
        a_list, b_list = [0.25, 0.5], [0.5, 0.75]
        ev_r = jax_fused._run_golden(m_r, reqs, excludes, a_list, b_list,
                                     0.01)
        ev_p = be._run_golden(m_p, reqs, excludes, a_list, b_list, 0.01)
        for x, y in zip(ev_r, ev_p):
            assert np.array_equal(np.asarray(x), y)


def test_gss_many_equals_reference_jax_fused_pallas():
    """``jax:fused:pallas`` runs ``_cover_kernel`` and ``_score_kernel`` in
    interpret mode: two tiny markets."""
    pallas = ref.make_backend("jax:fused:pallas")
    be = port.make_backend("torch:fused:cpu")
    rng = np.random.default_rng(23)
    for _ in range(2):
        items = random_market(rng, max_items=6, max_t3=4)
        got_r, got_p = _both(items, [int(rng.integers(1, 40))], [None],
                             pallas, be)
        assert got_r == got_p
    assert be.device_cache_info()["fallback_solves"] == 0


def _ref_score(counts, perf, price, pods, req):
    sp, sc, sq = counts @ perf, counts @ price, counts @ pods
    ok = (sq >= req) & (sc > 0.0) & (sq > 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(ok, (sp / sc) * (req / sq), 0.0), ok


@pytest.mark.parametrize("n_items", [1, 255, 256, 700])
def test_score_plain_equals_reference_formula(n_items):
    rng = np.random.default_rng(n_items)
    D = 9
    counts = rng.integers(0, 6, size=(D, n_items))
    counts[0] = 0                                   # empty pool
    perf = rng.uniform(1e3, 1e5, n_items)
    price = rng.uniform(0.01, 3.0, n_items)
    pods = rng.integers(1, 9, n_items).astype(np.float64)
    sq = counts @ pods
    req = np.where(rng.random(D) < 0.5, sq, sq + 1).astype(np.float64)
    want, ok = _ref_score(counts.astype(np.float64), perf, price, pods, req)
    t = torch.from_numpy
    got = score(t(counts), t(perf), t(price), t(pods), t(req)).numpy()
    assert np.array_equal(got > 0, ok) and ok.any() and not ok.all()
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-12, atol=0)
    assert np.array_equal(got, score_plain(t(counts), t(perf), t(price),
                                           t(pods), t(req)).numpy())


def test_cpu_cumsum_is_sequential():
    """The plain row solver takes its sums with CPU ``torch.cumsum``: it
    must be ``np.cumsum`` (one left-to-right chain) bitwise."""
    rng = np.random.default_rng(0)
    for n in (1, 100, 4097, 200_000):
        v = rng.uniform(-3.0, 3.0, n) * 10.0 ** rng.integers(-6, 6, n)
        got = seq_cumsum(torch.from_numpy(v)).numpy()
        assert got.tobytes() == np.cumsum(v).tobytes()


def test_device_cache_hits_misses_and_lru():
    be = port.make_backend("torch:fused:cpu")
    rng = np.random.default_rng(7)
    markets = [_port(random_market(rng, max_items=6)) for _ in range(10)]
    assert len({m.digest for _i, m in markets}) == 10
    p_items, m = markets[0]
    port_gss_many(p_items, [20], market=m, timer=fake_timer, backend=be)
    info = be.device_cache_info()
    assert (info["misses"], info["entries"]) == (1, 1)
    hits = info["hits"]
    port_gss_many(p_items, [25], market=m, timer=fake_timer, backend=be)
    info = be.device_cache_info()
    assert info["hits"] > hits and info["misses"] == 1
    for p_items, m in markets[1:]:
        port_gss_many(p_items, [20], market=m, timer=fake_timer, backend=be)
    info = be.device_cache_info()
    assert info["entries"] == be.MAX_MARKETS and info["misses"] == 10
    p_items, m = markets[0]                      # evicted: uploaded again
    port_gss_many(p_items, [20], market=m, timer=fake_timer, backend=be)
    assert be.device_cache_info()["misses"] == 11
    assert set(be.device_cache_info()) == {
        "hits", "misses", "entries", "fallback_solves", "verify_solves",
        "program_builds"}


def test_corrupted_prescan_raises():
    be = port.make_backend("torch:fused:cpu")
    orig = be._run_prescan

    def corrupted(market, reqs, excludes, grid, **kw):
        counts, feas = orig(market, reqs, excludes, grid, **kw)
        counts = counts.copy()
        counts[..., 0] += 1
        return counts, np.ones_like(feas)

    be._run_prescan = corrupted
    items = random_market(np.random.default_rng(41), max_items=6)
    p_items, m = _port(items)
    with pytest.raises(backend_mod._PrescanMismatch, match="diverged"):
        port_gss_many(p_items, [20], market=m, timer=fake_timer, backend=be)


def test_row_wider_than_its_batch_raises():
    """A demand above the batch's ``max_req`` would need more DP columns
    than the launch holds: the row reports TOO_WIDE, and the backend's
    readback raises on it."""
    items = gcd_market(np.random.default_rng(3), n_items=6, pod_mult=1)
    _p_items, m = _port(items)
    dm = DeviceMarket.build(m, torch.device("cpu"))
    coefs = torch.from_numpy(m.coefficients(np.array([0.0, 0.0])))
    actives = torch.from_numpy(np.stack([m.structural] * 2))
    reqs = torch.tensor([1, 40])
    coarse = (2 ** 62, 1, 1)
    counts, status = fused_rows(dm, coefs, actives, reqs, coarse, 1, 1 << 20)
    assert status.tolist() == [FEASIBLE, TOO_WIDE]
    with pytest.raises(RuntimeError, match="width"):
        backend_mod.FusedTorchBackend._to_host(counts, status)
    assert dp_width(40, coarse) == 40
    assert dp_width(10_000, (8192, 4096, 8)) == 8192
    assert dp_width(100_000, (8192, 20_000, 8)) == 12_500
    assert dp_width(100_000, (8192, 4096, 1)) == 100_000


def test_fused_rows_and_score_check_their_inputs():
    items = random_market(np.random.default_rng(4), max_items=6)
    _p, m = _port(items)
    dm = DeviceMarket.build(m, torch.device("cpu"))
    coefs = torch.from_numpy(m.coefficients(np.array([0.5])))
    actives = torch.from_numpy(m.structural[None, :].copy())
    with pytest.raises(TypeError):
        fused_rows(dm, coefs.float(), actives, torch.tensor([5]),
                   (2 ** 62, 1, 1), 5, 1 << 20)
    with pytest.raises(ValueError):
        fused_rows(dm, coefs[:, :-1], actives[:, :-1], torch.tensor([5]),
                   (2 ** 62, 1, 1), 5, 1 << 20)
    with pytest.raises(ValueError):
        score(torch.zeros((1, 3), dtype=torch.int64, device="meta"),
              *(torch.zeros(3, dtype=torch.float64) for _ in range(3)),
              torch.zeros(1, dtype=torch.float64))


def test_fused_specs_run_on_the_card_or_raise():
    cpu = port.make_backend("torch:fused:cpu")
    assert isinstance(cpu, port.FusedTorchBackend)
    assert cpu.device.type == "cpu" and cpu.name == "torch:fused:cpu"
    if torch.cuda.is_available():
        assert port.make_backend("torch:fused").device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.make_backend("torch:fused")


def test_provision_equals_reference(catalog):
    req = dict(pods=100, cpu_per_pod=2, mem_per_pod=2, workload={"network"})
    be = port.make_backend("torch:fused:cpu")
    d_r = ref.KubePACSProvisioner(timer=fake_timer, backend=REF_NUMPY) \
        .provision(ref.Request(**req), catalog)
    d_p = port.KubePACSProvisioner(timer=fake_timer, backend=be) \
        .provision(port.Request(**req), port.catalog_from_reference(catalog))
    assert d_r.pool.items and d_r.metrics["e_total"] > 0
    assert dataclasses.asdict(d_r) == dataclasses.asdict(d_p)
    assert be.fused_records == 1
    assert be.device_cache_info()["fallback_solves"] == 0


def test_solve_batch_tick_equals_reference(catalog):
    rng = np.random.default_rng(0)
    demands = [int(300 * (1 + 0.15 * (2 * rng.random() - 1)))
               for _ in range(6)]
    shape = dict(cpu_per_pod=2, mem_per_pod=2)
    items_r = ref.preprocess(catalog, ref.Request(pods=300, **shape))[:40]
    p_items, m_p = _port(items_r)
    p_catalog = port.catalog_from_reference(catalog)

    def tick(pkg, batch, cat, items, market):
        prov = pkg.KubePACSProvisioner(timer=fake_timer)
        prov.solve_batch = batch
        toks = [prov.provision(pkg.Request(pods=r, **shape), cat,
                               precompiled=(items, market)) for r in demands]
        assert prov.solve_batch.execute() == len(demands)
        return [dataclasses.asdict(t.resolve()) for t in toks]

    batch = port.SolveBatch("torch:fused:cpu")
    assert tick(ref, ref.SolveBatch(REF_NUMPY), catalog, items_r,
                ref.compile_market(items_r)) == \
        tick(port, batch, p_catalog, p_items, m_p)
    assert batch.backend.fused_records == 1
    assert batch.backend.device_cache_info()["fallback_solves"] == 0
