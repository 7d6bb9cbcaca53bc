"""The port's fused decision plane (``torch:fused``) against the reference.

On this host ``make_backend("torch:fused:cpu")`` runs the row solver's and
the score's plain versions (``fused_rows_plain``, ``score_plain``; the
golden rows score their own pools, as the kernel's tail does); the
batched guarded GSS through it must select bitwise what the reference's
NumPy engine, ``jax:fused`` (scan path) and ``jax:fused:pallas`` (both
Pallas kernels in interpret mode) select, with zero host-fallback solves.
The CUDA kernels themselves are held to those plain versions on the card by
``chip_smoke.py``.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.core.gss import bracketed_gss_many as ref_gss_many
from repro_torch.core import backend as backend_mod
from repro_torch.core import score as score_mod
from repro_torch.core.cover_dp import SMEM_DP_WIDTH, SMEM_OPTIN
from repro_torch.core.fused_rows import (FEASIBLE, INFEASIBLE,
                                         LP_TABLE_BYTES, PATH_FULL,
                                         PATH_NONE, PATH_PREFIX, POD_CLAMP,
                                         PREFIX_CAP, TOO_WIDE, WORK_BYTES,
                                         DeviceMarket, dp_width, fused_rows,
                                         fused_rows_plain, prefix_plan,
                                         prefix_plans, rows_smem,
                                         seq_cumsum)
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


# -- the pool score, folded into the golden rows ------------------------------

def _scored_stack(seed):
    """``(dm, coefs, actives, reqs, score_req, max_req)``: a stack of rows
    through every exit of the row solver, each with its decision's demand
    to be scored at — the saturation exit (alpha = 1: every coefficient
    negative), an inactive decision's ``req = 0`` re-solve scored at its
    demand, an infeasible demand (a small active set), a demand wider
    than ``max_req`` and rows that reach the decode DP."""
    rng = np.random.default_rng(seed)
    _p, m = _port(gcd_market(rng, n_items=30))
    st = m.structural
    small = st & (np.arange(m.n) < 3)
    alphas = np.array([1.0, 0.3, 0.5, 0.0, 0.05, 0.0])  # 0: nothing covered
    actives = np.stack([st] * len(alphas))
    actives[2] = small
    max_req = 400
    reqs = np.array([300, 0, int((m.pods * m.bound)[small].sum()) + 1,
                     max_req + 50, 250, 120])
    score_req = reqs.astype(np.float64)
    score_req[1] = 300.0                   # the inactive decision's demand
    t = torch.from_numpy
    return (DeviceMarket.build(m, torch.device("cpu")),
            t(m.coefficients(alphas)), t(actives), t(reqs), t(score_req),
            max_req)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_score_their_counts_where_feasible(seed):
    """Row by row, the folded score is ``score_plain`` of the row's counts
    at its ``score_req`` where the row is FEASIBLE, else -inf, through
    every exit; the wrapper's CPU path returns the same three tensors."""
    dm, coefs, actives, reqs, score_req, max_req = _scored_stack(seed)
    exact = (2 ** 62, 1, 1)
    info = []
    counts, status, scores = fused_rows_plain(
        dm, coefs, actives, reqs, exact, max_req, info, score_req=score_req)
    assert status.tolist()[:4] == [FEASIBLE, FEASIBLE, INFEASIBLE, TOO_WIDE]
    assert [r["eff_res"] for r in info[:2]] == [0, 0]      # saturation exits
    assert all(r["kept"] > 0 for r in info[4:])            # decode DP rows
    assert status.tolist()[4:] == [FEASIBLE, FEASIBLE]
    for r in range(len(reqs)):
        want = (score_plain(counts[r:r + 1], dm.perf, dm.price, dm.podsf,
                            score_req[r:r + 1])[0]
                if status[r] == FEASIBLE else torch.tensor(float("-inf"),
                                                           dtype=torch.float64))
        assert scores[r].numpy().tobytes() == want.numpy().tobytes()
    assert (scores[4:] > 0).all()
    got = fused_rows(dm, coefs, actives, reqs, exact, max_req, 1 << 20,
                     score_req=score_req)
    assert all(torch.equal(a, b) for a, b in zip(got, (counts, status,
                                                       scores)))
    assert len(fused_rows(dm, coefs, actives, reqs, exact, max_req,
                          1 << 20)) == 2


@pytest.mark.parametrize("seed", [0, 1])
def test_golden_loop_launches_no_standalone_score(seed, monkeypatch):
    """With the standalone ``score`` made to raise wherever the port holds
    it, a fused batch still selects bitwise what the reference's NumPy
    engine selects: the golden rounds take their scores from the rows."""
    def no_launch(*_args, **_kw):
        raise AssertionError("the golden loop called the standalone score")

    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").startswith("repro_torch")
                and getattr(mod, "score", None) is score_mod.score):
            monkeypatch.setattr(mod, "score", no_launch)
    rng = np.random.default_rng(300 + seed)
    be = port.make_backend("torch:fused:cpu")
    for _ in range(4):
        items = random_market(rng)
        reqs = [int(rng.integers(1, 90)) for _ in range(3)]
        excludes = [random_exclude(rng, len(items)) for _ in reqs]
        got_r, got_p = _both(items, reqs, excludes, REF_NUMPY, be)
        assert got_r == got_p
    assert be.fused_records > 0
    assert be.device_cache_info()["fallback_solves"] == 0


def test_rows_smem_fits_the_widest_row_and_goes_global_beyond():
    """The launch sizing of ``fused_rows``: at the widest ``width_cap``
    that the coarsening allows (8193: gcd mode tops out at the threshold)
    the CTA stays under the H100's opt-in; the LP table holds the second
    row; a T = 20,000 row puts both rows in global memory."""
    widest = dp_width(10 ** 6, (8192, 4096, 250)) + 1
    assert widest == SMEM_DP_WIDTH == 8193
    dp_smem, total = rows_smem(widest)
    assert dp_smem == 8 * widest and LP_TABLE_BYTES >= 8 * widest
    assert total == 204_824 <= SMEM_OPTIN
    assert rows_smem(20_001) == (0, WORK_BYTES + LP_TABLE_BYTES)
    assert max(rows_smem(w)[1] for w in range(1, 20_002, 97)) <= SMEM_OPTIN


def test_cpu_cumsum_is_sequential():
    """The plain row solver takes its sums with CPU ``torch.cumsum``: it
    must be ``np.cumsum`` (one left-to-right chain) bitwise."""
    rng = np.random.default_rng(0)
    for n in (1, 100, 4097, 200_000):
        v = rng.uniform(-3.0, 3.0, n) * 10.0 ** rng.integers(-6, 6, n)
        got = seq_cumsum(torch.from_numpy(v)).numpy()
        assert got.tobytes() == np.cumsum(v).tobytes()


# -- the rate-order prefix the kernel relies on ------------------------------

def _rows_case(name, catalog):
    """``(market, coefs (R, N), actives (R, N), reqs (R,), coarse)`` of one
    case of the prefix tests: seeded random / gcd / deep markets, the
    ``provision(5000)`` prescan at smoke size, and rows built to stress the
    kernel's selection: every rate tied, -0.0 and 0.0 coefficients,
    residual 1, residual equal to capacity (M = n), gcd mode."""
    exact = (2 ** 62, 1, 1)
    rng = np.random.default_rng(sum(map(ord, name)))
    grid = np.array(GRID)
    if name in ("random_market", "gcd_market", "big_market"):
        items = {"random_market": lambda: random_market(rng, 60, 60),
                 "gcd_market": lambda: gcd_market(rng),
                 "big_market": lambda: big_market(rng, 40, 20, 200)}[name]()
        m = _port(items)[1]
        coefs = m.coefficients(grid)
        actives = np.stack([m.structural] * len(grid))
        actives[1] &= rng.random(m.n) < 0.7
        hi = {"random_market": 60, "gcd_market": 1200, "big_market": 3000}
        reqs = rng.integers(1, hi[name] + 1, len(grid))
        coarse = (100, 1_000_000, m.pods_gcd) if name == "gcd_market" \
            else exact
        return m, coefs, actives, reqs, coarse
    if name == "gcd_mode":
        m = _port(gcd_market(rng))[1]
    else:
        m = _port(ref.preprocess(catalog, ref.Request(
            pods=5000, cpu_per_pod=2, mem_per_pod=2,
            workload={"network"})))[1]
    st = m.structural
    if name == "prescan_5000":
        return (m, m.coefficients(grid), np.stack([st] * len(grid)),
                np.full(len(grid), 5000), exact)
    pods = m.pods.astype(np.float64)
    pos = rng.uniform(0.05, 2.0, m.n)
    zeros = pos.copy()
    zeros[rng.random(m.n) < 0.25] = -0.0
    zeros[rng.random(m.n) < 0.05] = 0.0
    base = m.coefficients(np.array([0.1]))[0]
    pb = m.pods * m.bound
    if name == "ties":
        rows = [(0.5 * pods, st, r) for r in (1, 2, 40, 700)]
    elif name == "negative_zero":
        rows = [(zeros, st, 300), (zeros, st, 3000), (-zeros, st, 5)]
    elif name == "residual_1":
        covered = int(pb[st & (base < 0)].sum())
        rows = [(pos, st, 1), (base, st, covered + 1), (zeros, st, 1)]
    elif name == "residual_capacity":
        order = np.argsort(np.where(st, pb, np.iinfo(np.int64).max),
                           kind="stable")
        small = np.zeros(m.n, dtype=bool)
        small[order[np.cumsum(pb[order]) <= 600]] = True
        small &= st
        cap = int(pb[small].sum())
        rows = [(pos, small, cap), (pos, small, cap - 3),
                (pos, st, int(pb[st].sum())), (pos, st, 300)]
    else:                                   # gcd_mode
        rows = [(0.5 * pods, st, 700), (zeros, st, 1200), (pos, st, 150),
                (base, st, 900)]
        return (m, np.stack([r[0] for r in rows]),
                np.stack([r[1] for r in rows]),
                np.array([r[2] for r in rows]), (100, 1_000_000, 8))
    return (m, np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            np.array([r[2] for r in rows]), exact)


PREFIX_CASES = ["random_market", "gcd_market", "big_market", "prescan_5000",
                "ties", "negative_zero", "residual_1", "residual_capacity",
                "gcd_mode"]


def _rate_order(m, coef, act, residual):
    """The row's DP bundles and their stable rate order, as the host engine
    takes them: ``(bidx, pods, costs, order)``."""
    neg = act & (coef < 0.0)
    bidx = np.flatnonzero((act & ~neg)[m.b_item])
    pods = m.b_pods[bidx]
    costs = coef[m.b_item[bidx]] * m.b_copies[bidx].astype(np.float64)
    return bidx, pods, costs, np.argsort(costs / pods + 0.0, kind="stable")


def _poisoned_rows(m, coefs, actives, reqs, coarse, max_req, rng):
    """The row solver over the whole host-order algorithm, with everything
    past the prefix the kernel reads poisoned: the rate order beyond ``M =
    min(n, max(k_ub + _CORE_PAD, _CORE_MIN))`` permuted at random and
    ``cum_c`` beyond ``k_ub`` NaN.  Returns ``(counts, status, reads)``,
    ``reads`` the ``(M, n, candidates)`` of each row that ran the prune."""
    thr, maxr, gcd = coarse
    width_cap = dp_width(max_req, coarse) + 1
    pb_items = m.pods * m.bound
    counts = np.zeros(coefs.shape, dtype=np.int64)
    status = np.zeros(len(reqs), dtype=np.uint8)
    reads = []
    for r, (coef, act, req) in enumerate(zip(coefs, actives, reqs)):
        neg = act & (coef < 0.0)
        counts[r] = np.where(neg, m.bound, 0)
        residual = max(int(req) - int(pb_items[neg].sum()), 0)
        if residual == 0 or int(pb_items[act & ~neg].sum()) < residual:
            status[r] = FEASIBLE if residual == 0 else INFEASIBLE
            continue
        eff_g = gcd if (residual > thr and gcd > 1
                        and -(-residual // gcd) <= maxr) else 1
        eff_res = -(-residual // eff_g)
        if eff_res + 1 > width_cap:
            status[r] = TOO_WIDE
            continue
        bidx, pods, costs, order = _rate_order(m, coef, act, residual)
        n = len(order)
        k_ub = min(int(np.searchsorted(np.cumsum(pods[order]), residual)),
                   n - 1)
        M = min(n, max(k_ub + backend_mod._CORE_PAD, backend_mod._CORE_MIN))
        order = np.concatenate([order[:M], rng.permutation(order[M:])])
        p_sorted = pods[order].astype(np.float64)
        c_sorted = costs[order]
        cum_p = np.cumsum(p_sorted)
        cum_c = np.cumsum(c_sorted)
        cum_c[k_ub + 1:] = np.nan
        reads.append((M, n, prefix_plan(costs / pods + 0.0, pods,
                                        residual)[0]))

        ub = float(cum_c[k_ub])
        rb = np.maximum(residual - pods, 0).astype(np.float64)
        kk = np.minimum(np.searchsorted(cum_p, rb), n - 1)
        km = np.maximum(kk - 1, 0)
        prev_p = np.where(kk > 0, cum_p[km], 0.0)
        prev_c = np.where(kk > 0, cum_c[km], 0.0)
        lp = prev_c + (rb - prev_p) * (c_sorted[kk] / p_sorted[kk])
        lp[rb <= 0.0] = 0.0
        keep = costs + lp <= ub * (1.0 + 1e-12) + 1e-9
        if int(keep.sum()) > backend_mod._CORE_TRIGGER:
            K = min(n, max(k_ub + backend_mod._CORE_PAD,
                           backend_mod._CORE_MIN))
            dp = REF_NUMPY.cover_values(
                [(pods[order[:K]] // eff_g, c_sorted[:K], eff_res)])[0]
            if float(dp[eff_res]) < ub:
                keep = costs + lp <= float(dp[eff_res]) * (1.0 + 1e-12) + 1e-9
        kept = np.flatnonzero(keep)
        kpods = pods[kept] // eff_g
        _dp, bits = REF_NUMPY.cover_bits([(kpods, costs[kept], eff_res)])[0]
        j = eff_res
        for i in range(len(kept) - 1, -1, -1):
            if j == 0:
                break
            if bits[i, j]:
                b = bidx[kept[i]]
                counts[r, m.b_item[b]] += m.b_copies[b]
                j = max(0, j - int(kpods[i]))
        status[r] = FEASIBLE
    return counts, status, reads


@pytest.mark.parametrize("case", PREFIX_CASES)
def test_rows_read_only_the_rate_order_prefix(case, catalog):
    """Poisoning the rate order past the prefix the kernel sorts and
    ``cum_c`` past ``k_ub`` leaves every count and status bitwise
    ``fused_rows_plain``'s; the kernel's selection (``prefix_plan``) holds
    at least that prefix."""
    m, coefs, actives, reqs, coarse = _rows_case(case, catalog)
    max_req = int(reqs.max())
    dm = DeviceMarket.build(m, torch.device("cpu"))
    info = []
    c_p, s_p = fused_rows_plain(dm, torch.from_numpy(coefs),
                                torch.from_numpy(actives),
                                torch.from_numpy(reqs), coarse, max_req, info)
    c_x, s_x, reads = _poisoned_rows(m, coefs, actives, reqs, coarse,
                                     max_req, np.random.default_rng(0))
    assert np.array_equal(c_x, c_p.numpy()) and np.array_equal(s_x,
                                                               s_p.numpy())
    assert reads and any(M < n for M, n, _c in reads)    # something poisoned
    assert all(M <= cand <= n for M, n, cand in reads)
    assert [c for c, p in prefix_plans(info) if p != PATH_NONE] == \
        [cand for _M, _n, cand in reads]


@pytest.mark.parametrize("residual", [1, 37, 900, 30_000, POD_CLAMP])
def test_prefix_plan_holds_the_prefix_and_its_ties(residual):
    """The selection's candidates are every key up to a cut (ties and the
    -0.0 / 0.0 pair included) and at least the prefix M the row reads; a
    residual from ``POD_CLAMP`` up bounds nothing, so M = n."""
    rng = np.random.default_rng(residual)
    n = 6000
    pods = rng.integers(1, 40, n)
    rate = rng.choice(rng.uniform(0.01, 3.0, 700), n)      # many ties
    rate[rng.random(n) < 0.03] = 0.0
    rate = rate + 0.0
    cand, path = prefix_plan(rate, pods, residual)
    order = np.argsort(rate, kind="stable")
    k_ub = min(int(np.searchsorted(np.cumsum(pods[order]), residual)), n - 1)
    M = min(n, max(k_ub + backend_mod._CORE_PAD, backend_mod._CORE_MIN))
    if residual >= POD_CLAMP:
        M = n
    assert M <= cand <= n
    cut = rate[order[cand - 1]]
    assert cand == n or rate[order[cand]] > cut             # whole ties
    assert path == (PATH_PREFIX if cand <= PREFIX_CAP else PATH_FULL)


@pytest.mark.parametrize("case", PREFIX_CASES)
def test_int64_running_sum_is_seq_cumsum(case, catalog):
    """``cum_p`` as the kernel takes it, an int64 scan of the rate-ordered
    pod sizes, is ``seq_cumsum`` of them as float64, bitwise."""
    m, coefs, actives, reqs, _coarse = _rows_case(case, catalog)
    for coef, act, req in zip(coefs, actives, reqs):
        _bidx, pods, _costs, order = _rate_order(m, coef, act, int(req))
        p_sorted = pods[order]
        want = seq_cumsum(torch.from_numpy(p_sorted.astype(np.float64)))
        assert np.cumsum(p_sorted).astype(np.float64).tobytes() == \
            want.numpy().tobytes()


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
    for bad in (torch.tensor([5.0], dtype=torch.float32),
                torch.zeros(2, dtype=torch.float64)):
        with pytest.raises(TypeError, match="score_req"):
            fused_rows(dm, coefs, actives, torch.tensor([5]),
                       (2 ** 62, 1, 1), 5, 1 << 20, score_req=bad)
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
