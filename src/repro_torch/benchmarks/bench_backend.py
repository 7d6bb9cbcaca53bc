"""Decision-plane backend benchmark: cross-decision batched GSS×ILP vs the
first per-decision NumPy path (DESIGN.md §12).

The scenario is a FleetSim-style tick with ``n_decisions`` *unique* pending
decisions (demands jittered ±15 % around the acceptance market's 5k pods —
the low-memo-hit regime where the DecisionMemo cannot collapse them):

  * ``pr1_path``        — the first engine, vendored below verbatim
    (greedy LP prune + min-plus D&C backtracking), driven one
    bracketed-GSS cycle per decision against a shared CompiledMarket:
    exactly what the fleet engine paid per unique decision before the
    batched engine;
  * ``sequential``      — the current engine (core-bounded prune + one
    improvement-bit DP), still one cycle per decision, numpy backend;
  * ``batched_numpy``   — one :func:`bracketed_gss_many` over all
    decisions (cross-decision stacked prescan + lockstep golden rounds);
  * ``batched_torch``   — the same batched cycle with every DP dispatched
    through the ``cover_dp`` kernel (``make_backend("torch")``);
  * ``fused_torch``     — the device-resident plane
    (``make_backend("torch:fused")``): prescan + the whole golden-section
    search as ``fused_rows`` launches, counts read back once and replayed
    on host (DESIGN.md §13).  The first call's extra wall (the CUDA
    library's build, cold caches) is recorded separately from the
    steady-state per-decision time (first call minus steady state).

The device legs run on the card, or on the CPU (``torch:cpu`` /
``torch:fused:cpu``: the kernels' plain versions) when the caller passes
``device="cpu"`` / ``--device cpu``; with no device named they follow the
process default (the CPU under ``torch:cpu`` / ``torch:fused:cpu``, the
card otherwise).  They always run: without a card, name the CPU or the
run raises.  Each tick record names the device legs' ``backend`` and the
``device`` they ran on (the card's ``nvidia-smi`` line, or ``"cpu"``).

All walls are interleaved min-of-N (contender order rotated per round) so
thermal throttling on small sustained-load hosts hits every engine alike.
Two tick configs are recorded — the FleetSim-shaped *fleet tick*
(100 items × 1 k pods) and the *acceptance market* (250 × 5 k,
huge-residual DPs) — plus a catalog-size scaling column (250/1000/4000
offerings).

Selections are asserted identical across every path before timing
(engine-equality is part of the backend contract).

Usage:
  python -m repro_torch.benchmarks.bench_backend [--smoke] [--json PATH]
      [--decisions N] [--repeat N] [--scaling] [--device cuda|cpu]

Nothing is written unless ``--json`` names a path.
"""

from __future__ import annotations

import argparse
import json
import platform
import time
from typing import List, Optional

import numpy as np

from ..core import (NumpyBackend, Request, compile_market, e_total,
                    generate_catalog, make_backend, preprocess)
from ..core.efficiency import NodePool, score_counts_batch
from ..core.gss import PHI, bracketed_gss_many
from .common import device_line, device_specs

#: acceptance bar: ≥5× end-to-end provisioning-cycle speedup over the
#: first NumPy path at 250 offerings × 5k pods, n_decisions ≥ 32
TARGET_SPEEDUP = 5.0
PRESCAN = 9
TOLERANCE = 0.01

# ---------------------------------------------------------------------------
# The first NumPy engine (greedy LP prune + min-plus D&C backtracking),
# vendored verbatim from the reference's driver as the baseline
# ---------------------------------------------------------------------------

_INF = float("inf")
_DENSE_BUNDLES = 16
_DENSE_TARGET = 512


def _pr1_cover_dp(bpods, bcosts, target):
    dp = np.full(target + 1, _INF)
    dp[0] = 0.0
    for b in range(len(bpods)):
        pb = int(bpods[b])
        cb = bcosts[b]
        if pb > target:
            np.minimum(dp, cb, out=dp)
            continue
        np.minimum(dp[pb:], dp[:-pb] + cb, out=dp[pb:])
        if pb > 1:
            np.minimum(dp[1:pb], dp[0] + cb, out=dp[1:pb])
    return dp


def _pr1_lp_prune(bpods, bcosts, target):
    B = len(bpods)
    if B == 0 or target <= 0:
        return np.ones(B, dtype=bool)
    rate = bcosts / bpods
    order = np.argsort(rate, kind="stable")
    p_sorted = bpods[order].astype(np.float64)
    c_sorted = bcosts[order]
    cum_p = np.cumsum(p_sorted)
    cum_c = np.cumsum(c_sorted)
    if cum_p[-1] < target:
        return np.ones(B, dtype=bool)
    k_ub = int(np.searchsorted(cum_p, target))
    ub = float(cum_c[k_ub])
    resid = np.maximum(target - bpods, 0).astype(np.float64)
    k = np.searchsorted(cum_p, resid)
    prev_p = np.where(k > 0, cum_p[np.maximum(k - 1, 0)], 0.0)
    prev_c = np.where(k > 0, cum_c[np.maximum(k - 1, 0)], 0.0)
    lp = prev_c + (resid - prev_p) * (c_sorted[k] / p_sorted[k])
    lp[resid <= 0] = 0.0
    return bcosts + lp <= ub * (1.0 + 1e-12) + 1e-9


def _pr1_dense_backtrack(bpods, bcosts, target):
    B = len(bpods)
    take = np.zeros(B, dtype=bool)
    if target <= 0:
        return take
    dp = np.full(target + 1, _INF)
    dp[0] = 0.0
    history = np.empty((B + 1, target + 1))
    history[0] = dp
    for b in range(B):
        pb = int(bpods[b])
        cut = min(pb, target + 1)
        shifted = np.empty(target + 1)
        shifted[:cut] = dp[0]
        if cut <= target:
            shifted[cut:] = dp[: target + 1 - pb]
        dp = np.minimum(dp, shifted + bcosts[b])
        history[b + 1] = dp
    j = target
    for b in range(B - 1, -1, -1):
        if j == 0:
            break
        if history[b + 1][j] < history[b][j] - 1e-12:
            take[b] = True
            j = max(0, j - int(bpods[b]))
    return take


def _pr1_dc_backtrack(bpods, bcosts, target):
    B = len(bpods)
    if target <= 0:
        return np.zeros(B, dtype=bool)
    if B <= _DENSE_BUNDLES or target <= _DENSE_TARGET:
        return _pr1_dense_backtrack(bpods, bcosts, target)
    mid = B // 2
    dp_l = _pr1_cover_dp(bpods[:mid], bcosts[:mid], target)
    dp_r = _pr1_cover_dp(bpods[mid:], bcosts[mid:], target)
    tot = dp_l + dp_r[::-1]
    j1 = int(np.argmin(tot))
    take = np.empty(B, dtype=bool)
    take[:mid] = _pr1_dc_backtrack(bpods[:mid], bcosts[:mid], j1)
    take[mid:] = _pr1_dc_backtrack(bpods[mid:], bcosts[mid:], target - j1)
    return take


def _pr1_solve(market, req_pods, alpha):
    coef = market.coefficients(np.array([alpha]))[0]
    n = market.n
    active = market.structural
    counts = np.zeros(n, dtype=np.int64)
    neg = (coef < 0) & active
    counts[neg] = market.bound[neg]
    covered = int(np.sum(market.pods[neg] * market.bound[neg]))
    residual = max(0, req_pods - covered)
    if residual == 0:
        return list(map(int, counts))
    in_dp = active & ~neg
    if int(np.sum(market.pods[in_dp] * market.bound[in_dp])) < residual:
        return None
    bidx = np.flatnonzero(in_dp[market.b_item])
    bpods = market.b_pods[bidx]
    bcosts = coef[market.b_item[bidx]] * market.b_copies[bidx]
    keep = _pr1_lp_prune(bpods, bcosts, residual)
    kept_idx = np.flatnonzero(keep)
    take = np.zeros(len(bpods), dtype=bool)
    take[kept_idx] = _pr1_dc_backtrack(bpods[kept_idx], bcosts[kept_idx],
                                       residual)
    taken = bidx[take]
    np.add.at(counts, market.b_item[taken], market.b_copies[taken])
    return list(map(int, counts))


def pr1_bracketed_gss(items, req_pods, market):
    """The first engine's guarded cycle: 9-α prescan + golden refinement,
    every solve through the vendored solver (one decision at a time)."""
    grid = [i / (PRESCAN - 1) for i in range(PRESCAN)]
    counts_list = [_pr1_solve(market, req_pods, a) for a in grid]
    scores = score_counts_batch(items, counts_list, req_pods,
                                none_score=float("-inf"),
                                arrays=market.metric_arrays)
    pools = [None if c is None else NodePool(items=list(items), counts=c)
             for c in counts_list]
    best_pool, best_f, best_idx = None, float("-inf"), 0
    for gi, (alpha, score, pool) in enumerate(zip(grid, scores, pools)):
        if pool is not None:
            pool.alpha = alpha
        if score > best_f:
            best_pool, best_f, best_idx = pool, score, gi
    a = grid[max(0, best_idx - 1)]
    b = grid[min(len(grid) - 1, best_idx + 1)]

    cache = {}

    def evaluate(alpha):
        key = round(alpha, 12)
        if key in cache:
            return cache[key]
        counts = _pr1_solve(market, req_pods, alpha)
        if counts is None:
            out = (None, float("-inf"))
        else:
            pool = NodePool(items=list(items), counts=counts, alpha=alpha)
            out = (pool, e_total(pool, req_pods))
        cache[key] = out
        return out

    x1 = b - PHI * (b - a)
    x2 = a + PHI * (b - a)
    pool1, f1 = evaluate(x1)
    pool2, f2 = evaluate(x2)
    g_pool, g_f = (pool1, f1) if f1 >= f2 else (pool2, f2)
    while (b - a) > TOLERANCE:
        if f1 >= f2:
            b = x2
            x2, f2, pool2 = x1, f1, pool1
            x1 = b - PHI * (b - a)
            pool1, f1 = evaluate(x1)
            if f1 > g_f:
                g_pool, g_f = pool1, f1
        else:
            a = x1
            x1, f1, pool1 = x2, f2, pool2
            x2 = a + PHI * (b - a)
            pool2, f2 = evaluate(x2)
            if f2 > g_f:
                g_pool, g_f = pool2, f2
    if g_pool is not None:
        g_pool = g_pool.nonzero()
    inner_f = e_total(g_pool, req_pods) if g_pool is not None \
        else float("-inf")
    if best_pool is not None and best_f > inner_f:
        return best_pool.nonzero()
    return g_pool


# ---------------------------------------------------------------------------
# Benchmark driver
# ---------------------------------------------------------------------------

def _jittered_demands(base: int, n: int, jitter: float = 0.15,
                      seed: int = 0) -> List[int]:
    rng = np.random.default_rng(seed)
    return [int(base * (1 + jitter * (2 * rng.random() - 1)))
            for _ in range(n)]


def _interleaved(fns: dict, repeat: int) -> dict:
    """min-of-N wall time per contender, contenders interleaved and the
    visit order rotated each round.  On small sustained-load hosts the
    clock throttles mid-benchmark; back-to-back ``best_of`` loops hand one
    contender the fast thermal window and another the slow one, while
    interleaving exposes every contender to the same drift."""
    names = list(fns)
    best = {k: float("inf") for k in names}
    for r in range(repeat):
        order = names[r % len(names):] + names[: r % len(names)]
        for k in order:
            t0 = time.perf_counter()
            fns[k]()
            best[k] = min(best[k], time.perf_counter() - t0)
    return best


def _pools_equal(a_pools, b_pools) -> bool:
    return all(
        (a is None) == (b is None) and (a is None or
                                        a.as_dict() == b.as_dict())
        for a, b in zip(a_pools, b_pools))


def bench_tick(n_items: int, base_pods: int, n_dec: int, *,
               repeat: int = 3, include_pr1: bool = True,
               max_offerings: int = 2000, device=None) -> dict:
    """One fleet-tick benchmark config: ``n_dec`` jittered decisions over a
    shared market, every engine timed interleaved, the device engines
    warmed first with the first call's extra wall recorded separately
    (first call minus steady state)."""
    cat = generate_catalog(seed=0, max_offerings=max_offerings)
    items = preprocess(cat, Request(pods=base_pods, cpu_per_pod=2,
                                    mem_per_pod=2))[:n_items]
    market = compile_market(items)
    demands = _jittered_demands(base_pods, n_dec)
    numpy_be = NumpyBackend()
    fake = lambda: 0.0                                     # noqa: E731

    def batched_pools_of(backend):
        return [p for p, _t in bracketed_gss_many(
            items, demands, tolerance=TOLERANCE, market=market,
            timer=fake, backend=backend)]

    def sequential_cycle(backend):
        for r in demands:
            bracketed_gss_many(items, [r], tolerance=TOLERANCE,
                               market=market, timer=fake, backend=backend)

    def batched_cycle(backend):
        bracketed_gss_many(items, demands, tolerance=TOLERANCE,
                           market=market, timer=fake, backend=backend)

    # equality gate before any timing: all engines select identical pools
    batched_pools = batched_pools_of(numpy_be)
    equality = True
    if include_pr1:
        pr1_pools = [pr1_bracketed_gss(items, r, market) for r in demands]
        equality = _pools_equal(pr1_pools, batched_pools)
        if not equality:
            raise AssertionError(
                "backend engines disagree with the first engine's "
                "selections — refusing to time a divergent decision plane")

    fns = {"sequential_numpy": lambda: sequential_cycle(numpy_be),
           "batched_numpy": lambda: batched_cycle(numpy_be)}
    if include_pr1:
        fns["pr1"] = lambda: [pr1_bracketed_gss(items, r, market)
                              for r in demands]

    torch_spec, fused_spec = device_specs(device)
    torch_be = make_backend(torch_spec)
    fused_be = make_backend(fused_spec)
    rec: dict = {"n_items": len(items), "base_pods": base_pods,
                 "n_decisions": n_dec, "demand_jitter": 0.15,
                 "equality_checked": equality,
                 "backend": torch_be.name, "device": device_line(torch_be)}
    first_calls: dict = {}
    # first call = library build / cold caches + one steady run; steady
    # state is measured interleaved below, first-call extra ≈ first − steady
    for name, be in (("batched_torch", torch_be), ("fused_torch", fused_be)):
        t0 = time.perf_counter()
        pools = batched_pools_of(be)
        first_calls[name] = time.perf_counter() - t0
        rec[f"{name}_selections_equal_numpy"] = _pools_equal(
            batched_pools, pools)
    fns["batched_torch"] = lambda: batched_cycle(torch_be)
    fns["fused_torch"] = lambda: batched_cycle(fused_be)

    best = _interleaved(fns, repeat)
    for name, wall in best.items():
        rec[f"{name}_wall_s"] = round(wall, 3)
        rec[f"{name}_ms_per_decision"] = round(wall / n_dec * 1e3, 2)
    for name, first in first_calls.items():
        rec[f"{name}_first_call_s"] = round(first, 3)
        rec[f"{name}_compile_s"] = round(max(0.0, first - best[name]), 3)
    if include_pr1:
        rec["speedups_vs_pr1"] = {
            k: round(best["pr1"] / v, 2) for k, v in best.items()
            if k != "pr1"}
    rec["fused_vs_batched_numpy"] = round(
        best["batched_numpy"] / best["fused_torch"], 2)
    info = fused_be.device_cache_info()
    rec["fused_fallback_solves"] = info.get("fallback_solves", 0)
    return rec


def bench_scaling(offering_sizes=(250, 1000, 4000), *, base_pods: int = 1000,
                  n_dec: int = 8, repeat: int = 2,
                  device=None) -> List[dict]:
    """Catalog-size scaling column: batched NumPy vs fused steady state at
    growing offering counts, demand held at ``base_pods``.  The fused
    engine's per-probe sort is Θ(B log B) on every golden round while the
    host engine sorts once per objective and prunes early, so where the
    two cross is the honest record, not a tuning failure."""
    rows: List[dict] = []
    fake = lambda: 0.0                                     # noqa: E731
    numpy_be = NumpyBackend()
    fused_spec = device_specs(device)[1]
    for size in offering_sizes:
        cat = generate_catalog(seed=0, max_offerings=size)
        items = preprocess(cat, Request(pods=base_pods, cpu_per_pod=2,
                                        mem_per_pod=2))
        market = compile_market(items)
        demands = _jittered_demands(base_pods, n_dec)

        def batched(backend):
            return [p for p, _t in bracketed_gss_many(
                items, demands, tolerance=TOLERANCE, market=market,
                timer=fake, backend=backend)]

        row: dict = {"offerings": size, "n_items": len(items),
                     "base_pods": base_pods, "n_decisions": n_dec}
        fns = {"batched_numpy": lambda: batched(numpy_be)}
        fused_be = make_backend(fused_spec)
        t0 = time.perf_counter()
        fused_pools = batched(fused_be)
        first = time.perf_counter() - t0
        row["selections_equal_numpy"] = _pools_equal(
            batched(numpy_be), fused_pools)
        fns["fused_torch"] = lambda: batched(fused_be)
        best = _interleaved(fns, repeat)
        row["batched_numpy_wall_s"] = round(best["batched_numpy"], 3)
        row["fused_steady_wall_s"] = round(best["fused_torch"], 3)
        row["fused_compile_s"] = round(
            max(0.0, first - best["fused_torch"]), 3)
        row["fused_vs_batched_numpy"] = round(
            best["batched_numpy"] / best["fused_torch"], 2)
        row["fused_fallback_solves"] = \
            fused_be.device_cache_info()["fallback_solves"]
        rows.append(row)
    return rows


def run(smoke: bool = False, n_decisions: Optional[int] = None,
        json_path: Optional[str] = None, repeat: int = 3,
        scaling: Optional[bool] = None, device=None) -> dict:
    """Full benchmark record.

    Two tick configs are measured: the *fleet tick* (100 items × 1 k pods —
    the FleetSim steady-state shape, where per-decision host overhead
    dominates) and, outside smoke, the *acceptance market* (250 items ×
    5 k pods — huge-residual cover DPs; kept as the continuity row).
    ``--smoke`` runs only the fleet tick with fewer decisions.
    """
    n_dec = n_decisions or (8 if smoke else 32)
    configs = {"fleet_tick": bench_tick(100, 1000, n_dec, repeat=repeat,
                                        device=device)}
    if not smoke:
        configs["acceptance_market"] = bench_tick(250, 5000, n_dec,
                                                  repeat=repeat,
                                                  device=device)
    if scaling is None:
        scaling = not smoke
    out = {
        "benchmark": "bench_backend",
        "python": platform.python_version(),
        "numpy": np.__version__,
        "machine": platform.machine(),
        "target_speedup": TARGET_SPEEDUP,
        "configs": configs,
        "scaling": bench_scaling(device=device) if scaling else [],
    }
    tick = configs["fleet_tick"]
    out["headline"] = {
        "fused_vs_batched_numpy_fleet_tick":
            tick.get("fused_vs_batched_numpy"),
        "fused_steady_faster_than_numpy":
            (tick.get("fused_vs_batched_numpy") or 0.0) > 1.0,
        "fused_vs_per_dispatch_torch": round(
            tick["batched_torch_wall_s"] / tick["fused_torch_wall_s"], 2),
        "pr1_meets_target": any(
            isinstance(v, float) and v >= TARGET_SPEEDUP
            for cfg in configs.values()
            for v in cfg.get("speedups_vs_pr1", {}).values()),
    }
    if json_path:
        with open(json_path, "w") as f:
            json.dump(out, f, indent=2)
    return out


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="fleet-tick config only, few decisions (CI)")
    ap.add_argument("--json", default="",
                    help="output record path (default: don't write)")
    ap.add_argument("--decisions", type=int, default=None,
                    help="pending decisions per tick (default 32; 8 smoke)")
    ap.add_argument("--repeat", type=int, default=3,
                    help="interleaved timing rounds per config")
    ap.add_argument("--scaling", action="store_true", default=None,
                    help="force the catalog-size scaling column (default: "
                         "on unless --smoke)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="where the torch legs run (default: the process "
                         "default backend's device, else the card)")
    args = ap.parse_args(argv if argv is not None else [])
    out = run(smoke=args.smoke, n_decisions=args.decisions,
              json_path=args.json or None, repeat=args.repeat,
              scaling=args.scaling, device=args.device)
    tick = out["configs"]["fleet_tick"]
    h = out["headline"]
    detail = (f"numpy:{tick['batched_numpy_wall_s']}s"
              f";fused:{tick.get('fused_torch_wall_s', 'n/a')}s"
              f"(compile:{tick.get('fused_torch_compile_s', 'n/a')}s)"
              f";fused_vs_numpy:{h['fused_vs_batched_numpy_fleet_tick']}x"
              f";fused_vs_torch:{h['fused_vs_per_dispatch_torch']}x")
    us = round(tick["batched_numpy_wall_s"] / tick["n_decisions"] * 1e6)
    print(f"bench_backend,{us},{detail}")
    return out


if __name__ == "__main__":
    import sys
    main(sys.argv[1:])
