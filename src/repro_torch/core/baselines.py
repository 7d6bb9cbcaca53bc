"""Baseline provisioners from the paper's evaluation (§5.2, Table 4).

* KubePACS-Greedy — same inputs as KubePACS, naive allocation (ablation).
* SpotVerse-Node / SpotVerse-Pod — price + single-node SPS + IF thresholds.
* SpotKube — NSGA-II genetic algorithm, fixed 4 instances per selected type.
* Karpenter-like — price-capacity-optimized SpotFleet policy (no BS awareness).

All take preprocessed :class:`CandidateItem` lists so every method sees the
identical candidate universe (the paper's controlled comparison).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .efficiency import CandidateItem, NodePool


def _empty(items: Sequence[CandidateItem]) -> NodePool:
    return NodePool(items=list(items), counts=[0] * len(items))


# ---------------------------------------------------------------------------
# KubePACS-Greedy (ablation, §5.2)
# ---------------------------------------------------------------------------

def kubepacs_greedy(items: Sequence[CandidateItem], req_pods: int) -> NodePool:
    """Rank by per-node performance-per-dollar Perf_i/SP_i; fill under T3."""
    pool = _empty(items)
    if not items:
        return pool.nonzero()
    perf = np.array([it.perf for it in items], dtype=np.float64)
    price = np.array([it.spot_price for it in items], dtype=np.float64)
    order = np.argsort(-perf / price, kind="stable")
    remaining = req_pods
    for i in order:
        if remaining <= 0:
            break
        it = items[int(i)]
        if it.pods <= 0 or it.t3 <= 0:
            continue
        take = min(it.t3, math.ceil(remaining / it.pods))
        pool.counts[int(i)] = take
        remaining -= take * it.pods
    return pool.nonzero()


# ---------------------------------------------------------------------------
# SpotVerse (adapted to pod semantics, §5.2)
# ---------------------------------------------------------------------------

def spotverse(items: Sequence[CandidateItem], req_pods: int,
              mode: str = "node", sps_threshold: int = 3,
              if_threshold: int = 2) -> NodePool:
    """Filter by single-node SPS and IF, then pick the cheapest offering.

    ``mode="node"`` ranks by price per node, ``mode="pod"`` by price per pod.
    No multi-node (T3) bound is applied — the paper's Fig. 5b failure mode of
    concentrating hundreds of nodes on one type is intentional here.
    """
    eligible = [i for i, it in enumerate(items)
                if it.offering.sps_single >= sps_threshold
                and it.offering.interruption_freq <= if_threshold
                and it.pods > 0]
    if not eligible:   # relax the thresholds like SpotVerse's fallback tiers
        eligible = [i for i, it in enumerate(items) if it.pods > 0]
    if not eligible:
        return _empty(items)

    if mode == "node":
        best = min(eligible, key=lambda i: items[i].spot_price)
    elif mode == "pod":
        best = min(eligible, key=lambda i: items[i].spot_price / items[i].pods)
    else:
        raise ValueError(f"unknown SpotVerse mode {mode!r}")

    pool = _empty(items)
    pool.counts[best] = math.ceil(req_pods / items[best].pods)
    return pool.nonzero()


# ---------------------------------------------------------------------------
# SpotKube (NSGA-II, fixed 4 instances per selected type, §5.2)
# ---------------------------------------------------------------------------

def spotkube(items: Sequence[CandidateItem], req_pods: int,
             seed: int = 0, population: int = 48, generations: int = 80,
             per_type_count: int = 4) -> NodePool:
    """NSGA-II over type-inclusion bitmasks; each chosen type gets 4 nodes.

    Objectives: (minimize hourly cost, maximize type/AZ diversity), with
    demand coverage as a feasibility constraint (constrained-domination).
    """
    rng = np.random.default_rng(seed)
    n = len(items)
    if n == 0:
        return _empty(items)
    pods = np.array([max(it.pods, 0) for it in items]) * per_type_count
    cost = np.array([it.spot_price for it in items]) * per_type_count
    azs = np.array([hash(it.offering.az) % 10_000 for it in items])

    def fitness(mask: np.ndarray) -> Tuple[float, float, float]:
        covered = float(pods[mask].sum())
        shortfall = max(0.0, req_pods - covered)
        total_cost = float(cost[mask].sum()) if mask.any() else float("inf")
        diversity = float(mask.sum() + len(np.unique(azs[mask]))) if mask.any() else 0.0
        return shortfall, total_cost, -diversity

    def dominated(f1, f2) -> bool:
        """Constrained domination: feasibility first, then Pareto."""
        if f1[0] != f2[0]:
            return f1[0] > f2[0]
        ge = all(a >= b for a, b in zip(f1[1:], f2[1:]))
        gt = any(a > b for a, b in zip(f1[1:], f2[1:]))
        return ge and gt

    pop = rng.random((population, n)) < (req_pods / max(pods.sum(), 1) * 3.0)
    for _ in range(generations):
        fits = [fitness(ind) for ind in pop]
        children = np.empty_like(pop)
        for c in range(population):
            a, b = rng.integers(0, population, size=2)
            parent1 = pop[a] if not dominated(fits[a], fits[b]) else pop[b]
            a, b = rng.integers(0, population, size=2)
            parent2 = pop[a] if not dominated(fits[a], fits[b]) else pop[b]
            cross = rng.random(n) < 0.5
            child = np.where(cross, parent1, parent2)
            flip = rng.random(n) < (2.0 / n)
            children[c] = child ^ flip
        pop = children

    fits = [fitness(ind) for ind in pop]
    feasible = [i for i, f in enumerate(fits) if f[0] == 0.0]
    pick = (min(feasible, key=lambda i: fits[i][1]) if feasible
            else min(range(population), key=lambda i: fits[i]))
    pool = _empty(items)
    for i in np.nonzero(pop[pick])[0]:
        pool.counts[int(i)] = per_type_count
    return pool.nonzero()


# ---------------------------------------------------------------------------
# Karpenter-like (price-capacity-optimized SpotFleet policy, §5.4)
# ---------------------------------------------------------------------------

def karpenter_like(items: Sequence[CandidateItem], req_pods: int) -> NodePool:
    """AWS price-capacity-optimized: blend price and pool-depth ranks, then
    consolidate onto the winning type.  No benchmark-score awareness, no
    multi-node T3 bound — the paper's Fig. 10 behaviour (few large types)."""
    usable = [i for i, it in enumerate(items) if it.pods > 0]
    if not usable:
        return _empty(items)
    price = np.array([items[i].spot_price / items[i].pods for i in usable])
    depth = np.array([items[i].t3 for i in usable], dtype=np.float64)
    # rank 0 = best: cheap per pod, deep capacity pool, big instance
    price_rank = np.argsort(np.argsort(price))
    depth_rank = np.argsort(np.argsort(-depth))
    size_rank = np.argsort(np.argsort(
        [-items[i].offering.vcpus for i in usable]))
    score = 0.5 * price_rank + 0.35 * depth_rank + 0.15 * size_rank
    best = usable[int(np.argmin(score))]
    pool = _empty(items)
    pool.counts[best] = math.ceil(req_pods / items[best].pods)
    return pool.nonzero()
