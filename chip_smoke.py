#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's decision plane (``src/repro_torch``) on the card at the
system's real sizes and holds every result to the host:

1. prints the card (``nvidia-smi``) and builds the CUDA library from every
   ``src/repro_torch/csrc/*.cu`` (``cover_dp``, ``fused_rows``, ``score``,
   ``flash_attention``, ``mamba_scan``); counts the HGMMA (``wgmma``)
   instructions of each bf16 attention kernel (``cuobjdump -sass``);
2. holds the cover-DP kernel to its plain torch version on the card and to
   the host NumPy oracle — dp bytes and bits exactly — on the
   ``_run_pallas_check`` case, a ragged stack of 300 groups with targets up
   to 8192, and a stack with a group too wide for shared memory; times the
   kernel, the plain version and the host at the widest shape, with the
   longest group's bundle count and the kernel's ns a bundle step;
3. ``KubePACSProvisioner().provision`` (default backend ``torch``: the
   cover-DP kernel) on the full 9,792-offering catalog at 1000 and 5000
   pods, equal to the NumPy backend's decision;
4. a fleet tick — ``SolveBatch("torch")`` over 32 jittered decisions — at
   100 items x 1000 pods and 250 items x 5000 pods, equal to NumPy's;
5. the fused plane's kernels at its main-path shapes: ``fused_rows``
   against ``fused_rows_plain`` (counts and status bitwise) on the D x G
   prescan stack of ``provision(5000)``, a golden round of
   ``provision(5000)`` (one row at the full catalog's width), a
   golden-round stack of the 250 x 5000 tick and an adversarial stack at
   the full catalog's width (``stress_rows``: ties, -0.0, residual 1 and
   capacity, gcd mode), each row's path (prefix or full sort) equal to
   ``prefix_plan``'s and both paths taken, and each row's folded pool score
   bitwise ``score_plain``'s (``-inf`` unless feasible), with the kernel's
   clock64 split by stage and the cycles a bundle step of both DPs;
   ``score`` against ``score_plain`` (bitwise, also with NaN prices on
   columns some pools use: those score NaN, the rest as before, as the
   host's ``e_total``); times the kernels, the
   plain versions and, for ``score``, one ``torch.matmul``;
6. ``provision()`` at 1000 and 5000 pods and both fleet ticks through
   ``torch:fused``, each equal to the NumPy decision with no fallback
   solve, at least one verification solve, ``fused_rows`` launched (its
   golden rows scoring their pools) and no standalone ``score`` launch, the
   ``fused_rows`` launches split by stack shape;
   walls of ``torch:fused``, ``torch`` and ``numpy`` (for the ticks with
   each call's garbage-collection time and new device memory segments)
   and the peak device memory;
7. where the time of one fused batch (the 250 x 5000 tick) goes, the
   median of five on fresh backends: host replay, the sampled NumPy
   verification, upload, kernels, readback, with the same host costs and
   no standalone ``score`` launch;
8. the serving path's kernels against their plain torch versions on the
   card: ``flash_attention`` (``o`` and ``lse``) over the kernel tests'
   shapes, masked and non-causal cases in float32 and bfloat16, a ragged
   float32 case, bfloat16 causal prefills at every config head dim and the
   internlm2-1.8b prefill shape; ``mamba_scan`` (``y`` and ``h_final``)
   over the kernel tests' shapes, with an initial state, at every N from
   1 to 16 with S = 1000, and at the falcon-mamba-7b prefill shape; times
   each kernel, its plain version
   and, for attention, ``scaled_dot_product_attention`` in turns with the
   kernel (kernel, SDPA, SDPA, kernel), with TFLOP/s and share of bound;
9. ``launch.serve.serve`` at full width and depth: internlm2-1.8b (16
   requests, batch 8, prompt 1024, 32 new tokens, then 5 requests in
   batches of 4 to drive a padded partial batch) and falcon-mamba-7b (8
   requests, batch 4, prompt 1024, 16 new tokens), weights drawn on the
   card from a seed; every logit finite, every prefill through the
   kernels (launches = layers x batches); prefill and decode walls,
   tokens/s, peak device memory;
10. the slice held on the card: a two-layer float32 cut of each config at
   full width, prefill and 4 greedy decode steps through the kernels
   against the same run through the plain versions (logits within 2e-4,
   tokens equal); and, reported only, the full-depth bfloat16 prefill's
   largest logit difference between the two;
11. the simulation layer (``repro_torch.sim``) at the full-run sizes of
   ``benchmarks/bench_fleet.py``: ``FleetSim`` over the heterogeneous-demand
   scenario (250 offerings, 128 replicas, traces recorded) through
   ``torch:fused``, ``torch`` and ``numpy``, and over the interrupt storm
   and the pressure crunch (250 offerings, 256 replicas each) through
   ``torch:fused`` and ``numpy``; one ``ClusterSim`` of the storm and one
   of the diurnal serving scenario (analytic perf model) under the default
   backend (the card) against ``numpy``; each fleet in turns (``numpy``,
   the device backends, the same reversed, ``numpy``).  Every replica's
   JSONL trace,
   decision records and float totals equal NumPy's byte for byte, no
   fused fleet falls back to a host solve, ``fused_rows`` launches in every
   ``torch:fused`` fleet, ``cover_dp`` in every ``torch`` run, and no
   standalone ``score`` launch; prints replicas/s, memo hit rate, the
   batched searches with their widths and their share of the wall,
   device-market cache misses and the kernels' share of each device
   fleet's wall (CUDA events around every launch);
12. the hardened, regional and serving policies at their benchmarks' sizes
   (parameters of ``benchmarks/bench_chaos.py``, ``bench_region.py`` and
   ``bench_serve.py``, copied): ``FleetSim`` of the combined chaos storm
   under ``hardened`` and ``kubepacs`` (interrupt seeds 3, 7, 11) and the
   clean inertness pair; the regional storm under ``hardened``,
   ``region_pinned:us-east-1`` and ``kubepacs_region`` over shock seeds 11
   and 23; ``run_serving`` of the diurnal workload (24 h, analytic perf
   model) under bench_serve's five policies.  Each in turns through
   ``numpy``, ``torch:fused`` (fleets) and ``torch`` (the process default,
   which every inline solve takes), ``numpy``: traces, decision records,
   ``chaos_*`` ladder counters and serving reports equal to the first
   ``numpy`` run's, no fallback solve, ``cover_dp`` launched by every
   policy that solves inline, the ``numpy`` rung used only where the storm
   injects solver faults; replicas/s and the kernels' share of each wall;
13. ``qwen3-moe-30b-a3b`` (128 experts top-8, GQA 32/4) at full width:
   ``flash_attention`` at its prefill shape (B 4, S 1024, H 32, KV 4, hd
   128, bf16) against its plain version and timed against SDPA in turns; a
   two-layer float32 cut held to the plain attention path (logits within
   2e-4, tokens equal); ``launch.serve.serve`` of 8 requests (batch 4,
   prompt 1024, 16 new tokens) with 24 of the 48 layers (62.3 GB of
   float32 weights drawn on the card), every logit finite, launches =
   layers x batches, peak device memory within the card;
14. training: the gradient functions against their plain versions at the
   training shapes — ``FlashAttention`` (the kernel's ``(o, lse)``, then
   ``flash_bwd_chunked``) at internlm2-1.8b's (B 4, S 1024, H 16, KV 8,
   hd 128, bf16; bar 3e-2) and a float32 case (bar 2e-5), and
   ``SelectiveScan`` (the kernel's ``y``, then the reverse chunk
   recompute) at falcon-mamba-7b's (B 2, S 1024, di 8192, N 16, float32;
   six gradients within 1e-4 of the largest), timing the kernel forwards,
   both recompute backwards and SDPA forward + backward in turns with
   ours; a two-layer float32 cut of each config at full width, three
   ``make_train_step`` steps through the kernels against the same steps
   through the plain versions (losses and grad norms within 1e-4,
   launches = steps x layers x ``remat_passes``); full width:
   internlm2-1.8b at all 24 layers (B 4, S 1024, 5 steps) and
   falcon-mamba-7b at 8 of 64 layers (B 2, 3 steps), with losses, step
   walls, positions/s, share of the bf16 peak, launches and peak
   memory; ``ElasticSpotTrainer`` on internlm2-1.8b's 2-layer cut
   (a 6 GB checkpoint) through two interrupts with ``cover_dp`` on the
   card, its trace and event log equal to the smoke twin's under
   ``numpy``, then a restart that resumes at step 12, with the save and
   restore walls; and ``launch.train.main(["--steps", "6"])`` on the
   default device ("phase14" lines);
15. the cost model and the sharding layer: (a) ``roofline.analyze_step``
   of internlm2-1.8b's prefill (B 8 x S 1024) and one decode step (B 8
   against a 1056-long cache) at full width and depth, counted on ``meta``,
   beside each step's warm median on the card (CUDA events a call), with
   the share ``step_s / measured``; the two kernel ops' counted costs equal
   to ``attn_bound`` / ``scan_bound``; each step's peak of live bytes
   counted on ``meta`` (``StepCost.peak_bytes``) held within 2% + 64 MiB
   of the caching allocator's peak of requested bytes for the same step
   run on the card, after a warm-up call, beside ``max_memory_allocated``'s
   rise: that prefill and decode step, one ``make_train_step`` step of
   internlm2-1.8b at phase 14c's shape (24 layers, B 4 x S 1024, remat
   "dots") and a falcon-mamba-7b prefill (B 4 x S 1024, 8 of 64 layers;
   the ``selective_scan`` op's fake); qwen2.5-14b's full-width decode_32k
   cell counted on ``meta`` with no device or host memory of its size;
   (b) on a 1-rank NCCL group and ``make_local_mesh()`` with
   ``single_pod_rules(fsdp=True)``, ``attn_mode="auto"`` and
   ``ep_shard_map``: internlm2-1.8b served through ``make_sharded_prefill``
   / ``make_sharded_decode`` (batch 8, prompt 1024, 8 new tokens) with
   greedy tokens equal to the unsharded path's and one ``flash_attention``
   launch a layer, the walls of both, and one ``make_sharded_train_step``
   step of the 2-layer float32 cut within 1e-4 of ``make_train_step``'s;
   (c) ServeSim's roofline mode against the analytic one on
   ``generate_catalog(seed=3, max_offerings=60)`` (ranking, SLO mask,
   relative latency equal) and bench_serve's diurnal run under
   ``serving_slo`` with the roofline profile, ``torch`` byte-equal to
   ``numpy``, ``cover_dp`` launched; (d) ``python -m
   repro_torch.launch.dryrun --arch internvl2-1b --shape decode_32k
   --multi-pod`` in a subprocess: status ok on 512 fake ranks, its
   ``memory_analysis`` and args + temp a device ("phase15" lines);
16. the coarsening ladder at ``benchmarks/bench_scale.py``'s size (its
   market and demands, copied): 1,597 items, 6,606 bundles, ``pods_gcd``
   8, from 5,000 to 1,000,000 pods.  (a) At each scale every prescan α's
   pool and ``IlpStats`` through ``torch`` and ``torch:fused`` bitwise
   ``numpy``'s, one ``bracketed_gss_many`` decision equal to ``numpy``'s
   with ``torch:fused`` taking a fused record at 5 k and 20 k and
   declining the approx regime above (its batch then launches
   ``cover_dp``), zero fallback solves, the walls in turns over five
   rounds and each backend's ``scale_ratio_1m_vs_5k``; ``provision()``
   at 1 M pods through the default backend equal to NumPy's. (b) The
   exact engine (coarsening off) through ``numpy``, ``torch`` and the
   fused prescan stack at every scale, bitwise (DP widths to 1,000,001:
   ``cover_dp``'s global-scratch rows, ``fused_rows``' ``dp_global``
   rows, one 6.6 GB row of bits a launch at 1 M, with the peak device
   memory), and the ladder held to it: exact and gcd rows bitwise, every
   approx row within its certificate and ``rel_gap``. (c) The gcd tier
   pinned (``max_rows`` 1<<20) at 200 k and 1 M: decisions and prescan
   rows of ``torch`` and ``torch:fused`` bitwise ``numpy``'s (width
   125,001 at 1 M, two rows a launch), every gcd row bitwise the exact
   engine's. (d) ``FleetSim`` over ``high_demand_scenario()`` with 32
   interrupt seeds, traces recorded, in turns through ``numpy``,
   ``torch:fused`` and ``torch``: byte-equal, no fallback solve,
   replicas/s and fused records beside the launches. (e) ``cover_dp``
   at the widest dispatch of the exact 1 M rows and ``fused_rows`` at the
   pinned-gcd 1 M prescan rows against their plain versions (and
   ``cover_dp`` against the host) bitwise, timed, with their bounds
   ("phase16" lines);
17. the reference's other model families served at full width through
   ``launch.serve.serve`` (8 requests, batch 4, prompt 1024 — internvl2
   1000 after its 256 vision embeddings — 16 new tokens, bf16 compute,
   weights drawn on the card): stablelm-3b (hd 80, partial rotary,
   layernorm), qwen2.5-14b (GQA 40/8, qkv bias) and musicgen-large (4
   codebooks in and out) at every layer in float32, internvl2-1b (the
   vision prefix, GQA 14/2, tied embeddings), jamba-1.5-large's
   ``layout[:5]`` (four Mamba layers, two with MoE, and the attention
   layer: both kernels in one forward, a cache of KV and SSM state) and
   kimi-k2's ``layout[:2]`` (the dense layer and one layer of 384 experts
   with a shared expert, hd 112) with bfloat16 parameters; every request
   served, every logit finite, launches = attention layers x batches and
   Mamba layers x batches, peak device memory within the card, a
   ``torch.profiler`` breakdown of one prefill and one decode step;
   jamba's and kimi's bf16 prefill kernels vs plain versions reported; a
   float32 cut of each family held to the plain versions (prefill B 2 x
   S 256 + 4 greedy decode steps, logits within 2e-4, tokens equal, the
   plain run launching nothing); ``flash_attention`` at each family's
   prefill shape (hd 64 / 80 / 112 / 128, GQA 1 / 5 / 7 / 8, S 1024 and
   1256) held to its plain version with its columns past hd never
   written, timed against SDPA in turns, and ``mamba_scan`` at jamba's
   prefill (B 4, S 1024, di 16,384) against its plain version
   ("phase17" lines);
18. the other families trained through ``make_train_step``,
   ``init_opt_state`` and ``make_batch`` (float32 parameters and AdamW
   moments, bf16 compute, remat "dots"): a float32 cut of each at full
   width (``layout[:2]``; jamba ``(layout[2], layout[4])``, kimi
   ``layout[:1]``), three steps (B 2) through the kernels against the
   same steps through the plain versions (losses and grad norms within
   1e-4, launches = steps x layers of each kind x ``remat_passes``, the
   plain run launching nothing), qwen3-moe's also under remat "none"
   (within 1e-5 of "dots": the recompute routes as the forward did); at
   full width, three steps each of qwen3-moe-30b-a3b ``layout[:4]`` (B
   4; a traced step), jamba-1.5-large ``(layout[2], layout[4])`` (B 2:
   both kernels' gradient functions in one step, the scan at d_inner
   16,384), kimi-k2 ``layout[:1]`` (hd 112), stablelm-3b (hd 80),
   qwen2.5-14b ``layout[:6]`` (GQA 5, qkv bias), internvl2-1b (1,280
   positions: the vision prefix masked from the loss) and
   musicgen-large (four codebooks) at B 4 x S 1024, with losses, step
   walls, positions/s, share of the bf16 peak (6 x active parameters),
   launches and peak memory; and ``launch.train.main`` on the smoke
   configs of qwen3-moe and jamba (``cover_dp`` and each family's
   sequence kernel launched) ("phase18" lines).

Every phase that fails raises, and the script exits non-zero.  Kernel
times are device times (``cuda_ms``: CUDA events around back-to-back
calls queued behind a sleep kernel).  The line before the last is the
kernel record (times, launches on the main paths, bounds; phase 14's
training launches in ``launches_train`` and its gradient readings in
``train``, phase 15's held-step, sharded and roofline-serving launches
in ``launches_cost``, phase 16's launches in ``launches_scale`` and its
readings at the new widths in ``scale``, phase 17's serve launches in
``launches_families`` and its readings at the families' shapes in
``families``, phase 18's training launches in
``launches_train_families``); the last line
is ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card and ``nvcc`` (``CUDA_HOME``, default ``/usr/local/cuda``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks: HBM3 bandwidth, the non-tensor float64 rate,
#: the dense bf16 tensor-core rate (the sequence kernels' bounds,
#: ``attn_bound`` and ``scan_bound``, come from ``repro_torch.roofline``,
#: the cost model's one source of them)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
BF16_TC_OPS_PER_S = 989e12
TOLERANCE = 0.01
#: SM clock cycles a second, to size the sleep kernel of ``cuda_ms`` (an
#: upper estimate: the sleep only has to outlast the host's queueing)
SLEEP_CYCLES_PER_S = 2e9


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def median(xs):
    return float(np.median(np.asarray(xs, dtype=np.float64)))


def fake_timer() -> float:
    return 0.0


def cuda_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn``: one pair of CUDA events around
    ``reps`` back-to-back calls after a warm-up call, over ``reps``.  A
    sleep kernel holds the stream while the host queues the calls, so the
    wrapper's host work between launches is not counted as device time (a
    call that synchronises inside still waits for its own work)."""
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0     # an upper estimate: a warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2 * reps * host_s, 0.05) * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return median(times)


def host_cost(fn, segments):
    """``(wall s, ms in garbage collection, new device memory segments)`` of
    one call of ``fn``: costs that move a wall with no change to its code
    (``segments()``: the caching allocator's cumulative ``cudaMalloc``
    count, each of which may stall the host)."""
    in_gc, t_gc = [0.0], [0.0]

    def on_gc(phase, _info):
        if phase == "start":
            in_gc[0] = time.perf_counter()
        else:
            t_gc[0] += (time.perf_counter() - in_gc[0]) * 1e3

    segs = segments()
    gc.callbacks.append(on_gc)
    try:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(on_gc)
    return wall, t_gc[0], segments() - segs


def random_groups(rng, n, t_max, b_max):
    """Cover-DP groups with +inf costs, pb == 1 and pb > T all present."""
    groups = []
    for _ in range(n):
        T = int(rng.integers(1, t_max + 1))
        B = int(rng.integers(0, b_max + 1))
        pods = rng.integers(1, max(2, T + T // 4), size=B).astype(np.int64)
        pods[rng.random(B) < 0.05] = 1
        costs = rng.uniform(0.01, 3.0, size=B)
        costs[rng.random(B) < 0.1] = np.inf
        groups.append((pods, costs, T))
    return groups


def bound(groups):
    """Least time the card needs for ``groups`` with bits: every input read
    once and every output written once over HBM, or three float64 ops (add,
    compare, select) per column of each finite bundle over the fp64 peak."""
    nbytes = ops = 0
    for pods, costs, T in groups:
        B = len(pods)
        nbytes += 16 * B + 32 + 8 * (T + 1) + B * (T + 1)
        ops += 3 * int(np.isfinite(costs).sum()) * T
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def longest(groups) -> int:
    """The bundle count of the longest group: the chain of dependent bundle
    steps that a launch's time follows."""
    return max((len(g[0]) for g in groups), default=0)


def hgmma_counts(lib):
    """``({head width: HGMMA instructions}, sample lines)`` of each bf16
    attention kernel variant in the built library (``cuobjdump -sass``):
    the samples are the first S = Q K^T and the first P V instruction of
    the width-128 variant (the internlm2 prefill's); None where the toolkit
    has no cuobjdump."""
    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts, samples, fn = {}, {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = re.search(r"flash_wgmma_kernelILi(\d+)E", ln)
            fn = int(m.group(1)) if m else None
            if fn is not None:
                counts[fn] = 0
        elif fn is not None and "HGMMA" in ln:
            counts[fn] += 1
            if fn == 128:
                kind = "P V" if "tnspB" in ln else "Q K^T"
                samples.setdefault(kind, " ".join(ln.split("/*")[1].split(
                    "*/")[1].split()).rstrip(" ;"))
    return counts, samples


def ptxas_summary(log: str) -> str:
    """``kernel: registers, spills, shared memory`` of each entry function
    in ``nvcc -Xptxas -v`` output, with its template arguments."""
    out, name = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            k = re.search(r"([a-z_]+_kernel)(?:I(13__nv_bfloat16|f)E)?"
                          r"(?:ILi(\d+)E)?", m.group(1))
            name = k.group(1) if k else m.group(1)
            if k and k.group(2):
                name += f"<{'bf16' if k.group(2) != 'f' else 'f32'}>"
            elif k and k.group(3):
                name += f"<hd {k.group(3)}>"
        elif name and "spill" in ln:
            spill = ln.strip()
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name} {regs.group(1) if regs else '?'} registers, "
                       f"{spill}, {smem.group(1) if smem else 0} B static "
                       "smem")
            name = None
    return "; ".join(out)


def release(torch) -> None:
    """Give the caching allocator's free blocks back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def max_abs_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    same_inf = np.array_equal(np.isinf(a), np.isinf(b))
    fin = np.isfinite(a) & np.isfinite(b)
    if not same_inf:
        return float("inf")
    return float(np.max(np.abs(a[fin] - b[fin]), initial=0.0))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(json.dumps(run(torch.device("cuda"))))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev) -> dict:
    """Phases 1-18 on ``dev`` (5-7 in :func:`run_fused`, 8-10 in
    :func:`run_serving`, 11 in :func:`run_sim`, 12 in :func:`run_policies`,
    13 in :func:`run_moe`, 14 in :func:`run_train`, 15 in
    :func:`run_cost`, 16 in :func:`run_scale`, 17 in
    :func:`run_families`, 18 in :func:`run_train_families`); returns the
    kernel record."""
    import torch

    from repro_torch.core import (KubePACSProvisioner, NumpyBackend, Request,
                                  SolveBatch, TorchBackend, compile_market,
                                  generate_catalog, get_backend, preprocess)
    from repro_torch.core import cover_dp as cdp
    from repro_torch.core import cuda_lib
    from repro_torch.core.gss import bracketed_gss_many

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    lib, log = cuda_lib.build()
    build_s = time.perf_counter() - t0
    print(f"phase1 build: {lib.name} in {build_s:.3f} s; "
          + (ptxas_summary(log) or "library already built"))
    cuda_lib.library()
    sass = hgmma_counts(lib)
    if sass is None:
        print("phase1 sass: no cuobjdump in the toolkit; HGMMA not counted")
    else:
        hgmma, samples = sass
        check(len(hgmma) == 4 and all(hgmma.values()),
              f"bf16 attention kernels without HGMMA: {hgmma}")
        print("phase1 sass: HGMMA instructions of the bf16 attention kernel, "
              "by head width: " + ", ".join(
                  f"{w}: {n}" for w, n in sorted(hgmma.items()))
              + "; width 128: " + "; ".join(
                  f"{k}: {v}" for k, v in sorted(samples.items())))

    # -- phase 2: kernel vs plain version vs host oracle -------------------
    def hold(groups, label):
        batch = cdp.CoverBatch.build(groups, dev)
        dp_k, bits_k = cdp.cover_dp(batch, True)
        dv_k, _ = cdp.cover_dp(batch, False)
        dp_p, bits_p = cdp.cover_dp_plain(batch, True)
        torch.cuda.synchronize()
        check(torch.equal(dp_k, dp_p) and torch.equal(bits_k, bits_p),
              f"{label}: kernel != plain version on the card")
        check(torch.equal(dv_k, dp_k), f"{label}: values-only dp != dp")
        host = NumpyBackend()
        got = batch.split(dp_k.cpu().numpy(), bits_k.cpu().numpy())
        for (d, b), (dh, bh), dvh in zip(got, host.cover_bits(groups),
                                         host.cover_values(groups)):
            check(d.tobytes() == dh.tobytes() and d.tobytes() == dvh.tobytes()
                  and np.array_equal(b, bh), f"{label}: kernel != host")
        return batch

    rng = np.random.default_rng(17)           # _run_pallas_check inputs
    B = 256
    pods = rng.integers(1, 200, size=B).astype(np.int64)
    costs = rng.uniform(0.01, 3.0, size=B)
    costs[rng.random(B) < 0.25] = np.inf
    hold([(pods, costs, 128)], "pallas-check case W=129 B=256")
    print("phase2 pallas-check case (W=129, B=256): bitwise equal")

    rng = np.random.default_rng(1)
    top = random_groups(rng, 300, 8192, 300)
    top_batch = hold(top, "ragged stack")
    wide = random_groups(rng, 4, 512, 64) + [
        (rng.integers(1, 30000, size=300).astype(np.int64),
         rng.uniform(0.01, 3.0, size=300), 20000)]
    hold(wide, "global-scratch stack")
    print(f"phase2 ragged stack (G={top_batch.n_groups}, max T="
          f"{int(top_batch.targets.max())}, sum B={top_batch.n_bundles}) and "
          f"global-scratch stack (T=20000 beside 4 small groups): bitwise "
          f"equal")

    k_ms = cuda_ms(torch, lambda: cdp.cover_dp(top_batch, True), 10)
    p_ms = cuda_ms(torch, lambda: cdp.cover_dp_plain(top_batch, True), 3)
    h_ms = wall_s(lambda: NumpyBackend().cover_bits(top), 3) * 1e3
    b_ms, b_by = bound(top)
    chain = longest(top)
    print(f"phase2 top shape: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"host numpy {h_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); longest "
          f"group {chain} bundles: {k_ms * 1e6 / max(chain, 1):.1f} ns a "
          f"bundle step")

    # -- phase 3: provision() end to end, default backend ------------------
    catalog = generate_catalog(seed=0)
    check(len(catalog) == 9792, f"catalog has {len(catalog)} offerings")
    check(isinstance(get_backend(), TorchBackend)
          and get_backend().device == dev, "default backend is not the card")
    launches = 0
    for pods in (1000, 5000):
        req = Request(pods=pods, cpu_per_pod=2, mem_per_pod=2,
                      workload={"network"})
        market = compile_market(preprocess(catalog, req))
        prov_t = KubePACSProvisioner(timer=fake_timer)
        prov_n = KubePACSProvisioner(timer=fake_timer, backend=NumpyBackend())
        cdp.cover_dp.launches = 0
        d_t = prov_t.provision(req, catalog)
        n_launch = cdp.cover_dp.launches
        launches += n_launch
        d_n = prov_n.provision(req, catalog)
        check(d_t == d_n and d_t.pool.as_dict() == d_n.pool.as_dict()
              and d_t.alpha == d_n.alpha and d_t.trace == d_n.trace,
              f"provision({pods}) differs from the NumPy decision")
        check(n_launch > 0, f"provision({pods}) launched no kernel")
        check(d_t.metrics["e_total"] > 0 and
              all(np.isfinite(v) for v in d_t.metrics.values()),
              f"provision({pods}) metrics not finite/positive")
        w_t = wall_s(lambda: prov_t.provision(req, catalog), 3)
        w_n = wall_s(lambda: prov_n.provision(req, catalog), 3)
        print(f"phase3 provision pods={pods}: items={market.n} "
              f"bundles={market.n_bundles} alpha={d_t.alpha!r} "
              f"nodes={sum(d_t.pool.counts)} e_total={d_t.metrics['e_total']!r}"
              f" launches={n_launch} wall torch {w_t * 1e3:.3f} ms "
              f"numpy {w_n * 1e3:.3f} ms: equal to NumPy")

    # -- phase 4: fleet tick through SolveBatch ----------------------------
    big = generate_catalog(seed=0, max_offerings=2000)

    def tick(items, market, demands, backend):
        prov = KubePACSProvisioner(timer=fake_timer)
        prov.solve_batch = SolveBatch(backend)
        toks = [prov.provision(Request(pods=r, cpu_per_pod=2, mem_per_pod=2),
                               big, precompiled=(items, market))
                for r in demands]
        check(prov.solve_batch.execute() == len(demands), "batch size")
        return [t.resolve() for t in toks]

    shapes = []
    for n_items, base in ((100, 1000), (250, 5000)):
        items = preprocess(big, Request(pods=base, cpu_per_pod=2,
                                        mem_per_pod=2))[:n_items]
        market = compile_market(items)
        jr = np.random.default_rng(0)
        demands = [int(base * (1 + 0.15 * (2 * jr.random() - 1)))
                   for _ in range(32)]
        cdp.cover_dp.launches = 0
        dec_t = tick(items, market, demands, "torch")
        n_launch = cdp.cover_dp.launches
        launches += n_launch
        dec_n = tick(items, market, demands, NumpyBackend())
        check(dec_t == dec_n and all(
            a.pool.as_dict() == b.pool.as_dict() for a, b in zip(dec_t, dec_n)),
            f"fleet tick {n_items}x{base} differs from NumPy")
        check(n_launch > 0, f"fleet tick {n_items}x{base} launched no kernel")
        w_t = wall_s(lambda: tick(items, market, demands, "torch"), 3)
        w_n = wall_s(lambda: tick(items, market, demands, NumpyBackend()), 3)
        print(f"phase4 fleet tick {n_items} items x {base} pods x 32 "
              f"decisions: launches={n_launch} wall torch {w_t * 1e3:.3f} ms "
              f"numpy {w_n * 1e3:.3f} ms: equal to NumPy")
        shapes.append((items, market, demands))

    # -- where a dispatch's time goes, and the kernel at main-path shapes ---
    class Timed(TorchBackend):
        """Splits each dispatch into host packing + upload, kernel (CUDA
        events) and readback + split, and keeps the widest bits dispatch."""

        def __init__(self, device):
            super().__init__(device)
            self.widest = None
            self.ms = dict.fromkeys(("upload", "kernel", "readback"), 0.0)

        def _dispatch(self, groups, with_bits):
            if not groups:
                return []
            size = sum(len(g[0]) * (g[2] + 1) for g in groups)
            if with_bits and (self.widest is None or size > self.widest[0]):
                self.widest = (size, list(groups))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = cdp.CoverBatch.build(groups, self.device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            dp, bits = cdp.cover_dp(batch, with_bits)
            end.record()
            end.synchronize()
            t2 = time.perf_counter()
            out = batch.split(dp.cpu().numpy(),
                              bits.cpu().numpy() if with_bits else None)
            self.ms["upload"] += (t1 - t0) * 1e3
            self.ms["kernel"] += start.elapsed_time(end)
            self.ms["readback"] += (time.perf_counter() - t2) * 1e3
            return out

    req5k = Request(pods=5000, cpu_per_pod=2, mem_per_pod=2,
                    workload={"network"})
    runs = [("provision 5000 pods",
             lambda be: KubePACSProvisioner(timer=fake_timer, backend=be)
             .provision(req5k, catalog))]
    for (items, market, demands), name in zip(
            shapes, ("fleet tick 100x1000", "fleet tick 250x5000")):
        runs.append((name, lambda be, a=(items, market, demands):
                     bracketed_gss_many(a[0], a[2], tolerance=TOLERANCE,
                                        market=a[1], timer=fake_timer,
                                        backend=be)))
    record = None
    for name, drive in runs:
        timed = Timed(dev)
        gc.collect()     # earlier phases' garbage is no part of this run
        t0 = time.perf_counter()
        drive(timed)
        wall = (time.perf_counter() - t0) * 1e3
        ms = timed.ms
        print(f"breakdown {name}: wall {wall:.3f} ms = host engine "
              f"{wall - sum(ms.values()):.3f} + upload {ms['upload']:.3f} + "
              f"kernel {ms['kernel']:.3f} + readback {ms['readback']:.3f} ms")
        groups = timed.widest[1]
        batch = cdp.CoverBatch.build(groups, dev)
        dp_k, bits_k = cdp.cover_dp(batch, True)
        dp_p, bits_p = cdp.cover_dp_plain(batch, True)
        check(torch.equal(bits_k, bits_p), f"{name} widest: bits differ")
        err = max_abs_err(dp_k.cpu().numpy(), dp_p.cpu().numpy())
        check(err == 0.0 and torch.equal(dp_k, dp_p),
              f"{name} widest: dp differ")
        k_ms = cuda_ms(torch, lambda: cdp.cover_dp(batch, True), 20)
        p_ms = cuda_ms(torch, lambda: cdp.cover_dp_plain(batch, True), 5)
        h_ms = wall_s(lambda: NumpyBackend().cover_bits(groups), 3) * 1e3
        b_ms, b_by = bound(groups)
        chain = longest(groups)
        print(f"kernel at {name} widest dispatch: G={len(groups)} sum B="
              f"{batch.n_bundles} max T={int(batch.targets.max())} bits "
              f"{timed.widest[0]} B: kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
              f"host numpy {h_ms:.4f} ms bound {b_ms:.6f} ms ({b_by}); "
              f"longest group {chain} bundles: "
              f"{k_ms * 1e6 / max(chain, 1):.1f} ns a bundle step")
        record = (err, k_ms, p_ms, b_ms, b_by)     # the last: the 250x5000 tick
    err, k_ms, p_ms, b_ms, b_by = record
    kernels = [{
        "name": "cover_dp", "route": "cuda",
        "variant": "two dp rows, one barrier a finite bundle, the "
                   "bundles staged in shared memory a chunk ahead, a "
                   "thread's columns in registers, 384 threads",
        "source": "src/repro_torch/csrc/cover_dp.cu",
        "replaces": "src/repro/core/backend.py:329 (relax_kernel); "
                    "src/repro/core/backend.py:635 (_cover_kernel)",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]
    ticks = [(items, market, demands, name) for (items, market, demands), name
             in zip(shapes, ("100x1000", "250x5000"))]
    fused = run_fused(dev, catalog, big, ticks)
    kernels = kernels + fused + run_serving(dev)
    sim = run_sim(dev)
    policies = run_policies(dev)
    moe = run_moe(dev)
    train = run_train(dev)
    cost = run_cost(dev)
    scale = run_scale(dev)
    families = run_families(dev)
    train_families = run_train_families(dev)
    for k in kernels:
        k["launches_sim"] = sim.get(k["name"], 0)
        k["launches_policies"] = policies.get(k["name"], 0)
        k["launches"] += k["launches_sim"] + k["launches_policies"]
        if k["name"] in ("flash_attention", "mamba_scan", "cover_dp"):
            k["launches_train"] = train["launches"].get(k["name"], 0)
            k["launches_train_families"] = train_families["launches"].get(
                k["name"], 0)
            k["launches"] += (k["launches_train"]
                              + k["launches_train_families"])
        if k["name"] in train:
            k["train"] = train[k["name"]]
        if k["name"] in ("flash_attention", "mamba_scan", "cover_dp"):
            k["launches_cost"] = cost["launches"].get(k["name"], 0)
            k["launches"] += k["launches_cost"]
        if k["name"] in ("cover_dp", "fused_rows"):
            k["launches_scale"] = scale["launches"].get(k["name"], 0)
            k["launches"] += k["launches_scale"]
            k["scale"] = scale[k["name"]]
        if k["name"] in ("flash_attention", "mamba_scan"):
            k["launches_families"] = families["launches"][k["name"]]
            k["launches"] += k["launches_families"]
            k["families"] = families[k["name"]]
        if k["name"] == "flash_attention":
            k["launches_moe"] = moe["launches"]
            k["launches"] += moe["launches"]
            k["gqa8"] = {key: moe[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}
    return {"kernels": kernels}


def rows_bound(dm, coefs, info):
    """Least time the card needs for one ``fused_rows`` stack: its inputs
    (coefficients, flags, demands, the market's item and bundle arrays)
    read once and its counts and statuses written once over HBM, or its
    float64 operations over the fp64 peak — 3 per DP column of every core
    and kept bundle, and 2*ceil(log2 n) + 10 per DP bundle of a row for the
    sort and the prune — as this run's rows need them (``info`` from
    ``fused_rows_plain``)."""
    R, N = coefs.shape
    nbytes = R * N * (8 + 1 + 8) + R * (8 + 1) + N * 16 + dm.n_bundles * 24
    ops = sum(3 * (r["core"] + r["kept"]) * r["eff_res"]
              + r["n"] * (2 * math.ceil(math.log2(max(r["n"], 2))) + 10)
              for r in info)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stress_rows(market, dev, seed=15):
    """``(coefs, actives, reqs, coarse, max_req)`` of rows built to stress
    the prefix selection of ``fused_rows`` at ``market``'s width: every item
    at one rate (ties, so the full path), residual 1, -0.0 and 0.0
    coefficients (5%: ties inside the prefix path's first bin; 25%: more
    zero keys than the prefix holds, the full path), the residual equal to
    the capacity of a small active set (M = n) and just below it, a
    gcd-mode row and a plain objective row."""
    import torch

    rng = np.random.default_rng(seed)
    N = market.n
    st = market.structural
    pods = market.pods.astype(np.float64)
    pb = market.pods * market.bound
    pos = rng.uniform(0.05, 2.0, N)
    rows = [(0.5 * pods, st, 1), (pos, st, 1)]
    for share in (0.05, 0.25):
        c = pos.copy()
        c[rng.random(N) < share] = -0.0
        c[rng.random(N) < share / 5] = 0.0
        rows.append((c, st, 3000))
    order = np.argsort(np.where(st, pb, np.iinfo(np.int64).max),
                       kind="stable")        # least pods * bound first
    small = np.zeros(N, dtype=bool)
    small[order[np.cumsum(pb[order]) <= 6000]] = True
    small &= st
    cap = int(pb[small].sum())
    rows += [(pos, small, cap), (pos, small, cap - 7), (pos, st, 7000),
             (market.coefficients(np.array([0.1]))[0], st, 5000)]
    coefs = torch.from_numpy(np.stack([r[0] for r in rows])).to(dev)
    actives = torch.from_numpy(np.stack([r[1] for r in rows])).to(dev)
    reqs = torch.tensor([r[2] for r in rows], dtype=torch.int64, device=dev)
    return coefs, actives, reqs, (6500, 1_000_000, 4), int(reqs.max())


def stage_split(stamps, names, pruned, info):
    """The mean clock64 cycles a row spends in each stage over the rows
    that ran the prune (``pruned``), as ``name cycles (share)``, the
    slowest row's total, and the cycles a bundle step of each DP: the
    stage's cycles over its bundles (``core`` and ``kept`` of
    ``fused_rows_plain``'s ``info``), summed over the rows that ran it (the
    core DP's stage also holds its keep pass)."""
    d = np.diff(stamps[pruned], axis=1)
    if not len(d):
        return "no row ran the prune"
    mean = d.mean(axis=0)
    tot = mean.sum()
    rows = [r for r, p in zip(info, pruned) if p]
    per_step = []
    for stage, key in (("core_dp", "core"), ("decode_dp", "kept")):
        steps = np.array([r[key] for r in rows])
        cyc = d[:, names.index(stage)]
        per_step.append(f"{stage} {cyc[steps > 0].sum() / steps.sum():.1f}"
                        if steps.sum() else f"{stage} none")
    return (", ".join(f"{n} {m:.0f} ({m / tot:.3f})"
                      for n, m in zip(names, mean))
            + f"; slowest row {int(d.sum(axis=1).max())} cycles; cycles a "
            "bundle step: " + ", ".join(per_step))


def score_bound(D, N):
    """Counts and the three market vectors read once, the demands read and
    the scores written once, over HBM; or 6 flops a column over fp64."""
    t_bytes = (D * N * 8 + 3 * N * 8 + 2 * D * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = 6 * D * N / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_fused(dev, catalog, big, ticks) -> list:
    """Phases 5-7 on ``dev``: the fused plane.  ``ticks`` holds the fleet
    ticks of phase 4 as ``(items, market, demands, name)``; returns the
    kernel records of ``fused_rows`` and ``score``."""
    import torch

    from repro_torch.core import (FusedTorchBackend, KubePACSProvisioner,
                                  NumpyBackend, Request, SolveBatch,
                                  compile_market, make_backend, preprocess)
    from repro_torch.core import backend as bmod
    from repro_torch.core import fused_rows as fr
    from repro_torch.core import score as sc
    from repro_torch.core.gss import bracketed_gss_many

    class Capture(FusedTorchBackend):
        """Keeps the inputs of every row stack: ``(args, score_req)``."""

        def __init__(self, device):
            super().__init__(device)
            self.rows = []

        def _rows(self, *args, score_req=None):
            self.rows.append((args, score_req))
            return FusedTorchBackend._rows(self, *args, score_req=score_req)

    # -- phase 5: kernels vs plain versions at main-path shapes -------------
    req5k = Request(pods=5000, cpu_per_pod=2, mem_per_pod=2,
                    workload={"network"})
    cap_p = Capture(dev)
    KubePACSProvisioner(timer=fake_timer, backend=cap_p).provision(req5k,
                                                                   catalog)
    t_items, t_market, t_demands, t_name = ticks[-1]
    cap_t = Capture(dev)
    bracketed_gss_many(t_items, t_demands, tolerance=TOLERANCE,
                       market=t_market, timer=fake_timer, backend=cap_t)
    budget = cap_p.bits_budget
    rows_rec = None
    path_rows = collections.Counter()
    dm5 = cap_p.rows[0][0][0]
    # rows[0] is the prescan stack, rows[1] the bracket's first two probes,
    # rows[2:] the golden rounds (one row per decision, each scoring its
    # pool); then the stress rows at the full catalog's width (no plain
    # time: a reading, not a path). Every stack is held with scores too (the
    # prescan's and the stress rows' at their own demands); each is timed
    # as its main path calls it
    for name, ((dm, coefs, actives, reqs, coarse, max_req), main_req), \
            timed in (
            ("prescan of provision 5000", cap_p.rows[0], True),
            ("golden round of provision 5000", cap_p.rows[2], True),
            (f"golden round of tick {t_name}", cap_t.rows[2], True),
            ("adversarial stack", ((dm5, *stress_rows(
                compile_market(preprocess(catalog, req5k)), dev)), None),
             False)):
        held_req = (main_req if main_req is not None
                    else reqs.to(torch.float64))

        def kernel(score_req=main_req, **out):
            return fr.fused_rows(dm, coefs, actives, reqs, coarse, max_req,
                                 budget, score_req=score_req, **out)

        def plain(info=None, score_req=main_req):
            return fr.fused_rows_plain(dm, coefs, actives, reqs, coarse,
                                       max_req, info, score_req=score_req)

        R = coefs.shape[0]
        paths = torch.full((R,), 255, dtype=torch.uint8, device=dev)
        stamps = torch.zeros((R, len(fr.STAGES) + 1), dtype=torch.int64,
                             device=dev)
        ck, sk, fk = kernel(held_req, paths=paths, stages=stamps)
        info = []
        cp, sp, fp = plain(info, held_req)
        torch.cuda.synchronize()
        check(torch.equal(ck, cp) and torch.equal(sk, sp),
              f"fused_rows {name}: kernel != plain version on the card")
        check(fk.cpu().numpy().tobytes() == fp.cpu().numpy().tobytes(),
              f"fused_rows {name}: folded scores != score_plain's")
        if main_req is not None:
            golden = (dm, ck, main_req, fk)       # the last: the tick's
        took = paths.cpu().numpy()
        plans = fr.prefix_plans(info)
        check(took.tolist() == [p for _c, p in plans],
              f"fused_rows {name}: paths {took.tolist()} against the "
              f"selection's {[p for _c, p in plans]}")
        path_rows.update(took.tolist())
        err = float((ck - cp).abs().max()) if ck.numel() else 0.0
        k_ms = cuda_ms(torch, kernel, 5)
        p_ms = cuda_ms(torch, plain, 1) if timed else None
        b_ms, b_by = rows_bound(dm, coefs, info)
        status = sk.cpu().numpy()
        split = stage_split(stamps.cpu().numpy(), fr.STAGES,
                            took != fr.PATH_NONE, info)
        print(f"phase5 fused_rows at {name}: rows={R} N={dm.n_items} B="
              f"{dm.n_bundles} feasible={int((status == fr.FEASIBLE).sum())}"
              f" scored={'yes' if main_req is not None else 'held only'}"
              f" max kept={max(r['kept'] for r in info)} max core="
              f"{max(r['core'] for r in info)} max eff_res="
              f"{max(r['eff_res'] for r in info)} max candidates="
              f"{max(c for c, _p in plans)}; paths none/prefix/full "
              f"{[int((took == p).sum()) for p in range(3)]}: counts, status "
              f"and scores bitwise equal;"
              f" kernel {k_ms:.4f} ms plain "
              + (f"{p_ms:.4f} ms" if p_ms is not None else "not timed")
              + f" bound {b_ms:.6f} ms ({b_by}); clock64 cycles a pruned "
              f"row: {split}")
        if timed:
            rows_rec = rows_rec or (err, k_ms, p_ms, b_ms, b_by)
    check(path_rows[fr.PATH_PREFIX] > 0 and path_rows[fr.PATH_FULL] > 0,
          f"fused_rows: both paths not taken in phase 5 ({path_rows})")

    dm, counts, reqf, folded = golden     # the tick's first golden round
    sk = sc.score(counts, dm.perf, dm.price, dm.podsf, reqf)
    sp = sc.score_plain(counts, dm.perf, dm.price, dm.podsf, reqf)
    torch.cuda.synchronize()
    check(torch.equal(sk, sp), "score: kernel != plain version on the card")
    fin = torch.isfinite(folded)
    check(torch.equal(folded[fin], sk[fin]),
          "score: the folded scores differ from the standalone kernel's")
    # a corrupted feed: NaN prices on every third column the first pool
    # leaves unused, and every other pool given a node of one of them; a
    # pool that uses none of them scores as before, one that does is NaN
    cols = torch.arange(counts.shape[1], device=dev)
    hit = (cols % 3 == 0) & (counts[0] == 0)
    bad = torch.where(hit, torch.full_like(dm.price, float("nan")),
                      dm.price)
    mixed = counts.clone()
    mixed[1::2, int(torch.nonzero(hit)[0])] += 1
    nk = sc.score(mixed, dm.perf, bad, dm.podsf, reqf)
    npl = sc.score_plain(mixed, dm.perf, bad, dm.podsf, reqf)
    nan = torch.isnan(npl)
    clean = ~((mixed != 0) & hit).any(dim=1)
    check(torch.equal(torch.isnan(nk), nan)
          and torch.equal(nk[~nan], npl[~nan])
          and torch.equal(nk[clean], sk[clean]),
          "score: kernel != plain version with NaN prices")
    check(bool(clean.any()) and bool(nan.any()),
          f"score with NaN prices: clean {clean.tolist()} nan "
          f"{nan.tolist()}")
    print(f"phase5 score with NaN prices on {int(hit.sum())} columns: "
          f"{int(nan.sum())} NaN scores, {int(clean.sum())} pools clear of "
          f"them scoring as before: bitwise equal to the plain version")
    s_err = float((sk - sp).abs().max())
    s_ms = cuda_ms(torch, lambda: sc.score(counts, dm.perf, dm.price,
                                           dm.podsf, reqf), 20)
    sp_ms = cuda_ms(torch, lambda: sc.score_plain(counts, dm.perf, dm.price,
                                                  dm.podsf, reqf), 5)
    cf = counts.to(torch.float64)
    vecs = torch.stack([dm.perf, dm.price, dm.podsf], dim=1)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(cf, vecs), 20)
    sb_ms, sb_by = score_bound(*counts.shape)
    print(f"phase5 score at golden round of tick {t_name}: D={counts.shape[0]}"
          f" N={counts.shape[1]}: bitwise equal; kernel {s_ms:.4f} ms plain "
          f"{sp_ms:.4f} ms torch.matmul {lib_ms:.4f} ms bound {sb_ms:.6f} ms "
          f"({sb_by})")

    # -- phase 6: the main path through torch:fused --------------------------
    n_rows = n_score = n_scoring = n_scored = 0
    torch.cuda.reset_peak_memory_stats(dev)
    stacks = collections.Counter()      # (rows, N) of each fused_rows stack
    scored = [0]                        # rows asked for their scores
    rows_fn = FusedTorchBackend._rows

    def recorded_rows(self, dm, coefs, *args, score_req=None):
        stacks[tuple(coefs.shape)] += 1
        if score_req is not None:
            scored[0] += coefs.shape[0]
        return rows_fn(self, dm, coefs, *args, score_req=score_req)

    def counted(drive):
        nonlocal n_rows, n_score, n_scoring, n_scored
        fr.fused_rows.launches = fr.fused_rows.scoring_launches = 0
        sc.score.launches = scored[0] = 0
        stacks.clear()
        FusedTorchBackend._rows = recorded_rows
        try:
            out = drive()
        finally:
            FusedTorchBackend._rows = rows_fn
        got = (fr.fused_rows.launches, sc.score.launches,
               fr.fused_rows.scoring_launches)
        check(sum(stacks.values()) == got[0], f"fused_rows stacks {stacks} "
              f"against {got[0]} launches")
        n_rows += got[0]
        n_score += got[1]
        n_scoring += got[2]
        n_scored += scored[0]
        return out, got

    def split():
        return ", ".join(f"{n} x (rows {r}, N {c})"
                         for (r, c), n in sorted(stacks.items()))

    def fused_ok(be, what, got):
        info = be.device_cache_info()
        check(info["fallback_solves"] == 0, f"{what}: fallback solves {info}")
        check(info["verify_solves"] >= 1, f"{what}: no verification solve")
        check(got[0] > 0 and got[2] > 0 and got[1] == 0,
              f"{what}: launches (fused_rows, standalone score, scoring "
              f"fused_rows) {got}")

    for pods in (1000, 5000):
        req = Request(pods=pods, cpu_per_pod=2, mem_per_pod=2,
                      workload={"network"})
        provs = {spec: KubePACSProvisioner(timer=fake_timer,
                                           backend=make_backend(spec))
                 for spec in ("torch:fused", "torch", "numpy")}
        d_f, got = counted(lambda: provs["torch:fused"].provision(req,
                                                                  catalog))
        prov_split = split()
        d_n = provs["numpy"].provision(req, catalog)
        check(d_f == d_n and d_f.pool.as_dict() == d_n.pool.as_dict()
              and d_f.alpha == d_n.alpha and d_f.trace == d_n.trace,
              f"torch:fused provision({pods}) differs from NumPy")
        fused_ok(provs["torch:fused"].backend, f"provision({pods})", got)
        walls = {spec: wall_s(lambda p=p: p.provision(req, catalog), 3)
                 for spec, p in provs.items()}
        print(f"phase6 provision pods={pods} torch:fused: alpha="
              f"{d_f.alpha!r} nodes={sum(d_f.pool.counts)} launches "
              f"fused_rows={got[0]} ({prov_split}; {got[2]} scoring) "
              f"standalone score={got[1]}; wall "
              + " ".join(
                  f"{k} {v * 1e3:.3f} ms" for k, v in walls.items())
              + ": equal to NumPy")

    def segments():
        return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)

    def tick(items, market, demands, spec):
        prov = KubePACSProvisioner(timer=fake_timer)
        prov.solve_batch = SolveBatch(spec)
        toks = [prov.provision(Request(pods=r, cpu_per_pod=2, mem_per_pod=2),
                               big, precompiled=(items, market))
                for r in demands]
        check(prov.solve_batch.execute() == len(demands), "batch size")
        return [t.resolve() for t in toks], prov.solve_batch.backend

    for items, market, demands, name in ticks:
        (dec_f, be), got = counted(
            lambda: tick(items, market, demands, "torch:fused"))
        tick_split = split()
        dec_n, _ = tick(items, market, demands, NumpyBackend())
        check(dec_f == dec_n and all(
            a.pool.as_dict() == b.pool.as_dict() for a, b in zip(dec_f, dec_n)),
            f"torch:fused fleet tick {name} differs from NumPy")
        fused_ok(be, f"fleet tick {name}", got)
        costs = {spec: [host_cost(lambda s=spec: tick(items, market, demands,
                                                      s), segments)
                        for _ in range(3)]
                 for spec in ("torch:fused", "torch", "numpy")}
        print(f"phase6 fleet tick {name} x {len(demands)} decisions "
              f"torch:fused: launches fused_rows={got[0]} ({tick_split}) "
              f"{got[2]} scoring, standalone score={got[1]}; wall (median "
              "of 3; each call's gc ms / new "
              "device segments) " + " ".join(
                  f"{k} {median([c[0] for c in v]) * 1e3:.3f} ms ("
                  + ", ".join(f"{g:.3f}/{n}" for _w, g, n in v) + ")"
                  for k, v in costs.items())
              + ": equal to NumPy")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"phase6 peak device memory (max_memory_allocated): {peak} B")

    # -- phase 7: where one fused batch's time goes --------------------------
    class Timed(FusedTorchBackend):
        """Synchronises around each device stage: upload, kernels (CUDA
        events), readback; the rest of the wall is host work."""

        def __init__(self, device):
            super().__init__(device)
            self.ms = dict.fromkeys(("verify", "upload", "kernels",
                                     "readback"), 0.0)

        def _decisions(self, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = FusedTorchBackend._decisions(self, *args)
            torch.cuda.synchronize()
            self.ms["upload"] += (time.perf_counter() - t0) * 1e3
            return out

        def _kernel(self, fn, *args, **kw):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(self, *args, **kw)
            end.record()
            end.synchronize()
            self.ms["kernels"] += start.elapsed_time(end)
            return out

        def _rows(self, *args, score_req=None):
            return self._kernel(FusedTorchBackend._rows, *args,
                                score_req=score_req)

        def _to_host(self, *tensors):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = FusedTorchBackend._to_host(*tensors)
            self.ms["readback"] += (time.perf_counter() - t0) * 1e3
            return out

    timed = None
    verify = bmod._FusedGssRecord._verify_sample

    def timed_verify(rec, grid):
        t0 = time.perf_counter()
        try:
            return verify(rec, grid)
        finally:
            timed.ms["verify"] += (time.perf_counter() - t0) * 1e3

    def batch():
        bracketed_gss_many(t_items, t_demands, tolerance=TOLERANCE,
                           market=t_market, timer=fake_timer, backend=timed)

    # five batches, each on a fresh backend; the median batch's breakdown
    bmod._FusedGssRecord._verify_sample = timed_verify
    gc.collect()         # earlier phases' garbage is no part of these batches
    batches = []
    sc.score.launches = 0
    try:
        for _ in range(5):
            timed = Timed(dev)
            wall, *cost = host_cost(batch, segments)
            batches.append((wall * 1e3, timed.ms, *cost))
    finally:
        bmod._FusedGssRecord._verify_sample = verify
    check(sc.score.launches == 0,
          f"phase 7: {sc.score.launches} standalone score launches")
    batches.sort(key=lambda b: b[0])
    wall, ms, gc_ms, segs = batches[len(batches) // 2]
    print(f"phase7 breakdown fused batch tick {t_name}, the median of "
          f"{len(batches)} (walls "
          + " ".join(f"{b[0]:.3f}" for b in batches)
          + f" ms): wall {wall:.3f} ms = host replay and glue "
          f"{wall - sum(ms.values()):.3f} + verify (NumPy) {ms['verify']:.3f}"
          f" + upload {ms['upload']:.3f} + kernels {ms['kernels']:.3f} + "
          f"readback {ms['readback']:.3f} ms; kernel share "
          f"{ms['kernels'] / wall:.4f}; gc {gc_ms:.3f} ms, new device "
          f"segments {segs}")

    err, k_ms, p_ms, b_ms, b_by = rows_rec
    return [
        {"name": "fused_rows", "route": "cuda",
         "variant": "rate-order prefix by histogram selection and a "
                    "shared-memory bitonic sort, two dp rows, the pool "
                    "score in the golden rows' tail, 768 threads",
         "source": "src/repro_torch/csrc/fused_rows.cu",
         "replaces": "src/repro/core/backend.py:635 (_cover_kernel, as "
                     "the fused row solver of _solver_core calls it, "
                     "backend.py:885-1049)",
         "launches": n_rows, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None},
        {"name": "score", "route": "cuda",
         "source": "src/repro_torch/csrc/score.cu",
         "replaces": "src/repro/core/backend.py:847 (_score_kernel)",
         "variant": "score_block of score.cuh; on the main path in the "
                    "tail of fused_rows' golden rows, no launch of its own",
         "launches": n_score, "fused_rows_launches_scoring": n_scoring,
         "rows_scored_in_fused_rows": n_scored,
         "max_abs_err": s_err, "ms": s_ms,
         "plain_ms": sp_ms, "bound_ms": sb_ms, "bound_by": sb_by,
         "library_ms": lib_ms}]


#: (b, sq, skv, h, kv, hd, q_chunk, kv_chunk) of tests/test_kernels.py
ATTN_SHAPES = [(1, 32, 32, 4, 4, 16, 8, 8), (2, 64, 64, 8, 2, 32, 16, 32),
               (1, 128, 128, 6, 6, 64, 64, 32), (2, 48, 48, 4, 1, 16, 16, 16)]
#: (b, s, di, n) of tests/test_kernels.py
MAMBA_SHAPES = [(1, 32, 16, 4), (2, 64, 32, 8), (2, 128, 64, 16)]
#: bfloat16 head dims of the configs with attention (64 internvl2 and
#: musicgen, 80 stablelm, 112 kimi, 128 the rest), held at Sq = Skv = 1000
BF16_HEADS = (64, 80, 112, 128)
#: the kernels' bars (tests/test_kernels.py): attention, scan
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def traced(torch, fn):
    """``(wall ms, device-busy ms, [(kernel, ms), ...])`` of one call of
    ``fn`` under ``torch.profiler``: busy is the sum of the CUDA kernels'
    durations (one stream, so they do not overlap); the wall includes the
    profiler's own host cost."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            key = ev.name[:48]
            by_name[key] = by_name.get(key, 0.0) + ev.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, sum(by_name.values()) / 1e3, [(k, v / 1e3) for k, v in top]


def prompt_len(cfg, prompt) -> int:
    """The positions a prefill of ``prompt`` fills: its tokens (or audio
    frames), after the vision prefix of a VLM prompt."""
    if cfg.input_mode == "audio_codes":
        return prompt["codes"].shape[2]
    vp = cfg.vision_prefix if "vision_embeds" in prompt else 0
    return vp + prompt["tokens"].shape[1]


def step_input(cfg, nxt):
    """A decode step's input from the greedy tokens ``nxt`` ``(B, 1)``
    (``(B, 1, K)`` for audio codes)."""
    if cfg.input_mode == "audio_codes":
        return {"codes": nxt.transpose(1, 2)}
    return {"tokens": nxt}


def greedy(cfg, params, prompt, steps):
    """Prefill ``prompt`` and take ``steps`` greedy decode steps: (the
    logits of every step, the tokens ``(B, steps + 1)``, or ``(B, steps +
    1, K)`` for audio codes)."""
    import torch

    from repro_torch.serving import decode_fn, prefill_fn

    n = prompt_len(cfg, prompt)
    logits, caches = prefill_fn(params, prompt, cfg=cfg, max_len=n + steps)
    outs = [logits]
    nxt = torch.argmax(logits[:, -1:], dim=-1)
    toks = [nxt]
    for i in range(steps):
        logits, caches = decode_fn(params, caches, step_input(cfg, nxt),
                                   n + i, cfg=cfg)
        outs.append(logits)
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        toks.append(nxt)
    return outs, torch.cat(toks, dim=1)


def attn_in_turns(torch, q, k, v):
    """``(kernel ms, SDPA ms, plain ms, turns)`` of causal attention over
    q ``(B,S,H,hd)`` and k, v ``(B,S,KV,hd)``: the kernel and
    ``scaled_dot_product_attention`` (``is_causal``, ``enable_gqa``) in
    turns (kernel, SDPA, SDPA, kernel; the medians of each), then the
    plain version (``flash_fwd_chunked``, one chunk of the sequence)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    s = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    timed = {"kernel": lambda: flash_attention_cuda(q, k, v),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True)}
    turns = {"kernel": [], "sdpa": []}
    for who in ("kernel", "sdpa", "sdpa", "kernel"):
        turns[who].append(cuda_ms(torch, timed[who], 20))
    p_ms = cuda_ms(torch, lambda: ref.flash_fwd_chunked(
        q, k, v, q_chunk=s, kv_chunk=s), 5)
    return median(turns["kernel"]), median(turns["sdpa"]), p_ms, turns


def trace_steps(cfg, params, prompt, tag):
    """Where one prefill of ``prompt`` and one decode step after it spend
    device time, by kernel (``traced``): prints a "``tag`` prefill" and a
    "``tag`` decode step" line, each with the port's own kernels."""
    import torch

    from repro_torch.serving import decode_fn, prefill_fn

    n = prompt_len(cfg, prompt)
    _, caches = prefill_fn(params, prompt, cfg=cfg, max_len=n + 2)
    first = ({"codes": prompt["codes"][:, :, :1]}
             if cfg.input_mode == "audio_codes"
             else {"tokens": prompt["tokens"][:, :1]})
    decode_fn(params, caches, first, n, cfg=cfg)              # warm
    b = next(iter(prompt.values())).shape[0]
    for what, fn in (("prefill", lambda: prefill_fn(
            params, prompt, cfg=cfg, max_len=n + 2)),
                     ("decode step", lambda: decode_fn(
                         params, caches, first, n + 1, cfg=cfg))):
        wall, busy, top = traced(torch, fn)
        ours = [(k, v) for k, v in top if "flash_" in k or "scan_kernel" in k]
        print(f"{tag} {what} (B {b}, S {n}): traced wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.4f});"
              " by kernel: " + "; ".join(f"{k} {v:.3f} ms"
                                          for k, v in top[:6])
              + "; the port's kernels: " + ("; ".join(
                  f"{k} {v:.3f} ms" for k, v in ours) or "none"))


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run_serving(dev) -> list:
    """Phases 8-10 on ``dev``: the serving path; returns the kernel records
    of ``flash_attention`` and ``mamba_scan``."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (VARIANTS,
                                                     flash_attention_cuda)
    from repro_torch.kernels.mamba_scan import (MAX_STATE,
                                                selective_scan_cuda)
    from repro_torch.launch.serve import serve
    from repro_torch.models import count_params, init_params
    from repro_torch.roofline import attn_bound, attn_flops, scan_bound
    from repro_torch.serving import prefill_fn

    scan_variant = "4 lanes a channel, ex2.approx, cp.async ring"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    t_phase = time.perf_counter()

    def on_card(a, dtype):
        return torch.from_numpy(a).to(device=dev, dtype=dtype)

    def err(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0

    def lse_err(a, b):
        check(torch.equal(torch.isneginf(a), torch.isneginf(b)),
              "flash_attention: lse -inf rows differ")
        fin = torch.isfinite(b)
        return err(a[fin], b[fin])

    # -- phase 8: the kernels vs their plain versions on the card -----------
    rng = np.random.default_rng(8)

    def qkv(b, sq, skv, h, kv, hd, dtype):
        return [on_card(rng.normal(size=shape), dtype)
                for shape in ((b, sq, h, hd), (b, skv, kv, hd),
                              (b, skv, kv, hd))]

    def hold_attn(label, tol, q, k, v, qc, kc, **kw):
        o, lse = flash_attention_cuda(q, k, v, **kw)
        o_p, lse_p = ref.flash_fwd_chunked(q, k, v, q_chunk=qc, kv_chunk=kc,
                                           **kw)
        torch.cuda.synchronize()
        e_o, e_l = err(o, o_p), lse_err(lse, lse_p)
        check(o.dtype == q.dtype and e_o <= tol and e_l <= tol,
              f"flash_attention {label}: o err {e_o} lse err {e_l} > {tol}")
        return e_o, e_l

    worst = 0.0
    for dname, dtype in dtypes.items():
        for b, sq, skv, h, kv, hd, qc, kc in ATTN_SHAPES:
            e_o, e_l = hold_attn(f"{(b, sq, h, kv, hd)} {dname}",
                                 ATTN_TOL[dname],
                                 *qkv(b, sq, skv, h, kv, hd, dtype), qc, kc,
                                 causal=True)
            worst = max(worst, e_o, e_l)
        q, k, v = qkv(2, 32, 64, 4, 2, 16, dtype)
        for kw in ({"causal": True, "q_offset": 32, "kv_len": 56},
                   {"causal": True, "q_offset": 8, "kv_len": 24},
                   {"causal": False}, {"causal": False, "kv_len": 0}):
            worst = max(worst, *hold_attn(f"masked {kw} {dname}",
                                          ATTN_TOL[dname], q, k, v, 16, 16,
                                          **kw))
    q, k, v = qkv(1, 1000, 1000, 4, 2, 64, torch.float32)
    o, _ = flash_attention_cuda(q, k, v, causal=True)
    e_r = err(o, ref.attention_naive(q, k, v, causal=True))
    check(e_r <= 2e-5, f"flash_attention ragged S=1000: err {e_r}")
    worst_hd = 0.0
    for hd in BF16_HEADS:
        worst_hd = max(worst_hd, *hold_attn(
            f"bf16 causal prefill hd {hd}", ATTN_TOL["bfloat16"],
            *qkv(2, 1000, 1000, 4, 2, hd, torch.bfloat16), 1000, 1000,
            causal=True))
    print(f"phase8 flash_attention: test shapes x float32/bfloat16, masked "
          f"and non-causal cases in both dtypes within the bars (largest err "
          f"{worst:.3e}); ragged Sq=Skv=1000 float32 vs attention_naive err "
          f"{e_r:.3e}; bfloat16 causal Sq=Skv=1000 at hd {BF16_HEADS} vs the "
          f"plain version: largest err {worst_hd:.3e}")

    shape = (8, 1024, 1024, 16, 8, 128)           # internlm2-1.8b prefill
    q, k, v = qkv(*shape, torch.bfloat16)
    a_err, a_lse = hold_attn("internlm2 prefill", ATTN_TOL["bfloat16"], q, k,
                             v, 1024, 1024, causal=True)
    a_ms, al_ms, ap_ms, turns = attn_in_turns(torch, q, k, v)
    ab_ms, ab_by = attn_bound(*shape, elem=2)
    tflop = attn_flops(*shape) / 1e12
    print(f"phase8 flash_attention ({VARIANTS[q.dtype]}) at the internlm2-1.8b"
          f" prefill (B 8, S 1024, H 16, KV 8, hd 128, bf16): o err "
          f"{a_err:.3e} lse err {a_lse:.3e}; kernel {a_ms:.4f} ms (turns "
          f"{turns['kernel']}) {tflop / a_ms * 1e3:.1f} TFLOP/s "
          f"{ab_ms / a_ms:.2%} of bound; scaled_dot_product_attention "
          f"{al_ms:.4f} ms (turns {turns['sdpa']}) {tflop / al_ms * 1e3:.1f} "
          f"TFLOP/s {ab_ms / al_ms:.2%} of bound; kernel / SDPA "
          f"{a_ms / al_ms:.3f}; plain {ap_ms:.4f} ms; bound {ab_ms:.6f} ms "
          f"({ab_by})")
    del q, k, v

    def scan_inputs(b, s, di, n, dtype, model_like=False, with_h0=False):
        if model_like:      # as falcon-mamba's layers feed it at init
            xr = rng.normal(size=(b, s, di))
            x = xr / (1 + np.exp(-xr))
            dt = np.log1p(np.exp(-4.6 + 0.5 * rng.normal(size=(b, s, di))))
            A = -np.broadcast_to(np.arange(1, n + 1), (di, n)).copy()
            D = np.ones(di)
        else:               # as tests/test_kernels.py draws them
            x = rng.normal(size=(b, s, di))
            dt = rng.uniform(0.001, 0.1, size=(b, s, di))
            A = -rng.uniform(0.5, 2.0, size=(di, n))
            D = rng.normal(size=(di,))
        Bm = rng.normal(size=(b, s, n))
        Cm = rng.normal(size=(b, s, n))
        h0 = rng.normal(size=(b, di, n)) if with_h0 else None
        return (on_card(x, dtype), on_card(dt, dtype),
                on_card(A, torch.float32), on_card(Bm, dtype),
                on_card(Cm, dtype), on_card(D, torch.float32),
                None if h0 is None else on_card(h0, torch.float32))

    def hold_scan(label, tol, args, want=None):
        *xs, h0 = args
        y, h = selective_scan_cuda(*xs, h0=h0)
        y_p, h_p = want or ref.selective_scan_ref(*xs, h0=h0)
        torch.cuda.synchronize()
        e_y, e_h = err(y, y_p), err(h, h_p)
        check(y.dtype == xs[0].dtype and e_y <= tol and e_h <= tol,
              f"mamba_scan {label}: y err {e_y} h err {e_h} > {tol}")
        return e_y, e_h

    worst = 0.0
    for dname, dtype in dtypes.items():
        for b, s, di, n in MAMBA_SHAPES:
            worst = max(worst, *hold_scan(f"{(b, s, di, n)} {dname}",
                                          SCAN_TOL[dname],
                                          scan_inputs(b, s, di, n, dtype)))
    worst = max(worst, *hold_scan("with h0", 1e-4, scan_inputs(
        2, 64, 32, 8, torch.float32, with_h0=True)))
    # every N, with S = 1000 (ragged chunks) and di 64-70 (a ragged channel
    # tile; 16-byte cp.async granules only where di and N allow them), an
    # initial state, float32 at even N and bfloat16 at odd N
    worst_n = 0.0
    for n in range(1, MAX_STATE + 1):
        dname = "float32" if n % 2 == 0 else "bfloat16"
        worst_n = max(worst_n, *hold_scan(
            f"N {n} S 1000 {dname}", SCAN_TOL[dname], scan_inputs(
                2, 1000, 64 + 2 * (n % 4), n, dtypes[dname], with_h0=True)))
    print(f"phase8 mamba_scan: test shapes x float32/bfloat16 and an initial "
          f"state within the bars (largest err {worst:.3e}); N = 1..16 at "
          f"S 1000, di 64-70, with h0 (float32 at even N, bfloat16 at odd): "
          f"largest err {worst_n:.3e}")
    sshape = (4, 1024, 8192, 16)                  # falcon-mamba-7b prefill
    sargs = scan_inputs(*sshape, torch.bfloat16, model_like=True)
    s_want = ref.selective_scan_ref(*sargs[:6])
    s_err, s_herr = hold_scan("falcon-mamba prefill", SCAN_TOL["bfloat16"],
                              sargs, s_want)
    s_ms = cuda_ms(torch, lambda: selective_scan_cuda(*sargs[:6]), 20)
    sp_ms = cuda_ms(torch, lambda: ref.selective_scan_ref(*sargs[:6]), 2)
    sb_ms, sb_by = scan_bound(*sshape, elem=2)
    print(f"phase8 mamba_scan ({scan_variant}) at the falcon-mamba-7b prefill "
          f"(B 4, S 1024, di 8192, N 16, bf16): y err {s_err:.3e} h_final "
          f"err {s_herr:.3e}; kernel {s_ms:.4f} ms {sb_ms / s_ms:.2%} of "
          f"bound; plain (sequential) {sp_ms:.4f} ms library none bound "
          f"{sb_ms:.6f} ms ({sb_by})")
    del sargs
    print(f"phase8 took {time.perf_counter() - t_phase:.1f} s")

    # -- phase 9: serve at full width and depth ------------------------------
    t_phase = time.perf_counter()
    n_flash = n_scan = 0

    def served(cfg, params, label, **kw):
        nonlocal n_flash, n_scan
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        flash_attention_cuda.launches = selective_scan_cuda.launches = 0
        out = serve(cfg, params, seed=0, device=dev, **kw)
        got = (flash_attention_cuda.launches, selective_scan_cuda.launches)
        n_flash += got[0]
        n_scan += got[1]
        n_batches = len(out["batches"])
        attn = sum(spec.mixer == "attn" for spec in cfg.layout)
        want = (attn * n_batches, (cfg.n_layers - attn) * n_batches)
        check(out["served"] == kw["requests"], f"{label}: served {out}")
        check(out["all_finite"], f"{label}: a logit is not finite")
        check(got == want and sum(got) > 0,
              f"{label}: launches (flash, scan) {got}, expected {want}")
        shapes = {t.shape for t in out["tokens"]}
        bs = out["batches"]
        print(f"phase9 serve {label}: {kw}; batches "
              f"{[b['batch'] for b in bs]} padded "
              f"{[b['padded'] for b in bs]}; launches flash_attention="
              f"{got[0]} mamba_scan={got[1]}; prefill ms "
              f"{[round(b['prefill_s'] * 1e3, 3) for b in bs]}; decode ms a "
              f"step {[round(b['decode_s'] * 1e3 / kw['new_tokens'], 3) for b in bs]}"
              f"; tok/s {out['throughput_tok_s']}; wall {out['wall_s']} s; "
              f"peak device memory {torch.cuda.max_memory_allocated(dev)} B;"
              f" tokens {sorted(shapes)} all logits finite")

    def breakdown(cfg, params, label, B, S):
        trace_steps(cfg, params, {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S))).to(dev)}, f"phase9 trace {label}")

    cfg = get_config("internlm2-1.8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    check(count_params(cfg) == 1_889_110_016, "internlm2 parameter count")
    served(cfg, params, "internlm2-1.8b", requests=16, batch=8,
           prompt_len=1024, new_tokens=32)
    served(cfg, params, "internlm2-1.8b partial batch", requests=5, batch=4,
           prompt_len=512, new_tokens=8)
    breakdown(cfg, params, "internlm2-1.8b", 8, 1024)
    del params
    release(torch)
    cfg = get_config("falcon-mamba-7b")
    params = init_params(cfg, gen.manual_seed(1), dev)
    check(count_params(cfg) == 7_272_665_088, "falcon-mamba parameter count")
    served(cfg, params, "falcon-mamba-7b", requests=8, batch=4,
           prompt_len=1024, new_tokens=16)
    breakdown(cfg, params, "falcon-mamba-7b", 4, 1024)
    del params
    release(torch)
    print(f"phase9 took {time.perf_counter() - t_phase:.1f} s")

    # -- phase 10: the slice held on the card --------------------------------
    t_phase = time.perf_counter()

    for seed, arch in enumerate(("internlm2-1.8b", "falcon-mamba-7b")):
        full = get_config(arch)
        cfg = dataclasses.replace(full, dtype="float32", n_layers=2,
                                  layout=full.layout[:2])
        params = init_params(cfg, gen.manual_seed(10 + seed), dev)
        prompt = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 256))).to(dev)}
        flash_attention_cuda.launches = selective_scan_cuda.launches = 0
        outs_k, toks_k = greedy(cfg, params, prompt, 4)
        check(flash_attention_cuda.launches + selective_scan_cuda.launches
              == 2, f"{arch} 2-layer: kernels not launched")
        outs_p, toks_p = greedy(dataclasses.replace(cfg,
                                                    attention_impl="chunked"),
                                params, prompt, 4)
        check(flash_attention_cuda.launches + selective_scan_cuda.launches
              == 2, f"{arch} 2-layer: the plain run launched a kernel")
        diff = max(err(a, b) for a, b in zip(outs_k, outs_p))
        check(diff <= 2e-4, f"{arch} 2-layer f32: logits differ by {diff}")
        check(torch.equal(toks_k, toks_p), f"{arch} 2-layer f32: tokens "
              f"differ {toks_k.tolist()} vs {toks_p.tolist()}")
        del params
        release(torch)

        params = init_params(full, gen.manual_seed(20 + seed), dev)
        prompt = {"tokens": torch.from_numpy(rng.integers(
            0, full.vocab_size, (2, 1024))).to(dev)}
        n_k = flash_attention_cuda.launches + selective_scan_cuda.launches
        lk, _ = prefill_fn(params, prompt, cfg=full, max_len=1024)
        lp, _ = prefill_fn(params, prompt, cfg=dataclasses.replace(
            full, attention_impl="chunked"), max_len=1024)
        check(flash_attention_cuda.launches + selective_scan_cuda.launches
              == n_k + full.n_layers, f"{arch} full depth: launches")
        bf_diff = err(lk, lp)
        same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
        del params, lk, lp
        release(torch)
        print(f"phase10 {arch}: 2-layer float32 cut at full width, prefill "
              f"(B 2, S 256) + 4 greedy decode steps, kernels vs plain "
              f"versions: max logit diff {diff:.3e} (bar 2e-4), tokens equal "
              f"{toks_k.tolist()}; full depth bfloat16 prefill (B 2, S 1024):"
              f" max logit diff {bf_diff:.4f}, argmax agreement {same:.4f} "
              f"(reported, not held)")
    print(f"phase10 took {time.perf_counter() - t_phase:.1f} s")

    return [
        {"name": "flash_attention", "route": "cuda",
         "variant": VARIANTS[torch.bfloat16],
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:26 "
                     "(_flash_kernel; pallas_call at :100)",
         "launches": n_flash, "max_abs_err": a_err, "ms": a_ms,
         "plain_ms": ap_ms, "bound_ms": ab_ms, "bound_by": ab_by,
         "library_ms": al_ms},
        {"name": "mamba_scan", "route": "cuda", "variant": scan_variant,
         "source": "src/repro_torch/csrc/mamba_scan.cu",
         "replaces": "src/repro/kernels/mamba_scan.py:23 "
                     "(_scan_kernel; pallas_call at :65)",
         "launches": n_scan, "max_abs_err": s_err, "ms": s_ms,
         "plain_ms": sp_ms, "bound_ms": sb_ms, "bound_by": sb_by,
         "library_ms": None}]


class LaunchTimer:
    """CUDA events around every launch of the decision-plane kernels (the
    names the backends call), so a fleet's wall can be split into device
    kernel time and the rest without synchronising inside the run."""

    def __init__(self, torch):
        from repro_torch.core import backend as bmod
        self.torch, self.bmod = torch, bmod
        self.pairs = []

    def _wrap(self, fn):
        torch = self.torch

        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            self.pairs.append((start, end))
            return out
        return timed

    def __enter__(self):
        self.saved = (self.bmod.cover_dp, self.bmod.fused_rows)
        self.bmod.cover_dp = self._wrap(self.saved[0])
        self.bmod.fused_rows = self._wrap(self.saved[1])
        self.pairs = []
        return self

    def __exit__(self, *exc):
        self.bmod.cover_dp, self.bmod.fused_rows = self.saved

    def ms(self) -> float:
        self.torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


class SimDriver:
    """Runs a simulation with the process default set for a backend spec
    (the card's ``torch`` for the device runs, ``numpy`` for the host
    reference), counting each kernel's launches, timing the kernels (CUDA
    events around every launch) and the fleet's batched searches (their
    widths and wall)."""

    def __init__(self, torch, phase: str):
        from repro_torch.core import backend as bmod
        from repro_torch.core import cover_dp as cdp
        from repro_torch.core import fused_rows as fr
        from repro_torch.core import provisioner as pmod
        from repro_torch.core import score as sc
        self.torch, self.phase = torch, phase
        self.bmod, self.cdp, self.fr, self.pmod, self.sc = (bmod, cdp, fr,
                                                            pmod, sc)
        self.counts = collections.Counter()
        self.widths = []
        self.search_s = 0.0
        self.gss_many = pmod.bracketed_gss_many

    def _counted_many(self, items, reqs, **kw):
        """A fleet's batched search: its width and its wall (the solve of
        every collected decision, host replay and verification included)."""
        self.widths.append(len(reqs))
        t0 = time.perf_counter()
        try:
            return self.gss_many(items, reqs, **kw)
        finally:
            self.search_s += time.perf_counter() - t0

    def launches(self):
        return (self.cdp.cover_dp.launches, self.fr.fused_rows.launches,
                self.sc.score.launches)

    def drive(self, spec, run_fn, label):
        """Run ``run_fn`` under ``spec``; returns (its result, wall s,
        launch deltas (cover_dp, fused_rows, score), kernel ms)."""
        torch, bmod = self.torch, self.bmod
        saved = bmod._DEFAULT
        bmod.set_backend("numpy" if spec == "numpy" else "torch")
        self.widths.clear()
        self.search_s = 0.0
        gc.collect()
        self.pmod.bracketed_gss_many = self._counted_many
        self.cdp.cover_dp.launches = self.fr.fused_rows.launches = 0
        self.sc.score.launches = 0
        try:
            with LaunchTimer(torch) as lt:
                t0 = time.perf_counter()
                out = run_fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                k_ms = lt.ms()
        finally:
            self.pmod.bracketed_gss_many = self.gss_many
            bmod._DEFAULT = saved
        got = self.launches()
        self.counts["cover_dp"] += got[0]
        self.counts["fused_rows"] += got[1]
        self.counts["score"] += got[2]
        check(got[2] == 0, f"{self.phase} {label} {spec}: {got[2]} "
              "standalone score launches")
        if spec == "numpy":
            check(got[:2] == (0, 0), f"{self.phase} {label} numpy launched "
                  f"kernels {got}")
        return out, wall, got, k_ms


def outcome(results):
    """What a run must equal byte for byte: each replica's trace, decision
    records, float totals and its policy's ``chaos_*`` counters."""
    return [(r.recorder.dumps(), r.decision_records(), r.total_cost,
             r.total_perf_hours, r.total_egress, r.interrupted_nodes,
             sorted((k, v) for k, v in r.cache_stats.items()
                    if k.startswith("chaos_")))
            for r in results]


def fleet_in_turns(drv, name, scenario, replicas, specs):
    """``FleetSim`` of ``scenario`` over ``replicas`` interrupt seeds, traces
    recorded, through ``numpy`` and each of ``specs`` in turns (numpy,
    specs, specs reversed, numpy) under ``drv`` (a :class:`SimDriver`):
    every run equal to the first numpy run's, no fused fallback solve,
    ``fused_rows`` launched by every ``torch:fused`` run and ``cover_dp``
    by every ``torch`` run; prints a line a run and the replicas/s in
    turns.  Returns ``(spec, launch deltas)`` of each run."""
    from repro_torch.sim import FleetSim

    seeds = list(range(replicas))
    ref = None
    rates = collections.defaultdict(list)
    runs = []
    for spec in ("numpy", *specs, *reversed(specs), "numpy"):
        sims = []

        def go():
            sim = FleetSim(scenario, seeds, record_traces=True, backend=spec)
            sims.append(sim)
            return sim.run()

        results, wall, got, k_ms = drv.drive(spec, go, name)
        stats = sims[0].stats()
        out = outcome(results)
        if ref is None:
            ref = out
        else:
            check(out == ref, f"{drv.phase} {name} fleet {spec}: a replica "
                  "differs from the numpy fleet's")
        if spec == "torch:fused":
            check(stats["device_cache_fallback_solves"] == 0,
                  f"{drv.phase} {name} fleet: fallback solves {stats}")
            check(got[1] > 0, f"{drv.phase} {name} fleet: no fused_rows "
                  "launch")
        if spec == "torch":
            check(got[0] > 0, f"{drv.phase} {name} fleet: no cover_dp "
                  "launch")
        runs.append((spec, got))
        rates[spec].append(replicas / wall)
        lookups = stats["memo_hits"] + stats["memo_misses"]
        ws = sorted(drv.widths)
        cache = ("" if "device_cache_misses" not in stats else
                 f"; device-market cache hits "
                 f"{stats['device_cache_hits']} misses "
                 f"{stats['device_cache_misses']} fallback solves "
                 f"{stats['device_cache_fallback_solves']} verify solves "
                 f"{stats['device_cache_verify_solves']} fused records "
                 f"{sims[0].solve_batch.backend.fused_records}")
        print(f"{drv.phase} fleet {name} {spec}: {replicas} replicas x "
              f"{stats['ticks']} ticks, wall {wall:.3f} s, "
              f"{replicas / wall:.2f} replicas/s; memo hit rate "
              f"{stats['memo_hits'] / max(lookups, 1):.4f} "
              f"({stats['memo_hits']} hits, {stats['memo_misses']} "
              f"misses); compiled markets {stats['compile_misses']} "
              f"(hits {stats['compile_hits']}); batched searches "
              f"{len(ws)}, widths min/median/"
              f"max {ws[0] if ws else 0}/{ws[len(ws) // 2] if ws else 0}/"
              f"{ws[-1] if ws else 0}, decisions {sum(ws)}, their wall "
              f"{drv.search_s:.3f} s ({drv.search_s / wall:.4f}); "
              f"launches "
              f"cover_dp {got[0]} fused_rows {got[1]} score {got[2]}; "
              f"kernels {k_ms:.3f} ms, share of wall "
              f"{k_ms / 1e3 / wall:.4f}{cache}"
              + (": equal to numpy" if out is not ref else ""))
    print(f"{drv.phase} fleet {name} replicas/s in turns: " + "; ".join(
        f"{spec} " + ", ".join(f"{r:.2f}" for r in rs)
        for spec, rs in rates.items()))
    return runs


def run_sim(dev) -> dict:
    """Phase 11 on ``dev``: the simulation layer at ``bench_fleet``'s
    full-run sizes; returns each kernel's launches on this path."""
    import torch

    from repro_torch.risk.backtest import (interrupt_storm_scenario,
                                           pressure_crunch_scenario)
    from repro_torch.serve_sim import clear_caches
    from repro_torch.sim import (ClusterSim, heterogeneous_demand_scenario,
                                 serving_scenario)

    t_phase = time.perf_counter()
    drv = SimDriver(torch, "phase11")
    counts, drive = drv.counts, drv.drive

    def standalone(name, scenario):
        ref = None
        for spec in ("numpy", "torch"):
            res, wall, got, k_ms = drive(
                spec, lambda: [ClusterSim(scenario).run()], name)
            out = outcome(res)
            if ref is None:
                ref = out
            else:
                check(out == ref, f"phase11 {name} ClusterSim: trace differs "
                      "from numpy's")
                check(got[0] > 0, f"phase11 {name} ClusterSim: no cover_dp "
                      "launch")
            print(f"phase11 ClusterSim {name} default {spec}: "
                  f"{len(res[0].decisions)} decisions, wall {wall:.3f} s; "
                  f"launches cover_dp {got[0]} fused_rows {got[1]}; kernels "
                  f"{k_ms:.3f} ms, share of wall {k_ms / 1e3 / wall:.4f}"
                  + (": equal to numpy" if spec != "numpy" else ""))

    fleet_in_turns(drv, "hetero",
                   heterogeneous_demand_scenario(max_offerings=250), 128,
                   ("torch:fused", "torch"))
    fleet_in_turns(drv, "storm", interrupt_storm_scenario(max_offerings=250),
                   256, ("torch:fused",))
    fleet_in_turns(drv, "crunch",
                   pressure_crunch_scenario(max_offerings=250), 256,
                   ("torch:fused",))
    standalone("storm", interrupt_storm_scenario(max_offerings=250))
    saved_mode = os.environ.get("KUBEPACS_SERVE_PERF")
    os.environ["KUBEPACS_SERVE_PERF"] = "analytic"
    clear_caches()
    try:
        standalone("serving diurnal", serving_scenario("diurnal"))
    finally:
        if saved_mode is None:
            del os.environ["KUBEPACS_SERVE_PERF"]
        else:
            os.environ["KUBEPACS_SERVE_PERF"] = saved_mode
        clear_caches()
    print(f"phase11 launches on the sim path: {dict(counts)}; took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(counts)


def run_policies(dev) -> dict:
    """Phase 12 on ``dev``: the hardened, regional and serving policies at
    their benchmarks' sizes (``benchmarks/bench_chaos.py``,
    ``bench_region.py``, ``bench_serve.py``, parameters copied), each run in
    turns through ``numpy`` and the device backends; returns each kernel's
    launches on this path."""
    import torch

    from repro_torch.chaos import SOLVER_KINDS, fault_storm, region_storm
    from repro_torch.region import RegionConfig
    from repro_torch.serve_sim import (build_serve_scenario, clear_caches,
                                       run_serving)
    from repro_torch.sim import FleetSim, Scenario
    from repro_torch.sim import engine as engine_mod

    t_phase = time.perf_counter()
    drv = SimDriver(torch, "phase12")
    home = "us-east-1"
    seeds = [3, 7, 11]

    def chaos_scenario(storm, policy):          # bench_chaos.py:62-75
        return Scenario(
            name=f"chaos_{storm or 'clean'}", duration_hours=48.0,
            step_hours=3.0, pods=160,
            demand_schedule=((12.0, 220), (24.0, 140)),
            interrupt_model="pressure", policy=policy,
            catalog_seed=7, max_offerings=150, market_seed=7,
            interrupt_seed=7, faults=fault_storm(storm) if storm else ())

    def region_scenario(policy, shock_seed=11):  # bench_region.py:66-86
        return Scenario(
            name="region_storm", duration_hours=48.0, step_hours=3.0,
            pods=160, demand_schedule=((12.0, 220), (24.0, 140)),
            interrupt_model="pressure", policy=policy,
            catalog_seed=7, max_offerings=200, market_seed=7,
            interrupt_seed=7,
            region=RegionConfig(regions=("us-east-1", "us-west-2",
                                         "eu-west-1"),
                                rho=0.7, vol=0.25, shock_seed=shock_seed,
                                home_region=home, egress_per_pod_hour=0.002),
            faults=region_storm(home))

    def ladder(results, key):
        return sum(r.cache_stats.get(key, 0) for r in results)

    def in_turns(label, scenarios, kernel, specs, run_fn, n_replicas):
        """``run_fn(scenarios, spec)`` -> (results, fleet stats or None) for
        each spec in ``("numpy", *specs, "numpy")``; every run equal to the
        first numpy run's (traces, decision records, totals, ladder
        counters); ``kernel(spec)`` names the launch count (0 cover_dp, 1
        fused_rows) that must be positive on a device run, or None for a
        policy that never solves; returns the first run's results."""
        ref = first = None
        rates = collections.defaultdict(list)
        for spec in ("numpy", *specs, "numpy"):
            (results, stats), wall, got, k_ms = drv.drive(
                spec, lambda: run_fn(scenarios, spec), label)
            out = outcome(results)
            if ref is None:
                ref, first = out, results
            else:
                check(out == ref, f"phase12 {label} {spec}: a replica "
                      "differs from the numpy run's")
            if spec == "torch:fused" and stats is not None:
                check(stats.get("device_cache_fallback_solves", 0) == 0,
                      f"phase12 {label}: fallback solves {stats}")
            if spec != "numpy" and kernel(spec) is not None:
                check(got[kernel(spec)] > 0,
                      f"phase12 {label} {spec}: launches {got}")
            rates[spec].append(n_replicas / wall)
            print(f"phase12 {label} {spec}: {n_replicas} runs, wall "
                  f"{wall:.3f} s, {n_replicas / wall:.2f} replicas/s; "
                  f"launches cover_dp {got[0]} fused_rows {got[1]} score "
                  f"{got[2]}; kernels {k_ms:.3f} ms, share of wall "
                  f"{k_ms / 1e3 / wall:.4f}"
                  + ("" if spec == "numpy" else ": equal to numpy"))
        print(f"phase12 {label} replicas/s in turns: " + "; ".join(
            f"{spec} " + ", ".join(f"{r:.2f}" for r in rs)
            for spec, rs in rates.items()))
        return first

    def fleet(scenario, spec):
        sim = FleetSim(scenario, seeds, record_traces=True, backend=spec)
        return sim.run(), sim.stats()

    def paths(scenarios, spec):
        results, stats = [], {}
        for sc in scenarios:
            sim = FleetSim(sc, seeds, record_traces=True, backend=spec)
            results.extend(sim.run())
            for k, v in sim.stats().items():
                stats[k] = stats.get(k, 0) + v
        return results, stats

    # -- chaos: the combined storm, then the clean inertness pair ----------
    clean = {}
    for storm in ("combined", None):
        for policy in ("hardened", "kubepacs"):
            sc = chaos_scenario(storm, policy)
            # a hardened fleet solves inline (cover_dp); a kubepacs fleet
            # batches its decisions (fused_rows under torch:fused)
            kernel = ((lambda spec: 0) if policy == "hardened" else
                      (lambda spec: 1 if spec == "torch:fused" else 0))
            res = in_turns(f"chaos {storm or 'clean'} {policy}", sc, kernel,
                           ("torch:fused", "torch"), fleet, len(seeds))
            solver_faults = any(f.kind in SOLVER_KINDS for f in sc.faults)
            if policy == "hardened":
                check((ladder(res, "chaos_solver_rung_1") > 0)
                      == solver_faults, f"phase12 chaos {storm} hardened: "
                      "the numpy rung served where no solver fault was")
                print(f"phase12 chaos {storm or 'clean'} hardened ladder: "
                      + ", ".join(f"{k} {ladder(res, k)}" for k in sorted(
                          {k for r in res for k in r.cache_stats
                           if k.startswith("chaos_")})))
            if storm is None:
                clean[policy] = res
    for h, k in zip(clean["hardened"], clean["kubepacs"]):
        check(h.recorder.dumps().replace('"policy": "hardened"',
                                         '"policy": "kubepacs"')
              == k.recorder.dumps(), "phase12 chaos: hardened is not inert "
              "without faults")
        check(not any(key.startswith("chaos_") for key in h.cache_stats),
              "phase12 chaos clean: ladder counters without faults")

    # -- region: the regional storm over two correlated market paths -------
    for policy in ("hardened", f"region_pinned:{home}", "kubepacs_region"):
        scs = [region_scenario(policy, shock) for shock in (11, 23)]
        res = in_turns(f"region {policy}", scs, lambda spec: 0,
                       ("torch:fused", "torch"), paths, 2 * len(seeds))
        check(ladder(res, "chaos_solver_rung_1") == 0,
              f"phase12 region {policy}: the numpy rung served")
        if policy == "hardened":
            check(ladder(res, "chaos_region_failover") > 0,
                  "phase12 region hardened: no failover")

    # -- serving: bench_serve's five policies on the diurnal workload ------
    saved_mode = os.environ.get("KUBEPACS_SERVE_PERF")
    os.environ["KUBEPACS_SERVE_PERF"] = "analytic"
    base_sim = engine_mod.ClusterSim
    kept = []

    class KeptSim(base_sim):
        """``run_serving``'s engine, keeping its result for the trace."""

        def run(self):
            kept.append(super().run())
            return kept[-1]

    def serving(ss, spec):
        clear_caches()
        kept.clear()
        engine_mod.ClusterSim = KeptSim
        try:
            report = run_serving(ss, clock=lambda: 0.0)
        finally:
            engine_mod.ClusterSim = base_sim
        reports.append((json.dumps(report.as_dict(), sort_keys=True),
                        report))
        return list(kept), None

    try:
        for policy in ("serving_slo", "karpenter_like", "kubepacs",
                       "fixed_alpha:0.5", "kubepacs_risk"):
            reports = []
            ss = build_serve_scenario("diurnal", policy=policy,
                                      duration_hours=24.0)
            # serving_slo must reach the card; karpenter_like is a greedy
            # and fixed_alpha's one decision may settle without a DP
            held = policy == "serving_slo"
            in_turns(f"serve diurnal {policy}", ss,
                     lambda spec: 0 if held else None, ("torch",),
                     serving, 1)
            check(len({text for text, _ in reports}) == 1,
                  f"phase12 serve {policy}: ServeReport differs from "
                  "numpy's")
            rep = reports[0][1]
            print(f"phase12 serve diurnal {policy}: reports equal; "
                  f"decisions {rep.decisions}, SLO attainment "
                  f"{rep.slo_attainment:.6f}, SLO QPS-hours a dollar "
                  f"{rep.slo_qps_hours_per_dollar:.4f}, cost "
                  f"{rep.total_cost:.4f}")
    finally:
        if saved_mode is None:
            del os.environ["KUBEPACS_SERVE_PERF"]
        else:
            os.environ["KUBEPACS_SERVE_PERF"] = saved_mode
        clear_caches()
    print(f"phase12 launches on the policy paths: {dict(drv.counts)}; took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return dict(drv.counts)


def run_moe(dev) -> dict:
    """Phase 13 on ``dev``: ``qwen3-moe-30b-a3b`` served at full width;
    returns the GQA-8 ``flash_attention`` readings and its launches."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.serve import serve
    from repro_torch.models import active_params, count_params, init_params
    from repro_torch.roofline import attn_bound, attn_flops

    t_phase = time.perf_counter()
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=dev)
    full = get_config("qwen3-moe-30b-a3b")
    check(count_params(full) == 30_532_110_336, "qwen3-moe parameter count")

    # flash_attention at the prefill's shape: GQA 32/4 = 8, bf16
    shape = (4, 1024, 1024, 32, 4, 128)
    q, k, v = (torch.from_numpy(rng.normal(size=sh)).to(
        device=dev, dtype=torch.bfloat16) for sh in (
            (4, 1024, 32, 128), (4, 1024, 4, 128), (4, 1024, 4, 128)))
    o, lse = flash_attention_cuda(q, k, v, causal=True)
    o_p, lse_p = ref.flash_fwd_chunked(q, k, v, q_chunk=1024, kv_chunk=1024,
                                       causal=True)
    a_err = float((o.float() - o_p.float()).abs().max())
    l_err = float((lse - lse_p).abs().max())
    check(a_err <= ATTN_TOL["bfloat16"] and l_err <= ATTN_TOL["bfloat16"],
          f"phase13 flash_attention GQA-8: o err {a_err} lse err {l_err}")
    a_ms, al_ms, ap_ms, turns = attn_in_turns(torch, q, k, v)
    ab_ms, ab_by = attn_bound(*shape, elem=2)
    tflop = attn_flops(*shape) / 1e12
    print(f"phase13 flash_attention at the qwen3-moe-30b-a3b prefill (B 4, "
          f"S 1024, H 32, KV 4, hd 128, bf16, GQA 8): o err {a_err:.3e} lse "
          f"err {l_err:.3e}; kernel {a_ms:.4f} ms (turns {turns['kernel']}) "
          f"{tflop / a_ms * 1e3:.1f} TFLOP/s {ab_ms / a_ms:.2%} of bound; "
          f"scaled_dot_product_attention {al_ms:.4f} ms (turns "
          f"{turns['sdpa']}); kernel / SDPA {a_ms / al_ms:.3f}; plain "
          f"{ap_ms:.4f} ms; bound {ab_ms:.6f} ms ({ab_by})")
    del q, k, v, o, o_p
    release(torch)

    # the slice held on the card: a 2-layer float32 cut at full width
    cfg = dataclasses.replace(full, dtype="float32", n_layers=2,
                              layout=full.layout[:2])
    params = init_params(cfg, gen.manual_seed(31), dev)
    prompt = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (2, 256))).to(dev)}
    flash_attention_cuda.launches = 0
    outs_k, toks_k = greedy(cfg, params, prompt, 4)
    check(flash_attention_cuda.launches == 2,
          "phase13 2-layer: flash_attention not launched")
    outs_p, toks_p = greedy(dataclasses.replace(cfg, attention_impl="chunked"),
                            params, prompt, 4)
    check(flash_attention_cuda.launches == 2,
          "phase13 2-layer: the plain run launched a kernel")
    diff = max(float((a - b).abs().max()) for a, b in zip(outs_k, outs_p))
    check(all(bool(torch.isfinite(a).all()) for a in outs_k),
          "phase13 2-layer: a logit is not finite")
    check(diff <= 2e-4, f"phase13 2-layer f32: logits differ by {diff}")
    check(torch.equal(toks_k, toks_p), f"phase13 2-layer f32: tokens differ "
          f"{toks_k.tolist()} vs {toks_p.tolist()}")
    print(f"phase13 qwen3-moe-30b-a3b: 2-layer float32 cut at full width, "
          f"prefill (B 2, S 256) + 4 greedy decode steps, kernels vs plain "
          f"attention: max logit diff {diff:.3e} (bar 2e-4), tokens equal "
          f"{toks_k.tolist()}")
    del params, outs_k, outs_p
    release(torch)

    # serve at full width, depth cut to what one card holds in float32
    layers = 24
    cfg = dataclasses.replace(full, n_layers=layers,
                              layout=full.layout[:layers])
    t0 = time.perf_counter()
    params = init_params(cfg, gen.manual_seed(30), dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention_cuda.launches = 0
    out = serve(cfg, params, requests=8, batch=4, prompt_len=1024,
                new_tokens=16, seed=0, device=dev)
    n_flash = flash_attention_cuda.launches
    peak = torch.cuda.max_memory_allocated(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    bs = out["batches"]
    check(out["served"] == 8, f"phase13 serve: served {out['served']}")
    check(out["all_finite"], "phase13 serve: a logit is not finite")
    check(n_flash == layers * len(bs),
          f"phase13 serve: {n_flash} flash_attention launches, expected "
          f"{layers * len(bs)}")
    check(peak < total, f"phase13 serve: peak {peak} B over {total} B")
    print(f"phase13 serve qwen3-moe-30b-a3b ({card_line()}): full width, "
          f"{layers} of {full.n_layers} layers ({count_params(cfg)} params, "
          f"{active_params(cfg)} active a token, float32, drawn on the card "
          f"in {t_init:.1f} s); 8 requests, batch 4, prompt 1024, 16 new "
          f"tokens; launches flash_attention={n_flash}; prefill ms "
          f"{[round(b['prefill_s'] * 1e3, 3) for b in bs]}; decode ms a step "
          f"{[round(b['decode_s'] * 1e3 / 16, 3) for b in bs]}; tok/s "
          f"{out['throughput_tok_s']}; wall {out['wall_s']} s; peak device "
          f"memory {peak} B of {total} B; all logits finite")
    # where one prefill and one decode step of a batch spend device time
    trace_steps(cfg, params, {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (4, 1024))).to(dev)},
        "phase13 trace qwen3-moe-30b-a3b")
    del params
    release(torch)
    print(f"phase13 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": n_flash, "max_abs_err": a_err, "ms": a_ms,
            "plain_ms": ap_ms, "bound_ms": ab_ms, "bound_by": ab_by,
            "library_ms": al_ms}


#: phase 14: the elastic trainer's market, request and ElasticConfig; its
#: ``market_hours_per_check`` of 2 h fires two interrupts, at steps 3 and 12
#: (8 h would add a straggler and two more recoveries of a 6 GB
#: checkpoint; the smoke twin of both runs on the host in
#: tests/test_torch_elastic.py)
ELASTIC_MARKET_SEED = 7
ELASTIC = dict(total_steps=12, ckpt_every=12, market_check_every=3,
               market_hours_per_check=2.0, batch_rows=4, seq_len=1024,
               keep_checkpoints=1)


@contextlib.contextmanager
def timed_checkpoints(torch, walls):
    """Host seconds of every ``save_checkpoint`` / ``restore_checkpoint``
    call (the trainer's, through the module), into ``walls["save"]`` and
    ``walls["restore"]``; a restore is timed to the end of its copies to
    the card."""
    from repro_torch.train import checkpoint as ckpt

    saved = ckpt.save_checkpoint, ckpt.restore_checkpoint

    def timed(kind, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
            return out
        return call

    ckpt.save_checkpoint = timed("save", saved[0])
    ckpt.restore_checkpoint = timed("restore", saved[1])
    try:
        yield walls
    finally:
        ckpt.save_checkpoint, ckpt.restore_checkpoint = saved


def rel_max(a, b) -> float:
    """``max |a - b|`` over ``max(1, max |b|)``: absolute for values up to
    1, relative to the largest magnitude beyond (a bf16 gradient of
    magnitude m rounds by up to m / 256)."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def rel_largest(a, b) -> float:
    """``max |a - b|`` over the largest magnitude of ``b``."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def train_flops(cfg, tokens: int, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 x active parameters (a token's
    top-k experts, not every expert; all parameters of a dense model) x
    tokens, plus the attention products (:func:`attn_flops` a layer,
    forward and twice in the backward)."""
    from repro_torch.models import active_params
    from repro_torch.roofline import attn_flops

    attn = sum(spec.mixer == "attn" for spec in cfg.layout)
    hd = cfg.resolved_head_dim
    return 6.0 * active_params(cfg) * tokens + 3.0 * attn * attn_flops(
        batch, seq, seq, cfg.n_heads, cfg.n_kv_heads, hd)


def kernel_counts() -> dict:
    """Launches, since :func:`reset_counts`, of the kernels a train step
    and the elastic trainer reach."""
    from repro_torch.core import cover_dp as cdp
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import selective_scan_cuda

    return {"flash_attention": flash_attention_cuda.launches,
            "mamba_scan": selective_scan_cuda.launches,
            "cover_dp": cdp.cover_dp.launches}


def reset_counts() -> None:
    from repro_torch.core import cover_dp as cdp
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import selective_scan_cuda

    flash_attention_cuda.launches = selective_scan_cuda.launches = 0
    cdp.cover_dp.launches = 0


def step_launches(cfg, n_steps: int) -> dict:
    """Launches of ``n_steps`` train steps of ``cfg``: each attention and
    each Mamba layer once a pass, ``remat_passes`` passes a step, and no
    other kernel."""
    from repro_torch.models.transformer import remat_passes

    attn = sum(spec.mixer == "attn" for spec in cfg.layout)
    rp = n_steps * remat_passes(cfg)
    return {"flash_attention": attn * rp,
            "mamba_scan": (cfg.n_layers - attn) * rp, "cover_dp": 0}


def positions(cfg) -> int:
    """A training row's positions: :data:`TRAIN_SEQ` tokens (or audio
    frames), after the vision prefix of a VLM."""
    return (cfg.vision_prefix if cfg.input_mode == "vlm" else 0) + TRAIN_SEQ


def hold_train(dev, tag, arch, cut, seed, data_seed, remat_none=False):
    """A float32 cut of ``arch`` at full width (:func:`cut_layers`), three
    ``make_train_step`` steps of :data:`HOLD_ROWS` rows from one seeded
    init, through the kernels and through the plain versions (and, with
    ``remat_none``, through the kernels without remat): launches as
    :func:`step_launches` says and none in the plain run, losses and grad
    norms within 1e-4 relative (1e-5 between the remat policies); prints a
    ``tag`` line."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import count_params, init_params
    from repro_torch.train.loop import make_train_step

    cfg = cut_layers(get_config(arch), cut, dtype="float32")
    seq = positions(cfg)
    variants = [("cuda", "dots"), ("chunked", "dots")] + (
        [("cuda", "none")] if remat_none else [])
    runs = {}
    for impl, remat in variants:
        c = dataclasses.replace(cfg, attention_impl=impl, remat_policy=remat)
        params = init_params(c, torch.Generator(device=dev).manual_seed(
            seed), dev)
        opt = optim.init_opt_state(params)
        step = make_train_step(c, optim.OptConfig(**HOLD_OPT))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        got = []
        for i in range(TRAIN_STEPS):
            batch = make_batch(c, DataConfig(seed=data_seed), step=i,
                               batch=HOLD_ROWS, seq=seq)
            params, opt, m = step(params, opt, batch)
            got.append((float(m["loss"]), float(m["grad_norm"])))
        runs[impl, remat] = (got, kernel_counts(),
                             torch.cuda.max_memory_allocated(dev))
        del params, opt, step, m
        release(torch)

    def rel_diff(a, b):
        return max(abs(x - y) / abs(y) for ka, kb in zip(
            runs[a][0], runs[b][0]) for x, y in zip(ka, kb))

    kern, plain = runs["cuda", "dots"], runs["chunked", "dots"]
    want = step_launches(cfg, TRAIN_STEPS)
    check(kern[1] == want, f"{tag} {arch} hold: launches {kern[1]}, "
          f"expected {want}")
    check(sum(plain[1].values()) == 0,
          f"{tag} {arch} hold: the plain run launched {plain[1]}")
    check(all(math.isfinite(x) for r in runs.values() for lg in r[0]
              for x in lg), f"{tag} {arch} hold: {runs}")
    diff = rel_diff(("cuda", "dots"), ("chunked", "dots"))
    check(diff <= 1e-4, f"{tag} {arch} hold: (loss, grad norm) {kern[0]} "
          f"vs plain {plain[0]}")
    remat = ""
    if remat_none:
        none = runs["cuda", "none"]
        want_none = step_launches(dataclasses.replace(
            cfg, remat_policy="none"), TRAIN_STEPS)
        check(none[1] == want_none, f"{tag} {arch} hold remat none: "
              f"launches {none[1]}, expected {want_none}")
        d_remat = rel_diff(("cuda", "dots"), ("cuda", "none"))
        check(d_remat <= 1e-5, f"{tag} {arch} hold: remat dots {kern[0]} "
              f"vs none {none[0]}")
        remat = (f"; remat \"dots\" vs \"none\" (both through the "
                 f"kernels; none's launches {none[1]}, peak {none[2]} B): "
                 f"(loss, grad norm) {none[0]}, largest relative diff "
                 f"{d_remat:.3e} (bar 1e-5)")
    print(f"{tag} hold {arch} ({card_line()}): {cut_label(cut)} at full "
          f"width ({count_params(cfg)} float32 params, float32 compute), "
          f"{TRAIN_STEPS} train steps (B {HOLD_ROWS}, S {seq}, remat "
          f"{cfg.remat_policy}) through the kernels vs the plain versions: "
          f"(loss, grad norm) {kern[0]} vs {plain[0]}, largest relative "
          f"diff {diff:.3e} (bar 1e-4); launches {kern[1]}, plain "
          f"{plain[1]}; peak device memory {kern[2]} B (plain {plain[2]} "
          f"B)" + remat)


def train_full(dev, tag, arch, cut, seed, n_steps, rows, trace=False):
    """``arch`` at full width cut to ``cut`` (float32 parameters and AdamW
    moments, the config's bf16 compute and remat), ``n_steps``
    ``make_train_step`` steps of ``rows`` x :func:`positions` from a seeded
    init, under the elastic trainer's default schedule: losses finite,
    launches as :func:`step_launches` says, the peak within the card;
    prints the step walls, positions/s, share of the bf16 peak and peak
    memory in a ``tag`` line (and, with ``trace``, one traced step).  The
    first step's peak is counted on ``meta`` before anything is drawn on
    the card (``roofline.analyze_step``: parameters, moments and the peak
    of live bytes above them) and must fit the card too.  Returns the
    launches."""
    import torch

    from repro_torch import optim, roofline
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import active_params, count_params, init_params
    from repro_torch.models.transformer import abstract_params, remat_passes
    from repro_torch.train.loop import make_train_step

    full = get_config(arch)
    cfg = cut_layers(full, cut)
    seq = positions(cfg)
    total = torch.cuda.get_device_properties(dev).total_memory
    # the elastic trainer's default schedule (5 warm-up steps)
    step = make_train_step(cfg, optim.OptConfig(warmup_steps=5,
                                                total_steps=1000))
    t0 = time.perf_counter()
    ap = abstract_params(cfg)
    c = roofline.analyze_step(step, ap, optim.init_opt_state(ap), make_batch(
        cfg, DataConfig(seed=1), step=0, batch=rows, seq=seq))
    counted = c.argument_bytes + c.peak_bytes
    t_count = time.perf_counter() - t0
    check(counted < total, f"{tag} {arch}: {counted} B counted on meta, "
          f"over {total} B")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    opt = optim.init_opt_state(params)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    losses, walls = [], []
    reset_counts()
    for i in range(n_steps):
        b = make_batch(cfg, DataConfig(seed=1), step=i, batch=rows, seq=seq)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))        # synchronises
        walls.append(time.perf_counter() - t0)
    got = kernel_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = step_launches(cfg, n_steps)
    check(all(math.isfinite(x) for x in losses),
          f"{tag} {arch}: losses {losses}")
    check(got == want, f"{tag} {arch}: launches {got}, expected {want}")
    check(peak < total, f"{tag} {arch}: peak {peak} B over {total} B")
    wall = median(walls[1:])
    flops = train_flops(cfg, rows * seq, rows, seq)
    n_attn = want["flash_attention"] // (n_steps * remat_passes(cfg))
    print(f"{tag} train {arch} ({card_line()}): full width, "
          f"{cut_label(cut)} {cfg.n_layers} of {full.n_layers} layers "
          f"({n_attn} attention, {cfg.n_layers - n_attn} Mamba; "
          f"{count_params(cfg)} params, {active_params(cfg)} active a token;"
          f" float32 with float32 AdamW moments, drawn on the card in "
          f"{t_init:.1f} s; {cfg.dtype} compute, remat {cfg.remat_policy}); "
          f"B {rows} x S {seq}, {n_steps} steps; losses {losses}; step "
          f"walls s {[round(w, 4) for w in walls]}, warm median {wall:.4f} "
          f"s; {rows * seq / wall:.1f} positions/s; model FLOPs a step "
          f"{flops:.4e} (6 x active params x positions + attention), "
          f"{flops / wall / BF16_TC_OPS_PER_S:.2%} of the dense bf16 peak; "
          f"launches {got} (= {n_steps} steps x layers of each kind x "
          f"{remat_passes(cfg)}); peak device memory {peak} B of {total} B, "
          f"{peak / counted - 1:+.2%} on the {counted} B counted on meta "
          f"before the run ({t_count:.1f} s to count)")
    if trace:
        t_wall, busy, top = traced(torch, lambda: step(params, opt, b))
        print(f"{tag} trace {arch} train step: traced wall {t_wall:.3f} "
              f"ms, device busy {busy:.3f} ms (idle share "
              f"{1 - busy / t_wall:.4f}); by kernel: " + "; ".join(
                  f"{k} {v:.3f} ms" for k, v in top[:10]))
    del params, opt, step, m
    release(torch)
    return got


def run_train(dev) -> dict:
    """Phase 14 on ``dev``: training through the kernels; returns each
    kernel's launches on the training path and the gradient functions'
    readings."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import (Request, SpotMarketSimulator,
                                  generate_catalog)
    from repro_torch.core import backend as bmod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import selective_scan_cuda
    from repro_torch.launch import train as launch_train
    from repro_torch.models import count_params
    from repro_torch.models.transformer import remat_passes
    from repro_torch.roofline import attn_flops
    from repro_torch.runtime import ElasticConfig, ElasticSpotTrainer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(14)
    card = card_line()

    def on_card(a, dtype, grad=False):
        return torch.from_numpy(np.asarray(a)).to(
            device=dev, dtype=dtype).requires_grad_(grad)

    # -- 14a: the gradient functions against their plain versions ----------
    def hold_attn(label, shape, dtype, tol):
        b, s, h, kv, hd = shape
        q, k, v = (on_card(rng.normal(size=sh), dtype, grad=True)
                   for sh in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))
        do = on_card(rng.normal(size=(b, s, h, hd)), dtype)
        o_k, lse_k = flash_attention_cuda(q.detach(), k.detach(), v.detach())
        o = ops.FlashAttention.apply(q, k, v, True, True, s, s, False)
        grads = torch.autograd.grad(o, (q, k, v), do)
        o_p, lse_p = ref.flash_fwd_chunked(q.detach(), k.detach(),
                                           v.detach(), q_chunk=s, kv_chunk=s)
        want = ref.flash_bwd_chunked(q.detach(), k.detach(), v.detach(), o_p,
                                     lse_p, do, q_chunk=s, kv_chunk=s)
        errs = {"o": rel_max(o, o_p), "lse": rel_max(lse_k, lse_p)}
        errs.update({n: rel_max(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                       grads, want)})
        check(torch.equal(o.detach(), o_k),
              f"phase14 attention {label}: the Function's o is not the "
              "kernel's")
        check(max(errs.values()) <= tol,
              f"phase14 attention {label}: errors {errs} > {tol}")
        print(f"phase14 attention gradients {label} {shape} causal: "
              f"(o, lse) from the kernel, (dq, dk, dv) through "
              f"flash_bwd_chunked from the kernel's (o, lse), against "
              f"flash_fwd_chunked + flash_bwd_chunked: errors (max |diff| / "
              f"max(1, max |plain|)) " + ", ".join(
                  f"{n} {e:.3e}" for n, e in errs.items()) + f" (bar {tol})")
        return q, k, v, do, o_k, lse_k, max(errs.values())

    hold_attn("float32", (1, 256, 4, 2, 64), torch.float32,
              ATTN_TOL["float32"])
    ashape = (4, 1024, 16, 8, 128)              # internlm2-1.8b training
    q, k, v, do, o_k, lse_k, a_err = hold_attn("internlm2-1.8b bf16", ashape,
                                               torch.bfloat16,
                                               ATTN_TOL["bfloat16"])
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    fwd_ms = cuda_ms(torch, lambda: flash_attention_cuda(qd, kd, vd), 20)
    bwd_ms = cuda_ms(torch, lambda: ref.flash_bwd_chunked(
        qd, kd, vd, o_k, lse_k, do, q_chunk=1024, kv_chunk=1024), 10)
    qt, kt, vt = (t.detach().transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    timed = {"kernel": lambda: torch.autograd.grad(ops.FlashAttention.apply(
                 q, k, v, True, True, 1024, 1024, False), (q, k, v), do),
             "sdpa": lambda: torch.autograd.grad(
                 F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                enable_gqa=True),
                 (qt, kt, vt), dot)}
    turns = {"kernel": [], "sdpa": []}
    for who in ("kernel", "sdpa", "sdpa", "kernel"):
        turns[who].append(cuda_ms(torch, timed[who], 10))
    fb_ms, sfb_ms = median(turns["kernel"]), median(turns["sdpa"])
    b, s, h, kvh, hd = ashape
    fl = attn_flops(b, s, s, h, kvh, hd)
    print(f"phase14 attention at the internlm2-1.8b training shape (B 4, S "
          f"1024, H 16, KV 8, hd 128, bf16, causal; {card}): kernel forward "
          f"{fwd_ms:.4f} ms; recompute backward (flash_bwd_chunked) "
          f"{bwd_ms:.4f} ms; forward + backward {fb_ms:.4f} ms (turns "
          f"{turns['kernel']}, {3 * fl / fb_ms / 1e9:.1f} TFLOP/s of 3 x "
          f"the forward's products); scaled_dot_product_attention forward + "
          f"backward {sfb_ms:.4f} ms (turns {turns['sdpa']}, "
          f"{3 * fl / sfb_ms / 1e9:.1f} TFLOP/s); ours / SDPA "
          f"{fb_ms / sfb_ms:.3f}")
    del q, k, v, do, o_k, lse_k, qd, kd, vd, qt, kt, vt, dot, timed
    release(torch)

    def scan_args(b, s, di, n, dtype):
        """As falcon-mamba's layers feed the scan at init (phase 8)."""
        xr = rng.normal(size=(b, s, di))
        dt = np.log1p(np.exp(-4.6 + 0.5 * rng.normal(size=(b, s, di))))
        A = -np.broadcast_to(np.arange(1, n + 1), (di, n)).copy()
        return [on_card(xr / (1 + np.exp(-xr)), dtype, True),
                on_card(dt, dtype, True), on_card(A, torch.float32, True),
                on_card(rng.normal(size=(b, s, n)), dtype, True),
                on_card(rng.normal(size=(b, s, n)), dtype, True),
                on_card(np.ones(di), torch.float32, True)]

    sshape = (2, 1024, 8192, 16)                # falcon-mamba-7b training
    args = scan_args(*sshape, torch.float32)
    dy = on_card(rng.normal(size=sshape[:3]), torch.float32)
    y, _ = ops.SelectiveScan.apply(*args, None, True, 256)
    g_k = torch.autograd.grad(y, args, dy)
    y_p, _ = ref.selective_scan_chunked(*args, chunk=256)
    g_p = torch.autograd.grad(y_p, args, dy)
    names = ("x", "dt", "A", "B", "C", "D")
    errs = {"y": rel_largest(y, y_p)}
    errs.update({f"d{n}": rel_largest(a, b) for n, a, b in zip(names, g_k,
                                                               g_p)})
    s_err = max(errs.values())
    check(s_err <= SCAN_TOL["float32"],
          f"phase14 scan gradients: errors {errs} > {SCAN_TOL['float32']}")
    print(f"phase14 scan gradients at the falcon-mamba-7b training shape (B "
          f"2, S 1024, di 8192, N 16, float32): y from the kernel and the "
          f"six gradients through the chunk-by-chunk reverse recompute, "
          f"against autograd through selective_scan_chunked: errors "
          f"(max |diff| / largest |plain|) " + ", ".join(
              f"{n} {e:.3e}" for n, e in errs.items())
          + f" (bar {SCAN_TOL['float32']})")
    del args, dy, y, g_k, y_p, g_p
    release(torch)
    args = [t.detach() for t in scan_args(*sshape, torch.bfloat16)]
    dy = on_card(rng.normal(size=sshape[:3]), torch.bfloat16)
    sfwd_ms = cuda_ms(torch, lambda: selective_scan_cuda(*args), 20)
    sbwd_ms = cuda_ms(torch, lambda: ops.scan_backward(
        *args, None, dy, None, 256), 3)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    ops.scan_backward(*args, None, dy, None, 256)
    torch.cuda.synchronize()
    sbwd_mem = torch.cuda.max_memory_allocated(dev) - base
    print(f"phase14 scan at the falcon-mamba-7b training shape (bf16; "
          f"{card}): kernel forward {sfwd_ms:.4f} ms; recompute backward "
          f"(scan_backward, chunks of 256 in reverse) {sbwd_ms:.4f} ms, "
          f"{sbwd_mem} B of device memory above its inputs")
    del args, dy
    release(torch)
    print(f"phase14a took {time.perf_counter() - t_phase:.1f} s")

    # -- 14b: a 2-layer float32 cut at full width, kernels vs plain --------
    t0 = time.perf_counter()
    for seed, arch in enumerate(("internlm2-1.8b", "falcon-mamba-7b")):
        hold_train(dev, "phase14", arch, FIRST_TWO, 40 + seed, seed)
    print(f"phase14b took {time.perf_counter() - t0:.1f} s")

    # -- 14c: full width ---------------------------------------------------
    t0 = time.perf_counter()
    train_launches = collections.Counter()
    # one traced step of internlm2 (falcon's step is its 8 scan backwards,
    # timed in 14a; a trace costs ~10 s of the phase)
    for arch, layers, rows, n_steps, trace in (
            ("internlm2-1.8b", 24, 4, 5, True),
            ("falcon-mamba-7b", 8, 2, 3, False)):
        train_launches.update(train_full(dev, "phase14", arch,
                                         (range(layers), 0, 1), 50, n_steps,
                                         rows, trace))
    print(f"phase14c took {time.perf_counter() - t0:.1f} s")

    # -- 14d: ElasticSpotTrainer on the card -------------------------------
    t0 = time.perf_counter()
    full = get_config("internlm2-1.8b")
    cfg = dataclasses.replace(full, n_layers=2, layout=full.layout[:2])
    req = Request(pods=64, cpu_per_pod=4, mem_per_pod=8)

    def market():
        return SpotMarketSimulator(generate_catalog(seed=ELASTIC_MARKET_SEED),
                                   seed=ELASTIC_MARKET_SEED)

    def events(out):
        return [{**e, "detail": {k: v for k, v in e["detail"].items()
                                 if k not in ("wall_s", "recovery_s")}}
                for e in out["events"]]

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="phase14-", dir=os.path.join(ROOT, "build"))
    walls = {"save": [], "restore": []}
    try:
        reset_counts()
        with timed_checkpoints(torch, walls):
            tr = ElasticSpotTrainer(cfg, req, market(),
                                    os.path.join(d, "run"),
                                    ElasticConfig(**ELASTIC), device=dev)
            out = tr.run()
        got = kernel_counts()
        train_launches.update(got)
        handled = [e for e in out["events"]
                   if e["event"] in ("interrupt", "straggler")]
        check(out["steps"] == 12 and len(out["losses"]) == 12
              and all(math.isfinite(x) for x in out["losses"]),
              f"phase14 elastic: steps {out['steps']} losses "
              f"{out['losses']}")
        check(out["interrupts_handled"] >= 1 and handled,
              "phase14 elastic: no interrupt or straggler handled")
        check(all(e["detail"]["pods_after"] >= req.pods for e in handled)
              and tr.pool.total_pods >= req.pods,
              f"phase14 elastic: a pool below {req.pods} pods after an "
              "event")
        check(got["cover_dp"] > 0, "phase14 elastic: cover_dp not launched")
        want = 12 * cfg.n_layers * remat_passes(cfg)
        check(got["flash_attention"] == want,
              f"phase14 elastic: {got['flash_attention']} flash_attention "
              f"launches, expected {want}")
        trace = tr.cluster.recorder.dumps()
        saved = bmod._DEFAULT
        bmod.set_backend("numpy")
        try:
            twin = ElasticSpotTrainer(get_config("internlm2-1.8b",
                                                 smoke=True),
                                      req, market(), os.path.join(d, "twin"),
                                      ElasticConfig(**ELASTIC), device=dev)
            out_twin = twin.run()
        finally:
            bmod._DEFAULT = saved
        check(twin.cluster.recorder.dumps() == trace,
              "phase14 elastic: the cluster trace differs from the smoke "
              "twin's under numpy")
        check(events(out_twin) == events(out),
              "phase14 elastic: the event log differs from the smoke twin's "
              "under numpy")
        files = os.path.join(d, "run", "step_00000012")
        nbytes = sum(os.path.getsize(os.path.join(files, f))
                     for f in os.listdir(files))
        del tr
        release(torch)
        reset_counts()
        with timed_checkpoints(torch, walls):
            tr2 = ElasticSpotTrainer(cfg, req, market(),
                                     os.path.join(d, "run"),
                                     ElasticConfig(**{**ELASTIC,
                                                      "total_steps": 14}),
                                     device=dev)
            out2 = tr2.run()
        got2 = kernel_counts()
        train_launches.update(got2)
        check(any(e["event"] == "resume" and e["detail"]["from"] == 12
                  for e in out2["events"]) and out2["steps"] == 14,
              f"phase14 elastic: the restart did not resume at 12: "
              f"{events(out2)}")
        print(f"phase14 elastic internlm2-1.8b ({card}): full width, 2 of "
              f"24 layers ({count_params(cfg)} params); market "
              f"generate_catalog(seed={ELASTIC_MARKET_SEED}), request {req}, "
              f"{ELASTIC}; losses {[round(x, 4) for x in out['losses']]}; "
              f"events {[(e['step'], e['event']) for e in out['events']]}; "
              f"pods after each {[e['detail']['pods_after'] for e in handled]}"
              f"; trace ({out['trace_records']} records) and event log equal "
              f"to the smoke twin's under numpy; recovery s "
              f"{[round(x, 3) for x in out['recovery_times']]}; launches "
              f"{got}; checkpoint {nbytes} B; save s "
              f"{[round(x, 3) for x in walls['save']]}, restore s "
              f"{[round(x, 3) for x in walls['restore']]} (the last: the "
              f"restart's); restart resumed at 12 and ran to "
              f"{out2['steps']} (launches {got2})")
        del tr2
        release(torch)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(f"phase14d took {time.perf_counter() - t0:.1f} s")

    # -- 14e: the launcher on the default device ---------------------------
    t0 = time.perf_counter()
    d = tempfile.mkdtemp(prefix="phase14-", dir=os.path.join(ROOT, "build"))
    buf = io.StringIO()
    try:
        reset_counts()
        with contextlib.redirect_stdout(buf):
            launch_train.main(["--steps", "6", "--ckpt-dir", d])
        got = kernel_counts()
        train_launches.update(got)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res = json.loads(buf.getvalue())
    check(res["steps"] == 6 and math.isfinite(res["first_loss"])
          and math.isfinite(res["final_loss"]),
          f"phase14 launcher: {res}")
    check(got["flash_attention"] > 0 and got["cover_dp"] > 0,
          f"phase14 launcher: launches {got}")
    print(f"phase14 launch.train.main(['--steps', '6']) on the default "
          f"device: arch {res['arch']}, first loss {res['first_loss']:.4f}, "
          f"final loss {res['final_loss']:.4f}, interrupts handled "
          f"{res['interrupts_handled']}; launches {got} "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"phase14 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": dict(train_launches),
            "flash_attention": {"max_abs_err_grad": a_err, "fwd_ms": fwd_ms,
                                "bwd_ms": bwd_ms, "fwd_bwd_ms": fb_ms,
                                "sdpa_fwd_bwd_ms": sfb_ms},
            "mamba_scan": {"max_rel_err_grad": s_err, "fwd_ms": sfwd_ms,
                           "bwd_ms": sbwd_ms}}


def event_ms(torch, fn, reps: int) -> float:
    """Warm median of ``reps`` calls of ``fn``, each between a pair of CUDA
    events (the device timeline of one call, host gaps inside it included),
    after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return median(times)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: the bar of a counted peak (``StepCost.peak_bytes``) against the caching
#: allocator's measured one: 2% of the measured peak plus 64 MiB, either way
PEAK_REL, PEAK_ABS = 0.02, 64 * 2 ** 20


def measured_peak(torch, dev, fn):
    """``(requested, allocated)`` bytes of one call of ``fn`` after a warm-up
    call (cuBLAS's workspace is then in the baseline): the caching
    allocator's peak of requested bytes above those live before the call,
    and ``max_memory_allocated``'s rise (its 512-byte rounding and unsplit
    blocks included).  The call's result is alive when the peak is read,
    as the count's outputs are."""
    fn()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_stats(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn()
    torch.cuda.synchronize(dev)
    after = torch.cuda.memory_stats(dev)
    del out
    return (after["requested_bytes.all.peak"]
            - before["requested_bytes.all.current"],
            after["allocated_bytes.all.peak"]
            - before["allocated_bytes.all.current"])


def run_cost(dev) -> dict:
    """Phase 15 on ``dev``: the cost model against the card (15a), the
    sharded step factories on a 1-rank mesh (15b), ServeSim's roofline mode
    (15c) and the dry-run (15d); returns each kernel's launches on the
    sharded and roofline-serving paths."""
    import dataclasses
    import resource
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import optim, roofline, sharding
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core import generate_catalog
    from repro_torch.data.pipeline import DataConfig, batch_pspecs, make_batch
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import init_params, transformer
    from repro_torch.serve_sim import (build_serve_scenario, clear_caches,
                                       run_serving)
    from repro_torch.serve_sim import perf_model as pm
    from repro_torch.serving import (decode_fn, make_sharded_decode,
                                     make_sharded_prefill, prefill_fn)
    from repro_torch.train.loop import (make_sharded_train_step,
                                        make_train_step)

    card = card_line()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    gen = torch.Generator(device=dev)
    meta = torch.device("meta")
    launches = collections.Counter()

    def abstract(*shape, dtype=torch.int64):
        return torch.empty(shape, dtype=dtype, device=meta)

    def terms(c, n=1):
        rl = roofline.roofline_of(c, n)
        return (rl, f"FLOPs {c.flops:.6e} bytes {c.bytes:.6e} wire "
                    f"{c.wire_bytes:.6e}: compute {rl.compute_s * 1e3:.6f} ms"
                    f" memory {rl.memory_s * 1e3:.6f} ms, step_s "
                    f"{rl.step_s * 1e3:.6f} ms ({rl.bound})")

    # -- 15a: the cost model against the card ------------------------------
    cfg = get_config("internlm2-1.8b")
    B, S, new = 8, 1024, 32
    max_len = S + new                                   # a 1056-long cache
    params = init_params(cfg, gen.manual_seed(0), dev)  # phase 9's weights
    prompt = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S))).to(dev)}
    aparams = transformer.abstract_params(cfg)
    t0 = time.perf_counter()
    c_pre = roofline.analyze_step(prefill_fn, aparams, {"tokens": abstract(
        B, S)}, cfg=cfg, max_len=max_len)
    c_dec = roofline.analyze_step(
        decode_fn, aparams, transformer.abstract_cache(cfg, B, max_len),
        {"tokens": abstract(B, 1)}, S, cfg=cfg)
    count_s = time.perf_counter() - t0
    _, caches = prefill_fn(params, prompt, cfg=cfg, max_len=max_len)
    nxt = {"tokens": prompt["tokens"][:, :1]}
    measured = {
        "prefill": event_ms(torch, lambda: prefill_fn(
            params, prompt, cfg=cfg, max_len=max_len), 5),
        "decode": event_ms(torch, lambda: decode_fn(
            params, caches, nxt, S, cfg=cfg), 10)}
    shares = {}
    for what, c in (("prefill", c_pre), ("decode", c_dec)):
        rl, text = terms(c)
        shares[what] = rl.step_s * 1e3 / measured[what]
        check(c.flops > 0 and c.bytes > 0 and c.wire_bytes == 0,
              f"phase15a {what}: counted {c}")
        print(f"phase15a {what} internlm2-1.8b ({card}): full width and "
              f"depth, {cfg.dtype} compute, B {B} "
              + (f"x S {S}" if what == "prefill" else f"against a {max_len}"
                 "-long cache")
              + f": counted {text}; kernel ops {c.by_kernel}; measured warm "
              f"median {measured[what]:.4f} ms (CUDA events a call); share "
              f"step_s / measured {shares[what]:.4f}")
    print(f"phase15a counting both steps on meta took {count_s:.2f} s")

    # the memory account: each step's peak live bytes counted on meta
    # against the allocator's peak for the same step run on the card
    from repro_torch.kernels.mamba_scan import selective_scan_cuda
    held = []
    flash_attention_cuda.launches = selective_scan_cuda.launches = 0

    def hold_peak(what, c, fn):
        req, alloc = measured_peak(torch, dev, fn)
        gap = c.peak_bytes - req
        ok = abs(gap) <= PEAK_REL * req + PEAK_ABS
        held.append((what, ok))
        print(f"phase15a peak {what} ({card}): counted on meta "
              f"{c.peak_bytes} B (arguments {c.argument_bytes} B, outputs "
              f"{c.output_bytes} B); measured requested peak {req} B "
              f"(max_memory_allocated rise {alloc} B); gap counted - "
              f"measured {gap} B ({gap / max(req, 1):+.4%}; bar 2% + 64 "
              f"MiB = {PEAK_REL * req + PEAK_ABS:.0f} B): "
              f"{'held' if ok else 'MISSED'}")

    hold_peak(f"internlm2-1.8b prefill B {B} x S {S}", c_pre,
              lambda: prefill_fn(params, prompt, cfg=cfg, max_len=max_len))
    hold_peak(f"internlm2-1.8b decode B {B} against a {max_len}-long cache",
              c_dec, lambda: decode_fn(params, caches, nxt, S, cfg=cfg))
    ocfg = optim.OptConfig(warmup_steps=5, total_steps=1000)   # phase 14c's
    tbatch = make_batch(cfg, DataConfig(seed=1), step=0, batch=4, seq=1024)
    t0 = time.perf_counter()
    ap = transformer.abstract_params(cfg)
    c_train = roofline.analyze_step(make_train_step(cfg, ocfg), ap,
                                    optim.init_opt_state(ap), tbatch)
    t_train = time.perf_counter() - t0
    tparams = init_params(cfg, gen.manual_seed(50), dev)
    topt = optim.init_opt_state(tparams)
    tstep = make_train_step(cfg, ocfg)
    hold_peak(f"internlm2-1.8b make_train_step B 4 x S 1024, all "
              f"{cfg.n_layers} layers, remat {cfg.remat_policy!r}", c_train,
              lambda: tstep(tparams, topt, tbatch))
    del tparams, topt, tstep
    gc.collect()
    torch.cuda.empty_cache()
    full = get_config("falcon-mamba-7b")
    mcfg = dataclasses.replace(full, n_layers=8, layout=full.layout[:8])
    mprompt = {"tokens": torch.from_numpy(rng.integers(
        0, mcfg.vocab_size, (4, 1024))).to(dev)}
    t0 = time.perf_counter()
    c_mamba = roofline.analyze_step(
        prefill_fn, transformer.abstract_params(mcfg),
        {"tokens": abstract(4, 1024)}, cfg=mcfg, max_len=1024 + 16)
    t_mamba = time.perf_counter() - t0
    check(set(c_mamba.by_kernel) == {"selective_scan"},
          f"phase15a falcon-mamba count: kernel ops {c_mamba.by_kernel}")
    mparams = init_params(mcfg, gen.manual_seed(1), dev)
    hold_peak("falcon-mamba-7b prefill B 4 x S 1024, 8 of 64 layers",
              c_mamba, lambda: prefill_fn(mparams, mprompt, cfg=mcfg,
                                          max_len=1024 + 16))
    del mparams
    gc.collect()
    torch.cuda.empty_cache()
    n_flash, n_scan = (flash_attention_cuda.launches,
                       selective_scan_cuda.launches)
    launches["flash_attention"] += n_flash
    launches["mamba_scan"] += n_scan
    check(n_flash > 0 and n_scan > 0,
          f"phase15a peaks: launches flash {n_flash} scan {n_scan}")
    print(f"phase15a peaks: counting the train step on meta took "
          f"{t_train:.2f} s, the falcon-mamba prefill {t_mamba:.2f} s; "
          f"launches flash_attention {n_flash}, mamba_scan {n_scan} (each "
          f"step twice: warm-up and measured)")
    check(all(ok for _, ok in held),
          f"phase15a: counted peaks outside 2% + 64 MiB of the measured: "
          f"{[what for what, ok in held if not ok]}")

    qa = abstract(8, 1024, 16, 128, dtype=torch.bfloat16)
    ka = abstract(8, 1024, 8, 128, dtype=torch.bfloat16)
    c_attn = roofline.analyze_step(ops.flash_attention, qa, ka, ka)
    a_ms = roofline.roofline_of(c_attn).step_s * 1e3
    want_a = roofline.attn_bound(8, 1024, 1024, 16, 8, 128, 2)[0]
    check(c_attn.by_kernel == {"flash_attention": roofline.attn_cost(
        8, 1024, 1024, 16, 8, 128, 2)} and a_ms == want_a
        and round(a_ms, 6) == 0.034776,
        f"phase15a flash_attention op cost {c_attn} ({a_ms} ms)")
    xa = abstract(4, 1024, 8192, dtype=torch.bfloat16)
    bca = abstract(4, 1024, 16, dtype=torch.bfloat16)
    c_scan = roofline.analyze_step(
        ops.selective_scan, xa, xa, abstract(8192, 16, dtype=torch.float32),
        bca, bca, abstract(8192, dtype=torch.float32))
    s_ms = roofline.roofline_of(c_scan).step_s * 1e3
    check(s_ms == roofline.scan_bound(4, 1024, 8192, 16, 2)[0]
          and round(s_ms, 6) == 0.128384 and set(c_scan.by_kernel) ==
          {"selective_scan"}, f"phase15a selective_scan op cost {c_scan}")
    print(f"phase15a kernel ops counted as one op each: "
          f"repro_torch::flash_attention at the internlm2 prefill (B 8, S "
          f"1024, H 16, KV 8, hd 128, bf16) {c_attn.by_kernel} -> "
          f"{a_ms:.6f} ms = attn_bound; repro_torch::selective_scan at the "
          f"falcon-mamba-7b prefill (B 4, S 1024, di 8192, N 16, bf16) "
          f"{c_scan.by_kernel} -> {s_ms:.6f} ms = scan_bound")

    big = get_config("qwen2.5-14b")
    shape = SHAPES["decode_32k"]
    torch.cuda.synchronize()
    on_card = torch.cuda.memory_allocated(dev)
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t0 = time.perf_counter()
    bp = transformer.abstract_params(big)
    bc = transformer.abstract_cache(big, shape.global_batch, shape.seq_len)
    size = sum(p.numel() * p.element_size() for p in bp.parameters()) + sum(
        t.numel() * t.element_size() for c in bc for t in c.values())
    c_big = roofline.analyze_step(
        decode_fn, bp, bc, {"tokens": abstract(shape.global_batch, 1)},
        shape.seq_len - 1, cfg=big)
    grown = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - rss
    check(torch.cuda.memory_allocated(dev) == on_card and grown < 500_000,
          f"phase15a qwen2.5-14b count allocated: card "
          f"{torch.cuda.memory_allocated(dev) - on_card} B, host {grown} kB")
    print(f"phase15a qwen2.5-14b decode_32k at full width on one device "
          f"(B {shape.global_batch} against a {shape.seq_len}-long cache; "
          f"{size / 1e9:.1f} GB of parameters and cache, on meta): counted "
          f"{terms(c_big)[1]} in {time.perf_counter() - t0:.2f} s; device "
          f"memory unchanged, host peak grew {grown} kB")
    del caches

    # -- 15b: the sharded step factories on a 1-rank mesh -------------------
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh()
        rules = dataclasses.replace(sharding.single_pod_rules(fsdp=True),
                                    attn_mode="auto", ep_shard_map=True)
        steps = 8

        def greedy_run(pre, dec):
            """``(logits of every step, tokens, prefill ms, decode ms a
            step)`` of a prefill and ``steps`` greedy decode steps."""
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            logits, cache = pre(params, prompt)
            lg = logits.full_tensor() if hasattr(logits, "full_tensor") \
                else logits
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            outs, toks = [lg], [torch.argmax(lg[:, -1:], dim=-1)]
            for i in range(steps):
                logits, cache = dec(params, cache, {"tokens": toks[-1]},
                                    S + i)
                lg = logits.full_tensor() if hasattr(logits, "full_tensor") \
                    else logits
                outs.append(lg)
                toks.append(torch.argmax(lg[:, -1:], dim=-1))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            return (outs, torch.cat(toks, dim=1), (t2 - t1) * 1e3,
                    (t3 - t2) * 1e3 / steps)

        walls = {"unsharded": [], "sharded": []}
        runs = {}
        for who in ("unsharded", "unsharded", "sharded", "sharded"):
            if who == "unsharded":
                pre = lambda p, b: prefill_fn(p, b, cfg=cfg,     # noqa: E731
                                              max_len=S + steps)
                dec = lambda p, c, t, pos: decode_fn(            # noqa: E731
                    p, c, t, pos, cfg=cfg)
            else:
                with sharding.mesh_context(mesh, rules):
                    pre = make_sharded_prefill(
                        cfg, rules, batch_pspecs(cfg, dataclasses.replace(
                            SHAPES["prefill_32k"], global_batch=B,
                            seq_len=S), rules), max_len=S + steps)
                    dec = make_sharded_decode(
                        cfg, rules, batch_pspecs(cfg, SHAPES["decode_32k"],
                                                 rules))
            flash_attention_cuda.launches = 0
            outs, toks, p_ms, d_ms = greedy_run(pre, dec)
            n_flash = flash_attention_cuda.launches
            check(n_flash == cfg.n_layers, f"phase15b {who}: "
                  f"{n_flash} flash_attention launches, expected "
                  f"{cfg.n_layers}")
            if who == "sharded":
                launches["flash_attention"] += n_flash
                check(all(type(p).__name__ == "DTensor"
                          for p in params.parameters()),
                      "phase15b: the sharded run did not lay the "
                      "parameters out as DTensors")
            runs[who] = (outs, toks)
            walls[who].append((p_ms, d_ms))
        (o_u, t_u), (o_s, t_s) = runs["unsharded"], runs["sharded"]
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(o_u, o_s))
        check(torch.equal(t_u, t_s), f"phase15b: greedy tokens differ "
              f"{t_u.tolist()} vs {t_s.tolist()}")
        check(all(bool(torch.isfinite(o).all()) for o in o_s),
              "phase15b: a sharded logit is not finite")
        print(f"phase15b serve internlm2-1.8b ({card}) through "
              f"make_sharded_prefill / make_sharded_decode on a "
              f"{tuple(mesh.shape)} mesh ({rules}): batch {B}, prompt {S}, "
              f"{steps} new tokens; tokens equal to the unsharded path's; "
              f"logits max |diff| {diff:.3e}; flash_attention launches "
              f"{cfg.n_layers} a prefill (one a layer); walls (prefill ms, "
              f"decode ms a step) in order unsharded, unsharded, sharded, "
              f"sharded: {walls['unsharded']} {walls['sharded']}; sharded "
              f"/ unsharded (warm) prefill "
              f"{walls['sharded'][1][0] / walls['unsharded'][1][0]:.3f} "
              f"decode {walls['sharded'][1][1] / walls['unsharded'][1][1]:.3f}"
              f" (phase 9 serves the same model at batch 8 unsharded)")
        del params, runs, o_u, o_s, outs
        gc.collect()
        torch.cuda.empty_cache()

        full = cfg
        cut = dataclasses.replace(full, dtype="float32", n_layers=2,
                                  layout=full.layout[:2])
        ocfg = optim.OptConfig(lr=3e-4, warmup_steps=2, total_steps=100)
        batch = make_batch(cut, DataConfig(seed=0), step=0, batch=2,
                           seq=1024)
        got = {}
        for who in ("unsharded", "sharded"):
            p2 = init_params(cut, gen.manual_seed(40), dev)
            opt = optim.init_opt_state(p2)
            if who == "unsharded":
                step = make_train_step(cut, ocfg)
            else:
                with sharding.mesh_context(mesh, rules):
                    step = make_sharded_train_step(
                        cut, ocfg, rules, batch_pspecs(cut, dataclasses.replace(
                            SHAPES["train_4k"], global_batch=2, seq_len=1024),
                            rules))
            flash_attention_cuda.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            p2, opt, m = step(p2, opt, batch)
            vals = tuple(float(m[k].full_tensor() if hasattr(
                m[k], "full_tensor") else m[k]) for k in ("loss",
                                                          "grad_norm"))
            got[who] = (vals, (time.perf_counter() - t1) * 1e3,
                        flash_attention_cuda.launches)
            del p2, opt, step
        want = cut.n_layers * transformer.remat_passes(cut)
        launches["flash_attention"] += got["sharded"][2]
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["sharded"][0],
                                                       got["unsharded"][0]))
        check(rel <= 1e-4 and got["sharded"][2] == want,
              f"phase15b train: {got} (bar 1e-4, launches {want})")
        print(f"phase15b make_sharded_train_step ({card}): internlm2-1.8b "
              f"2-layer float32 cut at full width, B 2 x S 1024, one step "
              f"against make_train_step's: (loss, grad norm) "
              f"{got['sharded'][0]} vs {got['unsharded'][0]}, largest "
              f"relative diff {rel:.3e} (bar 1e-4); step wall ms sharded "
              f"{got['sharded'][1]:.1f} unsharded {got['unsharded'][1]:.1f} "
              f"(first steps, both cold); flash_attention launches "
              f"{got['sharded'][2]} (2 layers x forward + recompute)")
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase15b took {time.perf_counter() - t0:.1f} s")

    # -- 15c: ServeSim's roofline mode -------------------------------------
    t0 = time.perf_counter()
    offs = generate_catalog(seed=3, max_offerings=60)
    clear_caches()
    ana = pm.serving_table(pm.ServingProfile(mode="analytic"), offs)
    roof = pm.serving_table(pm.ServingProfile(mode="roofline"), offs)
    slo_r = pm.default_slo_ms(pm.ServingProfile(mode="roofline"))
    slo_a = pm.default_slo_ms(pm.ServingProfile(mode="analytic"))
    mask_r, mask_a = roof.slo_mask(slo_r), ana.slo_mask(slo_a)
    check(roof.mode == "roofline" and roof.token_s_ref != ana.token_s_ref
          and np.array_equal(np.argsort(-roof.qps_per_pod),
                             np.argsort(-ana.qps_per_pod))
          and np.array_equal(mask_r, mask_a)
          and np.allclose(roof.request_ms / roof.token_s_ref,
                          ana.request_ms / ana.token_s_ref, rtol=1e-7,
                          atol=0.0),
          "phase15c: the roofline table disagrees with the analytic one")
    print(f"phase15c serving_table on generate_catalog(seed=3, "
          f"max_offerings=60): roofline token_s_ref {roof.token_s_ref!r} s, "
          f"analytic {ana.token_s_ref!r} s (efficiency factor "
          f"{roof.token_s_ref / ana.token_s_ref:.4f}); ranking, SLO mask "
          f"({int(mask_r.sum()) if mask_r is not None else 0} of "
          f"{len(offs)} masked) and request_ms / token_s_ref equal")
    drv = SimDriver(torch, "phase15")
    saved_mode = os.environ.get("KUBEPACS_SERVE_PERF")
    os.environ["KUBEPACS_SERVE_PERF"] = "roofline"
    reports = []
    try:
        for spec in ("numpy", "torch"):
            clear_caches()
            ss = build_serve_scenario("diurnal", policy="serving_slo",
                                      duration_hours=24.0)
            check(ss.profile.resolved_mode() == "roofline",
                  f"phase15c: profile {ss.profile}")
            report, wall, got, k_ms = drv.drive(
                spec, lambda: run_serving(ss, clock=lambda: 0.0),
                "serve roofline")
            reports.append(json.dumps(report.as_dict(), sort_keys=True))
            if spec == "torch":
                check(got[0] > 0, f"phase15c: cover_dp not launched {got}")
                launches["cover_dp"] += got[0]
            print(f"phase15c serve diurnal serving_slo, roofline profile, "
                  f"{spec}: wall {wall:.3f} s; launches cover_dp {got[0]} "
                  f"fused_rows {got[1]}; kernels {k_ms:.3f} ms")
    finally:
        if saved_mode is None:
            del os.environ["KUBEPACS_SERVE_PERF"]
        else:
            os.environ["KUBEPACS_SERVE_PERF"] = saved_mode
        clear_caches()
    check(reports[0] == reports[1],
          "phase15c: the torch ServeReport differs from numpy's")
    print(f"phase15c reports byte-equal ({len(reports[0])} bytes); took "
          f"{time.perf_counter() - t0:.1f} s")

    # -- 15d: the dry-run ---------------------------------------------------
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    d = tempfile.mkdtemp(prefix="phase15-", dir=os.path.join(ROOT, "build"))
    try:
        out_file = os.path.join(d, "dryrun.jsonl")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "internvl2-1b", "--shape", "decode_32k", "--multi-pod", "--out",
             out_file], env=env, capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f"phase15d: dry-run exit "
              f"{res.returncode}: {res.stderr[-2000:]}")
        with open(out_file) as f:
            rec = json.loads(f.readlines()[-1])
    finally:
        shutil.rmtree(d, ignore_errors=True)
    mem = rec.get("memory_analysis", {})
    check(rec["status"] == "ok" and rec["n_devices"] == 512
          and rec["flops_per_device"] > 0
          and set(mem) == {"temp_bytes", "argument_bytes", "output_bytes"}
          and all(isinstance(v, int) and v >= 0 for v in mem.values()),
          f"phase15d: record {rec}")
    fits = rec["arg_bytes_per_device"] + mem["temp_bytes"]
    print("phase15d python -m repro_torch.launch.dryrun --arch internvl2-1b "
          "--shape decode_32k --multi-pod (512 fake ranks, counted on meta): "
          + json.dumps({k: rec[k] for k in (
              "status", "n_devices", "flops_per_device", "bytes_per_device",
              "wire_bytes_per_device", "collectives", "n_collectives",
              "compute_s", "memory_s", "collective_s", "bound", "step_s",
              "arg_bytes_per_device", "memory_analysis", "model_flops_ratio",
              "count_s")})
          + f"; args+temp/dev {fits / 1e9:.4f} GB ("
          + ("fits" if fits <= roofline.HBM_BYTES else "EXCEEDS")
          + f" {roofline.HBM_BYTES / 1e9:.0f} GB) "
          f"({time.perf_counter() - t0:.1f} s with the subprocess)")
    print(f"phase15 took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": dict(launches),
            "shares": shares, "measured_ms": measured}



#: bench_scale's configuration (``benchmarks/bench_scale.py:62-85`` and
#: ``:167-218``), copied: that module imports the JAX package.  The market
#: is ``generate_catalog(seed=17, max_offerings=1600)`` preprocessed for
#: quarter-vCPU / quarter-GiB pods (``pods_gcd`` 8); one decision is a
#: bracketed GSS over the prescan grid ``i/8``
SCALE_CATALOG = dict(seed=17, max_offerings=1600)
SCALE_POD = dict(cpu_per_pod=0.25, mem_per_pod=0.25)
SCALES = (5_000, 20_000, 50_000, 200_000, 1_000_000)
PRESCAN_GRID = tuple(i / 8 for i in range(9))
#: demands at which the fused plane takes the default ladder's batch: above
#: them ``ceil(demand / 8) > max_rows`` puts rows in the approx regime,
#: which ``FusedTorchBackend.fused_gss_record`` declines
SCALE_FUSED_MAX = 20_000
#: the gcd tier pinned (``high_demand_scenario``'s docstring) and where
SCALE_PINNED = (200_000, 1_000_000)
#: timing rounds in turns, and the high-demand fleet's interrupt seeds
SCALE_ROUNDS = 5
SCALE_SEEDS = 32


def in_turns(fns, rounds: int):
    """Every wall of each contender over ``rounds`` rounds, the visit order
    rotated each round (bench_scale's ``_interleaved``, all walls kept)."""
    names = list(fns)
    walls = {k: [] for k in names}
    for r in range(rounds):
        for k in names[r % len(names):] + names[:r % len(names)]:
            t0 = time.perf_counter()
            fns[k]()
            walls[k].append(time.perf_counter() - t0)
    return walls


def stat_keys(stats):
    """Each ``IlpStats`` as the repr of its fields: floats bit for bit
    (repr round-trips and tells -0.0 from 0.0)."""
    import dataclasses
    return [repr(dataclasses.astuple(s)) for s in stats]


def same_gss(a, b) -> bool:
    """Two ``bracketed_gss_many`` outputs: pools, α and traces equal."""
    return len(a) == len(b) and all(
        (pa is None) == (pb is None) and ta == tb and (
            pa is None or (pa.as_dict(), pa.counts, pa.alpha)
            == (pb.as_dict(), pb.counts, pb.alpha))
        for (pa, ta), (pb, tb) in zip(a, b))


def run_scale(dev) -> dict:
    """Phase 16 on ``dev``: the coarsening ladder end to end at
    bench_scale's size (16a the ladder decision by decision, with the walls
    in turns and ``provision()`` at 1 M; 16b the ladder held to the exact
    engine run on the card; 16c the pinned gcd tier; 16d the high-demand
    fleet; 16e the kernels at the new widths); returns each decision-plane
    kernel's launches on this path and 16e's readings."""
    import torch

    from repro_torch.core import (DEFAULT_COARSENING, CoarseningConfig,
                                  FusedTorchBackend, KubePACSProvisioner,
                                  NumpyBackend, Request, TorchBackend,
                                  compile_market, generate_catalog,
                                  get_backend, preprocess, solve_ilp_many)
    from repro_torch.core import cover_dp as cdp
    from repro_torch.core import fused_rows as fr
    from repro_torch.core.gss import bracketed_gss_many
    from repro_torch.sim import high_demand_scenario

    t_phase = time.perf_counter()
    exact_cfg = CoarseningConfig(enabled=False)
    pinned_cfg = CoarseningConfig(max_rows=1 << 20)
    catalog = generate_catalog(**SCALE_CATALOG)
    items = preprocess(catalog, Request(pods=5_000, **SCALE_POD))
    market = compile_market(items)
    check((market.n, market.n_bundles, market.pods_gcd) == (1597, 6606, 8),
          f"phase16 market: {market.n} items, {market.n_bundles} bundles, "
          f"gcd {market.pods_gcd}")
    grid = list(PRESCAN_GRID)
    launches = collections.Counter()

    class Widest(TorchBackend):
        """Keeps the largest DP target and the widest bits launch (its
        groups) of the dispatches it runs."""

        def __init__(self, device):
            super().__init__(device)
            self.reset()

        def reset(self):
            self.max_target, self.widest = 0, (0, None)

        def _dispatch(self, groups, with_bits):
            for part in self._slices(groups, with_bits):
                if not part:
                    continue
                self.max_target = max(self.max_target,
                                      max(int(g[2]) for g in part))
                size = sum(len(g[0]) * (int(g[2]) + 1) for g in part)
                if with_bits and size > self.widest[0]:
                    self.widest = (size, list(part))
            return TorchBackend._dispatch(self, groups, with_bits)

    class Stacks(FusedTorchBackend):
        """Keeps the arguments of its last row stack."""

        def _rows(self, *args, score_req=None):
            self.last = args
            return FusedTorchBackend._rows(self, *args, score_req=score_req)

    bes = {"numpy": NumpyBackend(), "torch": Widest(dev),
           "torch:fused": Stacks(dev)}
    fused = bes["torch:fused"]

    def counted(fn):
        """``fn()`` with its kernel launches counted toward this path:
        ``(result, (cover_dp launches, fused_rows launches))``."""
        cdp.cover_dp.launches = fr.fused_rows.launches = 0
        out = fn()
        got = (cdp.cover_dp.launches, fr.fused_rows.launches)
        launches["cover_dp"] += got[0]
        launches["fused_rows"] += got[1]
        return out, got

    def rows(spec, demand, cfg):
        """Every prescan α of one decision through a backend, stacked in
        one engine call: ``(pools, stats)``."""
        pools, stats = solve_ilp_many(items, [demand], [grid], market=market,
                                      backend=bes[spec], return_stats=True,
                                      coarsening=cfg)
        return pools[0], stats[0]

    def decide(spec, demand, cfg=DEFAULT_COARSENING):
        return bracketed_gss_many(items, [demand], tolerance=TOLERANCE,
                                  market=market, timer=fake_timer,
                                  backend=bes[spec], coarsening=cfg)

    def prescan(demand, cfg):
        """The fused plane's prescan stack of one decision (every grid α,
        one ``fused_rows`` stack): ``(pools, launches)``."""
        (counts, feas), got = counted(lambda: fused._run_prescan(
            market, [demand], [None], grid, cfg))
        return [list(map(int, c)) if f else None
                for c, f in zip(counts[0], feas[0])], got[1]

    def stack_launches(demand, cfg):
        """``fused_rows`` launches a prescan stack takes: its rows in slices
        whose bits stay under the budget."""
        width = fr.dp_width(demand, fused._coarse(market, cfg)) + 1
        step = max(1, fused.bits_budget // (market.n_bundles * width))
        return width, step, -(-len(grid) // step)

    def fallbacks():
        return fused.device_cache_info()["fallback_solves"]

    def tier_str(stats):
        return dict(collections.Counter(s.coarse for s in stats))

    # -- 16a: the ladder, decision by decision --------------------------------
    ladder, best = {}, collections.defaultdict(dict)
    for demand in SCALES:
        pools, stats = rows("numpy", demand, DEFAULT_COARSENING)
        ladder[demand] = (pools, stats)
        for spec in ("torch", "torch:fused"):
            got, _n = counted(lambda: rows(spec, demand, DEFAULT_COARSENING))
            check(got[0] == pools and stat_keys(got[1]) == stat_keys(stats),
                  f"phase16a {demand}: {spec}'s prescan rows differ from "
                  "numpy's")
        want = decide("numpy", demand)
        dec = {}
        rec0 = fused.fused_records
        for spec in ("torch", "torch:fused"):
            out, got = counted(lambda: decide(spec, demand))
            check(same_gss(out, want), f"phase16a {demand}: {spec}'s "
                  "decision differs from numpy's")
            dec[spec] = got
        took = fused.fused_records - rec0
        accept = demand <= SCALE_FUSED_MAX
        check(took == int(accept) and fallbacks() == 0,
              f"phase16a {demand}: fused records {took}, fallback solves "
              f"{fallbacks()}")
        f_cov, f_rows = dec["torch:fused"]
        check(f_rows > 0 if accept else (f_rows == 0 and f_cov > 0),
              f"phase16a {demand}: torch:fused launches (cover_dp, "
              f"fused_rows) {dec['torch:fused']}")
        check(dec["torch"][0] > 0, f"phase16a {demand}: no cover_dp launch")
        walls = in_turns({spec: lambda spec=spec: decide(spec, demand)
                          for spec in bes}, SCALE_ROUNDS)
        for spec, ws in walls.items():
            best[spec][demand] = min(ws)
        pool = want[0][0]
        print(f"phase16a pods={demand}: tiers {tier_str(stats)}, max "
              f"certificate {max(s.gap_bound for s in stats)!r}; prescan "
              "pools and IlpStats of torch and torch:fused bitwise numpy's; "
              f"decision alpha={pool.alpha!r} nodes={sum(pool.counts)} equal "
              f"to numpy's; torch:fused "
              + ("took a fused record" if accept else
                 "declined (approx regime: per-dispatch cover_dp)")
              + f", launches cover_dp {f_cov} fused_rows {f_rows}, fallback "
              f"solves 0; torch launches cover_dp {dec['torch'][0]}; walls "
              f"(median / min of {SCALE_ROUNDS} in turns) " + ", ".join(
                  f"{spec} {median(ws) * 1e3:.3f} / {min(ws) * 1e3:.3f} ms"
                  for spec, ws in walls.items()))
    print("phase16a scale_ratio_1m_vs_5k (min walls): " + ", ".join(
        f"{spec} {b[max(SCALES)] / b[min(SCALES)]:.4f}"
        for spec, b in best.items()))

    check(isinstance(get_backend(), TorchBackend)
          and get_backend().device == dev, "default backend is not the card")
    req = Request(pods=1_000_000, **SCALE_POD)
    prov_t = KubePACSProvisioner(timer=fake_timer,
                                 coarsening=DEFAULT_COARSENING)
    prov_n = KubePACSProvisioner(timer=fake_timer,
                                 coarsening=DEFAULT_COARSENING,
                                 backend=NumpyBackend())
    t0 = time.perf_counter()
    d_t, got = counted(lambda: prov_t.provision(req, catalog))
    w_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_n = prov_n.provision(req, catalog)
    w_n = time.perf_counter() - t0
    check(d_t == d_n and d_t.pool.as_dict() == d_n.pool.as_dict()
          and d_t.alpha == d_n.alpha and d_t.trace == d_n.trace
          and got[0] > 0, "phase16a provision(1,000,000) differs from the "
          f"NumPy decision (launches {got})")
    print(f"phase16a provision pods=1000000 (default backend torch): alpha="
          f"{d_t.alpha!r} nodes={sum(d_t.pool.counts)} e_total="
          f"{d_t.metrics['e_total']!r} launches cover_dp {got[0]}; wall "
          f"torch {w_t * 1e3:.3f} ms numpy {w_n * 1e3:.3f} ms: equal to "
          "NumPy")

    # -- 16b: the ladder held to the exact engine -----------------------------
    exact = {}
    peak = None
    for demand in SCALES:
        t0 = time.perf_counter()
        n_pools, n_stats = rows("numpy", demand, exact_cfg)
        w_n = time.perf_counter() - t0
        bes["torch"].reset()
        t0 = time.perf_counter()
        (t_pools, t_stats), got_t = counted(
            lambda: rows("torch", demand, exact_cfg))
        w_t = time.perf_counter() - t0
        check(t_pools == n_pools and stat_keys(t_stats) == stat_keys(n_stats),
              f"phase16b {demand}: torch's exact rows differ from numpy's")
        if demand == max(SCALES):
            widest = bes["torch"].widest
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        f_pools, f_launch = prescan(demand, exact_cfg)
        w_f = time.perf_counter() - t0
        width, step, n_launch = stack_launches(demand, exact_cfg)
        if demand == max(SCALES):
            peak = torch.cuda.max_memory_allocated(dev)
        check(f_pools == n_pools and f_launch == n_launch,
              f"phase16b {demand}: the fused exact prescan differs from "
              f"numpy's ({f_launch} launches, {n_launch} expected)")
        # the launches of a stack share one slice's scratch: at 1 M the
        # peak holds one row of bits
        check(peak is None or peak < step * market.n_bundles * width
              + (1 << 30), f"phase16b {demand}: peak device memory {peak} "
              f"B for {step} row(s) of {market.n_bundles * width} B of bits")
        exact[demand] = (t_pools, t_stats)
        max_gap = 0.0
        for (pc, sc, pe, se) in zip(*ladder[demand], t_pools, t_stats):
            check((pc is None) == (pe is None), f"phase16b {demand}: "
                  "feasibility differs from the exact engine's")
            if sc.coarse in ("exact", "gcd", "approx_fallback"):
                check(pc == pe, f"phase16b {demand}: {sc.coarse} row not "
                      "bitwise the exact engine's")
                continue
            true_gap = sc.objective - se.objective
            bound_ = sc.gap_bound + 1e-6 * max(1.0, abs(se.objective))
            rel = (DEFAULT_COARSENING.rel_gap * max(abs(se.objective), 1e-9)
                   + 1e-9)
            check(true_gap <= bound_ and true_gap <= rel,
                  f"phase16b {demand}: approx certificate violated: true "
                  f"gap {true_gap!r}, certificate {sc.gap_bound!r}, "
                  f"rel budget {rel!r}")
            max_gap = max(max_gap, true_gap)
        print(f"phase16b pods={demand}: exact rows (targets up to "
              f"{bes['torch'].max_target}, kept bundles up to "
              f"{max(s.n_bundles for s in n_stats)}) of torch and the fused "
              f"prescan (width {width}, {step} row(s) a launch, {f_launch} "
              "launches) bitwise numpy's; ladder against them: tiers "
              f"{tier_str(ladder[demand][1])}, exact/gcd rows bitwise, "
              f"largest approx true gap {max_gap!r}; walls numpy "
              f"{w_n:.3f} s, torch {w_t:.3f} s (cover_dp {got_t[0]}), "
              f"torch:fused prescan {w_f:.3f} s"
              + (f"; peak device memory {peak} B" if peak is not None
                 else ""))

    # -- 16c: the pinned gcd tier ---------------------------------------------
    pinned_rows = None
    for demand in SCALE_PINNED:
        want = decide("numpy", demand, pinned_cfg)
        walls, dec = {}, {}
        rec0 = fused.fused_records
        for spec in ("torch", "torch:fused"):
            t0 = time.perf_counter()
            out, dec[spec] = counted(lambda: decide(spec, demand, pinned_cfg))
            walls[spec] = time.perf_counter() - t0
            check(same_gss(out, want), f"phase16c {demand}: {spec}'s pinned "
                  "decision differs from numpy's")
        check(fused.fused_records - rec0 == 1 and fallbacks() == 0
              and dec["torch:fused"][1] > 0 and dec["torch"][0] > 0,
              f"phase16c {demand}: fused records "
              f"{fused.fused_records - rec0}, launches (cover_dp, "
              f"fused_rows) {dec}")
        t0 = time.perf_counter()
        decide("numpy", demand, pinned_cfg)
        walls["numpy"] = time.perf_counter() - t0
        n_pools, n_stats = rows("numpy", demand, pinned_cfg)
        bes["torch"].reset()
        (t_pools, t_stats), got_t = counted(
            lambda: rows("torch", demand, pinned_cfg))
        check(t_pools == n_pools and stat_keys(t_stats) == stat_keys(n_stats),
              f"phase16c {demand}: torch's pinned rows differ from numpy's")
        f_pools, f_launch = prescan(demand, pinned_cfg)
        width, step, n_launch = stack_launches(demand, pinned_cfg)
        check(f_pools == n_pools and f_launch == n_launch,
              f"phase16c {demand}: the fused pinned prescan differs from "
              f"numpy's ({f_launch} launches, {n_launch} expected)")
        if demand == max(SCALE_PINNED):
            pinned_rows = fused.last
        e_pools, e_stats = exact[demand]
        n_gcd = 0
        for pc, sc, pe, se in zip(n_pools, n_stats, e_pools, e_stats):
            if sc.coarse == "gcd":
                n_gcd += 1
                check(pc == pe and sc.objective == se.objective,
                      f"phase16c {demand}: a gcd row is not the exact "
                      "engine's")
        check(n_gcd > 0, f"phase16c {demand}: no gcd row")
        print(f"phase16c pods={demand} pinned gcd (max_rows 1<<20): tiers "
              f"{tier_str(n_stats)}; decisions of torch and torch:fused "
              "(a fused record, fallback solves 0) bitwise numpy's; prescan "
              f"rows of torch (cover_dp targets up to "
              f"{bes['torch'].max_target}) and torch:fused (fused_rows width "
              f"{width}, {step} row(s) a launch under the "
              f"{fused.bits_budget} B budget, {f_launch} launches) bitwise "
              f"numpy's; {n_gcd} gcd rows bitwise the exact engine's; walls "
              + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items()))

    # -- 16d: the high-demand fleet --------------------------------------------
    # its batches are in the approx regime but for re-provisioning after
    # an interrupt, so torch:fused takes few records and runs cover_dp
    drv = SimDriver(torch, "phase16d")
    for spec, got in fleet_in_turns(drv, "high_demand",
                                    high_demand_scenario(), SCALE_SEEDS,
                                    ("torch:fused", "torch")):
        check(spec != "torch:fused" or got[0] > 0,
              f"phase16d fleet: torch:fused launched no cover_dp ({got})")
    launches["cover_dp"] += drv.counts["cover_dp"]
    launches["fused_rows"] += drv.counts["fused_rows"]

    # -- 16e: the kernels at the new widths -------------------------------------
    groups = widest[1]
    batch = cdp.CoverBatch.build(groups, dev)
    dp_k, bits_k = cdp.cover_dp(batch, True)
    dp_p, bits_p = cdp.cover_dp_plain(batch, True)
    torch.cuda.synchronize()
    check(torch.equal(dp_k, dp_p) and torch.equal(bits_k, bits_p),
          "phase16e cover_dp: kernel != plain version at the exact 1M "
          "dispatch")
    err = max_abs_err(dp_k.cpu().numpy(), dp_p.cpu().numpy())
    del dp_p, bits_p
    got = batch.split(dp_k.cpu().numpy(), bits_k.cpu().numpy())
    for (d, b), (dh, bh) in zip(got, NumpyBackend().cover_bits(groups)):
        check(d.tobytes() == dh.tobytes() and np.array_equal(b, bh),
              "phase16e cover_dp: kernel != host at the exact 1M dispatch")
    del got, dp_k, bits_k
    k_ms = cuda_ms(torch, lambda: cdp.cover_dp(batch, True), 2)
    p_ms = cuda_ms(torch, lambda: cdp.cover_dp_plain(batch, True), 1)
    b_ms, b_by = bound(groups)
    chain = longest(groups)
    cover_rec = {"shape": f"widest dispatch of the exact 1M rows: G="
                          f"{len(groups)} sum B={batch.n_bundles} max T="
                          f"{int(batch.targets.max())}",
                 "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                 "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                 "ns_a_bundle_step": k_ms * 1e6 / max(chain, 1)}
    print(f"phase16e cover_dp at the {cover_rec['shape']} ({widest[0]} B of "
          f"bits, global-scratch rows): dp and bits bitwise the plain "
          f"version's and the host's; kernel {k_ms:.4f} ms plain "
          f"{p_ms:.4f} ms bound {b_ms:.6f} ms ({b_by}); longest group "
          f"{chain} bundles: {cover_rec['ns_a_bundle_step']:.1f} ns a bundle "
          "step")
    del batch

    dm, coefs, actives, reqs, coarse, max_req = pinned_rows
    R = coefs.shape[0]
    paths = torch.full((R,), 255, dtype=torch.uint8, device=dev)
    ck, sk = fr.fused_rows(dm, coefs, actives, reqs, coarse, max_req,
                           fused.bits_budget, paths=paths)
    info = []
    cp, sp = fr.fused_rows_plain(dm, coefs, actives, reqs, coarse, max_req,
                                 info)
    torch.cuda.synchronize()
    check(torch.equal(ck, cp) and torch.equal(sk, sp),
          "phase16e fused_rows: kernel != plain version at the pinned-gcd "
          "1M rows")
    err = float((ck - cp).abs().max())
    took = paths.cpu().numpy().tolist()
    check(took == [p for _c, p in fr.prefix_plans(info)],
          f"phase16e fused_rows: paths {took}")
    width = fr.dp_width(max_req, coarse) + 1
    k_ms = cuda_ms(torch, lambda: fr.fused_rows(
        dm, coefs, actives, reqs, coarse, max_req, fused.bits_budget), 2)
    p_ms = cuda_ms(torch, lambda: fr.fused_rows_plain(
        dm, coefs, actives, reqs, coarse, max_req), 1)
    b_ms, b_by = rows_bound(dm, coefs, info)
    rows_rec = {"shape": f"pinned-gcd 1M prescan: {R} rows, N={dm.n_items}, "
                         f"B={dm.n_bundles}, width {width}",
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    print(f"phase16e fused_rows at the {rows_rec['shape']} (dp_global rows; "
          f"max kept {max(r['kept'] for r in info)}, max core "
          f"{max(r['core'] for r in info)}, max eff_res "
          f"{max(r['eff_res'] for r in info)}; paths none/prefix/full "
          f"{[took.count(p) for p in range(3)]}): counts and status bitwise "
          f"the plain version's; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
          f"bound {b_ms:.6f} ms ({b_by})")
    print(f"phase16 launches on the scale path: {dict(launches)}; took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": dict(launches), "cover_dp": cover_rec,
            "fused_rows": rows_rec}


#: phase 17: every other family of the reference served at full width —
#: (arch, serve cut, hold cut, prompt tokens, parameters of the serve run,
#: of the hold); a cut is (the layout's layers taken, a range or a tuple
#: of indices; prefix_layers; scan_period), None for the whole stack, its
#: scan_period dividing its body (``ModelConfig.n_periods``).  The MoE
#: cuts serve with bfloat16 parameters: jamba's five layers are 96.2 GB
#: and kimi's two 79.7 GB in float32.  Every hold takes float32
#: parameters.
FIRST_TWO = (range(2), 0, 1)
FAMILIES = (
    ("stablelm-3b", None, FIRST_TWO, 1024, 2_795_443_200, 416_179_200),
    ("qwen2.5-14b", None, FIRST_TWO, 1024, 14_770_033_664, 2_107_677_696),
    ("internvl2-1b", None, FIRST_TWO, 1000, 493_803_392, 165_730_944),
    ("musicgen-large", None, FIRST_TWO, 1024, 3_255_177_216, 167_792_640),
    ("jamba-1.5-large-398b", (range(5), 0, 5), (range(3, 5), 0, 2), 1024,
     24_045_707_264, 11_912_896_512),
    ("kimi-k2-1t-a32b", (range(2), 1, 1), (range(1), 0, 1), 1024,
     19_934_645_248, 2_860_798_976),
)
#: each family's serve run (the prompt length is the family's)
FAMILY_SERVE = dict(requests=8, batch=4, new_tokens=16)
#: the f32 hold: prefill (B 2, S 256) + 4 greedy decode steps, its bar
FAMILY_HOLD = (2, 256, 4, 2e-4)
#: jamba's prefill scan, timed: (B, S, di, N)
JAMBA_SCAN = (4, 1024, 16384, 16)


def cut_layers(cfg, cut, **kw):
    """``cfg`` cut to ``cut`` (see :data:`FAMILIES`), with ``kw``."""
    import dataclasses

    if cut is not None:
        layers, prefix, period = cut
        kw = dict(n_layers=len(layers),
                  layout=tuple(cfg.layout[i] for i in layers),
                  prefix_layers=prefix, scan_period=period, **kw)
    return dataclasses.replace(cfg, **kw).validate()


def cut_label(cut) -> str:
    """``layout[lo:hi]`` of a cut that takes a range of layers, else the
    layers it takes."""
    if cut is None:
        return "all"
    layers = cut[0]
    if isinstance(layers, range):
        return f"layout[{layers.start}:{layers.stop}]"
    return "(" + ", ".join(f"layout[{i}]" for i in layers) + ")"


def run_families(dev) -> dict:
    """Phase 17 on ``dev``: stablelm-3b, qwen2.5-14b, internvl2-1b,
    musicgen-large, jamba-1.5-large and kimi-k2 served at full width
    through ``launch.serve.serve`` (:data:`FAMILIES`), each with a
    ``torch.profiler`` breakdown of one prefill and one decode step and a
    float32 cut held to the plain versions; ``flash_attention`` at each
    family's prefill shape and ``mamba_scan`` at jamba's, held to their
    plain versions and timed against SDPA and their bounds.  Returns the
    launches of the serve runs and the readings."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core.cuda_lib import library
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.mamba_scan import selective_scan_cuda
    from repro_torch.launch.serve import _prompts, serve
    from repro_torch.models import active_params, count_params, init_params
    from repro_torch.roofline import attn_bound, attn_flops, scan_bound
    from repro_torch.serving import prefill_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    rng = np.random.default_rng(17)
    gen = torch.Generator(device=dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    card = card_line()
    launches = {"flash_attention": 0, "mamba_scan": 0}
    attn_readings = {}

    def reset():
        flash_attention_cuda.launches = selective_scan_cuda.launches = 0

    def counts():
        return flash_attention_cuda.launches, selective_scan_cuda.launches

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def mixers(cfg):
        attn = sum(spec.mixer == "attn" for spec in cfg.layout)
        return attn, cfg.n_layers - attn

    def attn_reading(label, b, s, h, kv, hd, n_launch):
        """flash_attention at a family's prefill shape (bf16, causal): held
        to its plain version (o and lse), its columns past hd never
        written, timed in turns with SDPA."""
        q, k, v = (torch.randn(sh, generator=gen, device=dev).to(
            torch.bfloat16) for sh in ((b, s, h, hd), (b, s, kv, hd),
                                       (b, s, kv, hd)))
        o, lse = flash_attention_cuda(q, k, v, causal=True)
        o_p, lse_p = ref.flash_fwd_chunked(q, k, v, q_chunk=s, kv_chunk=s,
                                           causal=True)
        # a launch into a buffer one padded row longer than o, filled with
        # NaN: the last head's columns hd .. 64 * ceil(hd / 64) - 1 would
        # land past o's end
        n = o.numel()
        buf = torch.full((n + 256,), float("nan"), dtype=torch.bfloat16,
                         device=dev)
        lse_b = torch.empty_like(lse)
        with torch.cuda.device(dev):
            rc = library().flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), buf.data_ptr(),
                lse_b.data_ptr(), b, s, s, h, kv, hd, 0, s, 1, 1,
                torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        e_o, e_l = err(o, o_p), err(lse, lse_p)
        check(e_o <= ATTN_TOL["bfloat16"] and e_l <= ATTN_TOL["bfloat16"],
              f"phase17 flash_attention {label}: o err {e_o} lse err {e_l}")
        check(rc == 0 and torch.equal(buf[:n].view_as(o), o)
              and torch.equal(lse_b, lse) and bool(torch.isnan(buf[n:]).all()),
              f"phase17 flash_attention {label}: a column past hd {hd} was "
              "written, or a second launch differs")
        a_ms, al_ms, ap_ms, turns = attn_in_turns(torch, q, k, v)
        ab_ms, ab_by = attn_bound(b, s, s, h, kv, hd, elem=2)
        tflop = attn_flops(b, s, s, h, kv, hd) / 1e12
        hdp = -(-hd // 64) * 64
        print(f"phase17 flash_attention at the {label} prefill (B {b}, S {s},"
              f" H {h}, KV {kv}, G {h // kv}, hd {hd} in boxes of {hdp}, "
              f"bf16; {card}): o err {e_o:.3e} lse err {e_l:.3e}, columns "
              f"past hd unwritten; kernel {a_ms:.4f} ms (turns "
              f"{turns['kernel']}) {tflop / a_ms * 1e3:.1f} TFLOP/s "
              f"{ab_ms / a_ms:.2%} of bound; scaled_dot_product_attention "
              f"{al_ms:.4f} ms (turns {turns['sdpa']}); kernel / SDPA "
              f"{a_ms / al_ms:.3f}; plain {ap_ms:.4f} ms; bound {ab_ms:.6f} "
              f"ms ({ab_by}); padding {1 - hd / hdp:.1%} of each product; "
              f"{n_launch} launches in the serve run")
        attn_readings[label] = {
            "shape": f"B {b}, S {s}, H {h}, KV {kv}, hd {hd}, bf16, causal",
            "launches": n_launch, "max_abs_err": max(e_o, e_l),
            "ms": a_ms, "plain_ms": ap_ms, "bound_ms": ab_ms,
            "bound_by": ab_by, "library_ms": al_ms}

    served_shapes = []
    for seed, (arch, cut, hold, S, n_serve, n_hold) in enumerate(FAMILIES):
        full = get_config(arch)
        kw = {} if cut is None else {"param_dtype": "bfloat16"}
        cfg = cut_layers(full, cut, **kw)
        check(count_params(cfg) == n_serve,
              f"phase17 {arch}: {count_params(cfg)} parameters")
        attn, ssm = mixers(cfg)
        vp = cfg.vision_prefix if cfg.input_mode == "vlm" else 0
        release(torch)

        # -- the serve run ----------------------------------------------
        t0 = time.perf_counter()
        params = init_params(cfg, gen.manual_seed(170 + seed), dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        out = serve(cfg, params, prompt_len=S, seed=0, device=dev,
                    **FAMILY_SERVE)
        got = counts()
        peak = torch.cuda.max_memory_allocated(dev)
        bs = out["batches"]
        want = (attn * len(bs), ssm * len(bs))
        check(out["served"] == FAMILY_SERVE["requests"],
              f"phase17 serve {arch}: served {out['served']}")
        check(out["all_finite"], f"phase17 serve {arch}: a logit is not "
              "finite")
        check(got == want, f"phase17 serve {arch}: launches (flash, scan) "
              f"{got}, expected {want}")
        check(peak < total, f"phase17 serve {arch}: peak {peak} B over "
              f"{total} B")
        shapes = sorted({t.shape for t in out["tokens"]})
        want_tok = (FAMILY_SERVE["batch"], FAMILY_SERVE["new_tokens"] + 1) \
            + ((cfg.n_codebooks,) if cfg.input_mode == "audio_codes" else ())
        check(shapes == [want_tok], f"phase17 serve {arch}: tokens {shapes}")
        launches["flash_attention"] += got[0]
        launches["mamba_scan"] += got[1]
        n_new = FAMILY_SERVE["new_tokens"]
        layers = f"{cut_label(cut)} {cfg.n_layers} layers"
        print(f"phase17 serve {arch} ({card}): full width, {layers} "
              f"({attn} attention, {ssm} Mamba; {count_params(cfg)} params, "
              f"{active_params(cfg)} active a token, {cfg.param_dtype}, "
              f"drawn on the card in {t_init:.1f} s); "
              f"{FAMILY_SERVE['requests']} requests, batch "
              f"{FAMILY_SERVE['batch']}, prompt {S}"
              + (f" after {vp} vision embeddings" if vp else "")
              + f", {n_new} new tokens, bf16 compute; launches "
              f"flash_attention={got[0]} mamba_scan={got[1]}; prefill ms "
              f"{[round(b['prefill_s'] * 1e3, 3) for b in bs]}; decode ms a "
              f"step {[round(b['decode_s'] * 1e3 / n_new, 3) for b in bs]}; "
              f"tok/s {out['throughput_tok_s']}; wall {out['wall_s']} s; "
              f"peak device memory {peak} B of {total} B; tokens {shapes}; "
              "all logits finite")
        if attn:
            served_shapes.append((arch, FAMILY_SERVE["batch"], vp + S,
                                  cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, got[0]))

        trace_steps(cfg, params, _prompts(cfg, rng, FAMILY_SERVE["batch"],
                                          S, dev), f"phase17 trace {arch}")

        # the bf16 cuts: kernels vs plain versions, reported, not held
        if cut is not None:
            prompt = _prompts(cfg, rng, 2, 1024, dev)
            reset()
            lk, _ = prefill_fn(params, prompt, cfg=cfg, max_len=1024)
            check(counts() == (attn, ssm),
                  f"phase17 {arch} bf16 prefill: launches {counts()}")
            lp, _ = prefill_fn(params, prompt, cfg=dataclasses.replace(
                cfg, attention_impl="chunked"), max_len=1024)
            check(counts() == (attn, ssm),
                  f"phase17 {arch} bf16 plain prefill launched a kernel")
            bf_diff = err(lk, lp)
            same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
            print(f"phase17 {arch} {layers} bfloat16 parameters, prefill "
                  f"(B 2, S 1024) through the kernels vs the plain versions: "
                  f"max logit diff {bf_diff:.4f} (largest |logit| "
                  f"{float(lk.float().abs().max()):.4f}), argmax agreement "
                  f"{same:.4f} (reported, not held)")
            del prompt, lk, lp
        del params
        release(torch)

        # -- the float32 hold ---------------------------------------------
        hb, hs, steps, bar = FAMILY_HOLD
        hcfg = cut_layers(full, hold, dtype="float32")
        check(count_params(hcfg) == n_hold,
              f"phase17 {arch} hold: {count_params(hcfg)} parameters")
        params = init_params(hcfg, gen.manual_seed(270 + seed), dev)
        prompt = _prompts(hcfg, rng, hb, hs, dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        outs_k, toks_k = greedy(hcfg, params, prompt, steps)
        h_attn, h_ssm = mixers(hcfg)
        check(counts() == (h_attn, h_ssm),
              f"phase17 {arch} hold: launches {counts()}")
        outs_p, toks_p = greedy(dataclasses.replace(
            hcfg, attention_impl="chunked"), params, prompt, steps)
        check(counts() == (h_attn, h_ssm),
              f"phase17 {arch} hold: the plain run launched a kernel")
        peak = torch.cuda.max_memory_allocated(dev)
        check(all(bool(torch.isfinite(a).all()) for a in outs_k),
              f"phase17 {arch} hold: a logit is not finite")
        diff = max(err(a, b) for a, b in zip(outs_k, outs_p))
        check(diff <= bar, f"phase17 {arch} hold: logits differ by {diff}")
        check(torch.equal(toks_k, toks_p), f"phase17 {arch} hold: tokens "
              f"differ {toks_k.tolist()} vs {toks_p.tolist()}")
        print(f"phase17 hold {arch}: {cut_label(hold)} at full "
              f"width ({n_hold} float32 params), prefill (B {hb}, S "
              f"{prompt_len(hcfg, prompt)}) + {steps} greedy decode steps, "
              f"kernels vs plain versions: max logit diff {diff:.3e} (bar "
              f"{bar}), tokens equal {tuple(toks_k.shape)}; launches "
              f"(flash, scan) {counts()}; peak device memory {peak} B")
        del params, prompt, outs_k, outs_p
        release(torch)

    # -- the kernels at the new prefill shapes ---------------------------
    for arch, b, s, h, kv, hd, n_launch in served_shapes:
        attn_reading(arch, b, s, h, kv, hd, n_launch)
        release(torch)
    b, s, di, n = JAMBA_SCAN
    sh = (b, s, di)
    x = F.silu(torch.randn(sh, generator=gen, device=dev)).to(torch.bfloat16)
    dt = F.softplus(-4.6 + 0.5 * torch.randn(sh, generator=gen, device=dev)
                    ).to(torch.bfloat16)
    A = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(
        di, n).contiguous()
    D = torch.ones(di, device=dev)
    Bm, Cm = (torch.randn((b, s, n), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    args = (x, dt, A, Bm, Cm, D)
    y, hf = selective_scan_cuda(*args)
    y_p, h_p = ref.selective_scan_ref(*args)
    torch.cuda.synchronize()
    e_y, e_h = err(y, y_p), err(hf, h_p)
    check(e_y <= SCAN_TOL["bfloat16"] and e_h <= SCAN_TOL["bfloat16"],
          f"phase17 mamba_scan at jamba's prefill: y err {e_y} h err {e_h}")
    s_ms = cuda_ms(torch, lambda: selective_scan_cuda(*args), 20)
    sp_ms = cuda_ms(torch, lambda: ref.selective_scan_ref(*args), 2)
    sb_ms, sb_by = scan_bound(b, s, di, n, elem=2)
    n_scan = launches["mamba_scan"]
    print(f"phase17 mamba_scan at the jamba-1.5-large prefill (B {b}, S {s},"
          f" di {di}, N {n}, bf16; {card}): y err {e_y:.3e} h_final err "
          f"{e_h:.3e}; kernel {s_ms:.4f} ms {sb_ms / s_ms:.2%} of bound; "
          f"plain (sequential) {sp_ms:.4f} ms; library none; bound "
          f"{sb_ms:.6f} ms ({sb_by}); {n_scan} launches in the serve run")
    scan_reading = {"jamba-1.5-large-398b": {
        "shape": f"B {b}, S {s}, di {di}, N {n}, bf16", "launches": n_scan,
        "max_abs_err": max(e_y, e_h), "ms": s_ms, "plain_ms": sp_ms,
        "bound_ms": sb_ms, "bound_by": sb_by, "library_ms": None}}
    del args, x, dt, Bm, Cm, y, y_p
    release(torch)
    print(f"phase17 launches on the families' serve runs: {launches}; took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "flash_attention": attn_readings,
            "mamba_scan": scan_reading}



#: phase 18: the other families trained at full width — (arch, cut of the
#: full-width run, cut of the float32 hold, its parameters, of the hold's,
#: batch rows); cuts as in :data:`FAMILIES`.  16 B a parameter (float32
#: weights, gradients and two AdamW moments) decides each depth: qwen3-moe
#: 4 of 48 layers, jamba one Mamba + MLP and the attention + MLP layer (one
#: of its MoE layers is 9.66 B parameters, 155 GB to train), kimi its dense
#: layer (the 384-expert layer is 16.9 B), qwen2.5-14b 6 of 48; the rest
#: whole.
TRAIN_FAMILIES = (
    ("qwen3-moe-30b-a3b", (range(4), 0, 1), FIRST_TWO, 3_114_813_440,
     1_868_572_672, 4),
    ("jamba-1.5-large-398b", ((2, 4), 0, 2), ((2, 4), 0, 2), 2_853_068_800,
     2_853_068_800, 2),
    ("kimi-k2-1t-a32b", (range(1), 0, 1), (range(1), 0, 1), 2_860_798_976,
     2_860_798_976, 4),
    ("stablelm-3b", None, FIRST_TWO, 2_795_443_200, 416_179_200, 4),
    ("qwen2.5-14b", (range(6), 0, 1), FIRST_TWO, 3_208_752_128,
     2_107_677_696, 4),
    ("internvl2-1b", None, FIRST_TWO, 493_803_392, 165_730_944, 4),
    ("musicgen-large", None, FIRST_TWO, 3_255_177_216, 167_792_640, 4),
)
#: steps of each phase-18 run and of every hold (phases 14 and 18); the
#: holds' batch rows and schedule; text tokens a row (after internvl2's
#: 256 vision embeddings)
TRAIN_STEPS, HOLD_ROWS, TRAIN_SEQ = 3, 2, 1024
HOLD_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=100)
#: the families the launcher trains (their smoke configs, 6 steps)
LAUNCH_ARCHS = ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b")


def run_train_families(dev) -> dict:
    """Phase 18 on ``dev``: the other families trained through
    ``make_train_step`` / ``init_opt_state`` / ``make_batch``
    (:data:`TRAIN_FAMILIES`): (a) a float32 cut of each at full width held
    to the plain versions (:func:`hold_train`; qwen3-moe's also without
    remat: the recompute routes as the forward did); (b) each at full
    width (:func:`train_full`), with a traced qwen3-moe step; (c)
    ``launch.train.main`` on :data:`LAUNCH_ARCHS`' smoke configs.  Returns
    the launches of (b) and (c)."""
    import shutil
    import tempfile

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import count_params

    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    launches = collections.Counter()

    # -- 18a: a float32 cut of each at full width, kernels vs plain -------
    for seed, (arch, _, hold, _, n_hold, _) in enumerate(TRAIN_FAMILIES):
        n = count_params(cut_layers(get_config(arch), hold))
        check(n == n_hold, f"phase18 {arch} hold: {n} parameters")
        hold_train(dev, "phase18", arch, hold, 180 + seed, seed,
                   remat_none=arch == "qwen3-moe-30b-a3b")
    print(f"phase18a took {time.perf_counter() - t_phase:.1f} s")

    # -- 18b: full width ---------------------------------------------------
    t0 = time.perf_counter()
    for seed, (arch, cut, _, n_params, _, rows) in enumerate(
            TRAIN_FAMILIES):
        n = count_params(cut_layers(get_config(arch), cut))
        check(n == n_params, f"phase18 {arch}: {n} parameters")
        launches.update(train_full(dev, "phase18", arch, cut, 190 + seed,
                                   TRAIN_STEPS, rows,
                                   trace=arch == "qwen3-moe-30b-a3b"))
    print(f"phase18b took {time.perf_counter() - t0:.1f} s")

    # -- 18c: the launcher on the other families ---------------------------
    t0 = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for arch in LAUNCH_ARCHS:
        d = tempfile.mkdtemp(prefix="phase18-", dir=os.path.join(ROOT,
                                                                 "build"))
        buf = io.StringIO()
        try:
            reset_counts()
            with contextlib.redirect_stdout(buf):
                launch_train.main(["--arch", arch, "--steps", "6",
                                   "--ckpt-dir", d])
            got = kernel_counts()
            launches.update(got)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        res = json.loads(buf.getvalue())
        check(res["steps"] == 6 and math.isfinite(res["first_loss"])
              and math.isfinite(res["final_loss"]),
              f"phase18 launcher {arch}: {res}")
        kinds = {"flash_attention" if spec.mixer == "attn" else "mamba_scan"
                 for spec in get_config(arch, smoke=True).layout}
        check(got["cover_dp"] > 0 and all(got[k] > 0 for k in kinds),
              f"phase18 launcher {arch}: launches {got}")
        print(f"phase18 launch.train.main(['--arch', '{arch}', '--steps', "
              f"'6']) on the default device: arch {res['arch']}, first loss "
              f"{res['first_loss']:.4f}, final loss {res['final_loss']:.4f},"
              f" interrupts handled {res['interrupts_handled']}; launches "
              f"{got}")
    print(f"phase18c took {time.perf_counter() - t0:.1f} s")
    print(f"phase18 launches: {dict(launches)}; took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": dict(launches)}

if __name__ == "__main__":
    sys.exit(main())
