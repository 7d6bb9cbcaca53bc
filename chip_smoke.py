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
   ``score`` against ``score_plain`` (bitwise); times the kernels, the
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
   largest logit difference between the two.

Every phase that fails raises, and the script exits non-zero.  Kernel
times are device times (``cuda_ms``: CUDA events around back-to-back
calls queued behind a sleep kernel).  The line before the last is the
kernel record (times, launches on the main paths, bounds); the last line
is ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card and ``nvcc`` (``CUDA_HOME``, default ``/usr/local/cuda``).
"""

from __future__ import annotations

import collections
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks: HBM3 bandwidth, the non-tensor float64 and
#: float32 rates, the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
#: special-function-unit rate (exp): 132 SMs x 16 MUFU results a clock
#: (CUDA programming guide, compute capability 9.0) x 1.98 GHz boost clock
SFU_OPS_PER_S = 132 * 16 * 1.98e9
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    print(json.dumps(run(torch.device("cuda"))))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run(dev) -> dict:
    """Phases 1-10 on ``dev`` (5-7 in :func:`run_fused`, 8-10 in
    :func:`run_serving`); returns the kernel record."""
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
    return {"kernels": kernels + fused + run_serving(dev)}


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


def attn_flops(b, sq, skv, h, kv, hd, causal=True, q_offset=0):
    """4 hd flops (S = Q K^T and P V) per valid (query, key) pair."""
    qpos = q_offset + np.arange(sq)
    pairs = int(np.minimum(qpos + 1, skv).sum()) if causal else sq * skv
    return 4 * hd * pairs * b * h


def attn_bound(b, sq, skv, h, kv, hd, elem, causal=True, q_offset=0):
    """q, k, v read and o, lse written once over HBM; or
    :func:`attn_flops` over the dense bf16 tensor-core rate."""
    nbytes = elem * (2 * b * sq * h * hd + 2 * b * skv * kv * hd) \
        + 4 * b * sq * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = attn_flops(b, sq, skv, h, kv, hd, causal, q_offset) \
        / BF16_TC_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_bound(b, s, di, n, elem):
    """x, dt, B, C, A, D read and y, h_final written once over HBM; or the
    exps (one per (b, t, d, n)) over the SFU rate, or the 6 float32 ops per
    (b, t, d, n) and 3 per (b, t, d) over the float32 rate, whichever is
    longer."""
    nbytes = elem * (3 * b * s * di + 2 * b * s * n) + 4 * (di * n + di) \
        + 4 * b * di * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_exp = b * s * di * n / SFU_OPS_PER_S * 1e3
    t_flop = (6 * b * s * di * n + 3 * b * s * di) / FP32_OPS_PER_S * 1e3
    t_ops = max(t_exp, t_flop)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def run_serving(dev) -> list:
    """Phases 8-10 on ``dev``: the serving path; returns the kernel records
    of ``flash_attention`` and ``mamba_scan``."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (VARIANTS,
                                                     flash_attention_cuda)
    from repro_torch.kernels.mamba_scan import (MAX_STATE,
                                                selective_scan_cuda)
    from repro_torch.launch.serve import serve
    from repro_torch.models import count_params, init_params
    from repro_torch.serving import decode_fn, prefill_fn

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
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    timed = {"kernel": lambda: flash_attention_cuda(q, k, v),
             "sdpa": lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True)}
    turns = {"kernel": [], "sdpa": []}
    for who in ("kernel", "sdpa", "sdpa", "kernel"):
        turns[who].append(cuda_ms(torch, timed[who], 20))
    a_ms, al_ms = median(turns["kernel"]), median(turns["sdpa"])
    ap_ms = cuda_ms(torch, lambda: ref.flash_fwd_chunked(
        q, k, v, q_chunk=1024, kv_chunk=1024), 5)
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
    del q, k, v, qt, kt, vt

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

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    def breakdown(cfg, params, label, B, S):
        """Device time of one prefill and one decode step of a batch, by
        kernel (torch.profiler)."""
        prompt = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (B, S))).to(dev)}
        _, caches = prefill_fn(params, prompt, cfg=cfg, max_len=S + 2)
        nxt = {"tokens": prompt["tokens"][:, :1]}
        decode_fn(params, caches, nxt, S, cfg=cfg)            # warm
        for what, fn in (("prefill", lambda: prefill_fn(
                params, prompt, cfg=cfg, max_len=S + 2)),
                         ("decode step", lambda: decode_fn(
                             params, caches, nxt, S + 1, cfg=cfg))):
            wall, busy, top = traced(torch, fn)
            ours = [(k, v) for k, v in top
                    if "flash_" in k or "scan_kernel" in k]
            print(f"phase9 trace {label} {what} (B {B}, S {S}): traced wall "
                  f"{wall:.3f} ms, device busy {busy:.3f} ms (idle share "
                  f"{1 - busy / wall:.4f}); by kernel: " + "; ".join(
                      f"{k} {v:.3f} ms" for k, v in top[:6])
                  + "; the port's kernels: " + ("; ".join(
                      f"{k} {v:.3f} ms" for k, v in ours) or "none"))

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
    release()
    cfg = get_config("falcon-mamba-7b")
    params = init_params(cfg, gen.manual_seed(1), dev)
    check(count_params(cfg) == 7_272_665_088, "falcon-mamba parameter count")
    served(cfg, params, "falcon-mamba-7b", requests=8, batch=4,
           prompt_len=1024, new_tokens=16)
    breakdown(cfg, params, "falcon-mamba-7b", 4, 1024)
    del params
    release()
    print(f"phase9 took {time.perf_counter() - t_phase:.1f} s")

    # -- phase 10: the slice held on the card --------------------------------
    t_phase = time.perf_counter()

    def greedy(cfg, params, prompt, steps):
        logits, caches = prefill_fn(params, prompt, cfg=cfg,
                                    max_len=prompt["tokens"].shape[1] + steps)
        outs = [logits]
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        toks = [nxt]
        for i in range(steps):
            logits, caches = decode_fn(params, caches, {"tokens": nxt},
                                       prompt["tokens"].shape[1] + i, cfg=cfg)
            outs.append(logits)
            nxt = torch.argmax(logits[:, -1:], dim=-1)
            toks.append(nxt)
        return outs, torch.cat(toks, dim=1)

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
        release()

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
        release()
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


if __name__ == "__main__":
    sys.exit(main())
