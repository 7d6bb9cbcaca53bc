#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's decision plane (``src/repro_torch``) on the card at the
system's real sizes and holds every result to the host:

1. prints the card (``nvidia-smi``) and builds the cover-DP kernel from
   ``src/repro_torch/csrc/cover_dp.cu``;
2. holds the kernel to its plain torch version on the card and to the host
   NumPy oracle — dp bytes and bits exactly — on the ``_run_pallas_check``
   case, a ragged stack of 300 groups with targets up to 8192, and a stack
   with a group too wide for shared memory; times the kernel, the plain
   version and the host at the widest shape;
3. ``KubePACSProvisioner().provision`` (default backend: the card) on the
   full 9,792-offering catalog at 1000 and 5000 pods, equal to the NumPy
   backend's decision;
4. a fleet tick — ``SolveBatch("torch")`` over 32 jittered decisions — at
   100 items x 1000 pods and 250 items x 5000 pods, equal to NumPy's.

Every phase that fails raises, and the script exits non-zero.  The line
before the last is the kernel record (times, launches on the main path,
bound); the last line is ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card and ``nvcc`` (``CUDA_HOME``, default ``/usr/local/cuda``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM data-sheet peaks: HBM3 bandwidth and the non-tensor float64 rate
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
TOLERANCE = 0.01


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def median(xs):
    return float(np.median(np.asarray(xs, dtype=np.float64)))


def fake_timer() -> float:
    return 0.0


def cuda_ms(torch, fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
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


def wall_s(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return median(times)


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
    """Phases 1-4 on ``dev``; returns the kernel record."""
    import torch

    from repro_torch.core import (KubePACSProvisioner, NumpyBackend, Request,
                                  SolveBatch, TorchBackend, compile_market,
                                  generate_catalog, get_backend, preprocess)
    from repro_torch.core import cover_dp as cdp
    from repro_torch.core.gss import bracketed_gss_many

    # -- phase 1: build --------------------------------------------------
    t0 = time.perf_counter()
    lib, log = cdp.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"phase1 build: {lib.name} in {build_s:.3f} s; " + " | ".join(ptxas))

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
    print(f"phase2 top shape: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
          f"host numpy {h_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

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
        print(f"kernel at {name} widest dispatch: G={len(groups)} sum B="
              f"{batch.n_bundles} max T={int(batch.targets.max())} bits "
              f"{timed.widest[0]} B: kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
              f"host numpy {h_ms:.4f} ms bound {b_ms:.6f} ms ({b_by})")
        record = (err, k_ms, p_ms, b_ms, b_by)     # the last: the 250x5000 tick
    err, k_ms, p_ms, b_ms, b_by = record

    return {"kernels": [{
        "name": "cover_dp", "route": "cuda",
        "source": "src/repro_torch/csrc/cover_dp.cu",
        "replaces": "src/repro/core/backend.py:329 (relax_kernel); "
                    "src/repro/core/backend.py:635 (_cover_kernel)",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}


if __name__ == "__main__":
    sys.exit(main())
