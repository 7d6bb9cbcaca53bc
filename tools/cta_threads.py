#!/usr/bin/env python3
"""Threads a CTA of the decision plane's two chain-bound kernels, timed on
one card.

``cover_dp`` (``kThreads`` of ``src/repro_torch/csrc/cover_dp.cuh``) at the
widest bits dispatch of the 250 x 5000 fleet tick, and ``fused_rows``
(``kRowThreads`` of ``csrc/fused_rows.cu``) at the three stacks that
``chip_smoke.py`` phase 5 times: the ``provision(5000)`` prescan, its first
golden round (one row at the full catalog's width) and the tick's first
golden round (32 rows, N = 250), the golden rows scoring their pools.

Each width is a copy of the sources with that one constant replaced,
compiled with the library's flags into its own shared library under
``build/cta_threads/`` (one ``nvcc`` a width, all started together) and
put in place of the library's launch function for the timed calls. Every
width is first held bitwise to the kernel's plain version; then the widths
are timed in turns, each once in a forward and once in a backward sweep,
with CUDA events (``chip_smoke.cuda_ms``). The sources in the tree are not
touched: their constants are what these runs chose.

Usage: ``python3 tools/cta_threads.py`` from the root of a checkout, on a
machine with one H100 and ``nvcc`` (``CUDA_HOME``, default
``/usr/local/cuda``). Prints the card, one line a (kernel, width) with
``ptxas``'s registers and spills, and writes the same to
``build/cta_threads/cta_threads.json``.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

#: kernel -> (file holding the constant, its pattern, source to compile,
#: launch function, widths)
VARIANTS = {
    "cover_dp": ("cover_dp.cuh", r"constexpr int kThreads = \d+;",
                 "constexpr int kThreads = {};", "cover_dp.cu",
                 "cover_dp_launch", (256, 384, 512, 1024)),
    "fused_rows": ("fused_rows.cu", r"constexpr int kRowThreads = \d+;",
                   "constexpr int kRowThreads = {};", "fused_rows.cu",
                   "fused_rows_launch", (512, 640, 768, 1024)),
}
TOLERANCE = 0.01


def fake_timer() -> float:
    return 0.0


def build_all(cuda_lib):
    """Starts one ``nvcc`` a (kernel, width), waits for all; returns
    ``{(kernel, width): (library path, ptxas log)}``."""
    out_dir = ROOT / "build" / "cta_threads"
    procs = {}
    for kernel, (header, pat, repl, src, _fn, widths) in VARIANTS.items():
        for w in widths:
            d = out_dir / f"{kernel}_{w}"
            d.mkdir(parents=True, exist_ok=True)
            for f in cuda_lib.CSRC.glob("*.cu*"):
                text = f.read_text()
                if f.name == header:
                    text, n = re.subn(pat, repl.format(w), text)
                    assert n == 1, f"{header}: {pat} not found once"
                (d / f.name).write_text(text)
            lib = d / f"lib{kernel}_{w}.so"
            procs[(kernel, w)] = (lib, subprocess.Popen(
                [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                 str(lib), str(d / src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"cta_threads: nvcc failed for {key}:\n{log}")
        built[key] = (lib, log)
    return built


def load(cuda_lib, kernel, path):
    fn_name = VARIANTS[kernel][4]
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, fn_name)
    fn.argtypes = cuda_lib.LAUNCH_ARGTYPES[fn_name]
    fn.restype = ctypes.c_int
    return types.SimpleNamespace(**{fn_name: fn})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cta_threads: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import (FusedTorchBackend, KubePACSProvisioner,
                                  NumpyBackend, Request, compile_market,
                                  cuda_lib, generate_catalog, preprocess)
    from repro_torch.core import cover_dp as cdp
    from repro_torch.core import fused_rows as fr
    from repro_torch.core.gss import bracketed_gss_many

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    built = build_all(cuda_lib)
    libs = {key: load(cuda_lib, key[0], path)
            for key, (path, _log) in built.items()}
    home = {}
    for kernel, (header, pat, _r, _s, _f, _w) in VARIANTS.items():
        text = (cuda_lib.CSRC / header).read_text()
        home[kernel] = int(re.search(pat.replace(r"\d+", r"(\d+)"),
                                     text).group(1))

    def use(kernel, w):
        mod = cdp if kernel == "cover_dp" else fr
        mod.library = lambda lib=libs[(kernel, w)]: lib

    # the widest bits dispatch of the 250 x 5000 tick: the dispatches do
    # not depend on the backend, so the host engine records them
    big = generate_catalog(seed=0, max_offerings=2000)
    items = preprocess(big, Request(pods=5000, cpu_per_pod=2,
                                    mem_per_pod=2))[:250]
    market = compile_market(items)
    jr = np.random.default_rng(0)
    demands = [int(5000 * (1 + 0.15 * (2 * jr.random() - 1)))
               for _ in range(32)]

    class Widest(NumpyBackend):
        max_group_batch = 1 << 30       # one dispatch a round, as on the card
        widest = (0, [])

        def cover_bits(self, groups):
            size = sum(len(g[0]) * (g[2] + 1) for g in groups)
            if size > self.widest[0]:
                self.widest = (size, list(groups))
            return super().cover_bits(groups)

    rec = Widest()
    bracketed_gss_many(items, demands, tolerance=TOLERANCE, market=market,
                       timer=fake_timer, backend=rec)
    batch = cdp.CoverBatch.build(rec.widest[1], dev)

    # the phase-5 stacks, captured through the tree's own width
    class Capture(FusedTorchBackend):
        def __init__(self, device):
            super().__init__(device)
            self.rows = []

        def _rows(self, *args, score_req=None):
            self.rows.append((args, score_req))
            return FusedTorchBackend._rows(self, *args, score_req=score_req)

    use("fused_rows", home["fused_rows"])
    use("cover_dp", home["cover_dp"])
    catalog = generate_catalog(seed=0)
    cap_p, cap_t = Capture(dev), Capture(dev)
    KubePACSProvisioner(timer=fake_timer, backend=cap_p).provision(
        Request(pods=5000, cpu_per_pod=2, mem_per_pod=2,
                workload={"network"}), catalog)
    bracketed_gss_many(items, demands, tolerance=TOLERANCE, market=market,
                       timer=fake_timer, backend=cap_t)
    budget = cap_p.bits_budget
    stacks = {"prescan of provision 5000": cap_p.rows[0],
              "golden round of provision 5000": cap_p.rows[2],
              "golden round of tick 250x5000": cap_t.rows[2]}

    def cover_call():
        return cdp.cover_dp(batch, True)

    def rows_call(stack):
        (dm, coefs, actives, reqs, coarse, max_req), score_req = stack
        return fr.fused_rows(dm, coefs, actives, reqs, coarse, max_req,
                             budget, score_req=score_req)

    # every width held bitwise to the plain version first
    dp_p, bits_p = cdp.cover_dp_plain(batch, True)
    plain_rows = {name: fr.fused_rows_plain(
        *st[0], score_req=st[1]) for name, st in stacks.items()}
    for (kernel, w) in libs:
        use(kernel, w)
        if kernel == "cover_dp":
            dp_k, bits_k = cover_call()
            torch.cuda.synchronize()
            cs.check(torch.equal(dp_k, dp_p) and torch.equal(bits_k, bits_p),
                     f"cover_dp at {w} threads != plain version")
            continue
        for name, st in stacks.items():
            got = rows_call(st)
            torch.cuda.synchronize()
            cs.check(all(a.cpu().numpy().tobytes() == b.cpu().numpy()
                         .tobytes() for a, b in zip(got, plain_rows[name])),
                     f"fused_rows at {w} threads, {name}: != plain version")

    cases = [("cover_dp", "widest dispatch of tick 250x5000", cover_call)]
    cases += [("fused_rows", name, lambda st=st: rows_call(st))
              for name, st in stacks.items()]
    times = {}
    for kernel, name, fn in cases:
        widths = VARIANTS[kernel][5]
        for w in list(widths) + list(reversed(widths)):
            use(kernel, w)
            times.setdefault((kernel, name, w), []).append(
                cs.cuda_ms(torch, fn, 20))
        use(kernel, home[kernel])
    chain = max(len(g[0]) for g in rec.widest[1])
    out = []
    for (kernel, name, w), ms in times.items():
        regs = cs.ptxas_summary(built[(kernel, w)][1])
        line = {"kernel": kernel, "shape": name, "threads": w,
                "ms": ms, "mean_ms": float(np.mean(ms)), "ptxas": regs}
        if kernel == "cover_dp":
            line["ns_per_bundle_step"] = float(np.mean(ms)) * 1e6 / chain
        out.append(line)
        print(f"cta_threads {kernel} at {name}: {w} threads: ms "
              + " ".join(f"{t:.4f}" for t in ms)
              + f" (mean {np.mean(ms):.4f})"
              + (f", {line['ns_per_bundle_step']:.1f} ns a bundle step of "
                 f"the longest group ({chain} bundles)"
                 if kernel == "cover_dp" else "")
              + f"; {regs}")
    with open(ROOT / "build" / "cta_threads" / "cta_threads.json", "w") as f:
        json.dump({"device": smi, "results": out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
