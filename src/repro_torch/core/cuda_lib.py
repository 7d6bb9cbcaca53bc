"""Build and load the port's CUDA library.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library in
``build/kernels/`` of the checkout, at first use.  The library's name holds
a hash of every source and header plus the flags, so an edit rebuilds it.
It has a plain C interface and is loaded with ``ctypes``; each kernel's
wrapper (``cover_dp``, ``fused_rows``, ``score``, ``flash_attention_cuda``,
``selective_scan_cuda``, ``selective_scan_bwd_cuda``) takes its launch
function from :func:`library`.

``--fmad=false`` is a flag of every source: the fused row solver and the
score take products whose rounding must match the host's.  The two
sequence kernels are held to tolerances, not bits; the attention kernel
asks for its inner-product FMAs explicitly (``fmaf``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: argument types of each launch function (pointers and the stream as
#: c_void_p: ctypes would otherwise pass a Python int as a 32-bit int)
LAUNCH_ARGTYPES = {
    "cover_dp_launch": [_P] * 10 + [_I, _I, _P],
    "fused_rows_launch": ([_P] * 8 + [_L, _L] + [_P] * 4 + [_L] * 4
                          + [_P] * 8 + [_I, _I, _I, _P, _P, _P]),
    "score_launch": [_P] * 6 + [_I, _L, _P],
    "flash_attention_launch": [_P] * 5 + [_I] * 10 + [_P],
    "mamba_scan_launch": [_P] * 9 + [_I] * 5 + [_P],
    "mamba_scan_bwd_launch": [_P] * 17 + [_L] + [_I] * 5 + [_P],
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("cuda_lib: nvcc not found (set CUDA_HOME)")
    return found


def _key() -> str:
    h = hashlib.blake2b(" ".join(NVCC_FLAGS).encode(), digest_size=8)
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def build() -> Tuple[Path, str]:
    """Compile and link ``csrc/*.cu`` unless a library of these exact
    sources and flags is already built; returns ``(library path, nvcc
    output)`` (empty when nothing was compiled)."""
    key = _key()
    lib = BUILD_DIR / f"libkubepacs_{key}.so"
    if lib.exists():
        return lib, ""
    work = BUILD_DIR / f"tmp_{key}_{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objects = [work / (src.stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(f"[{src.name}]\n{out}" for src, out in zip(sources, logs))
    failed = [src.name for src, proc in zip(sources, procs)
              if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"cuda_lib: nvcc failed on {failed}:\n{log}")
    tmp = work / lib.name
    proc = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objects)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"cuda_lib: link failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    shutil.rmtree(work, ignore_errors=True)
    build.compiles += 1
    return lib, log + proc.stdout + proc.stderr


#: libraries compiled by this process (the fused backend reports it as
#: ``program_builds``)
build.compiles = 0


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every launch
    function's ``argtypes`` declared (each returns the CUDA error code)."""
    path, _log = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in LAUNCH_ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
