"""Run one benchmark cell once and print its result as the last line.

    python3 bench/run.py --workload W --seed N --seconds S --trace 0|1

from the root of a checkout (``src/`` beside ``bench/``).  The kernels'
build and every compiler cache stay in ``build/`` of the checkout.
"""

import os
import sys
import time

T_START = time.perf_counter()


def main(argv=None) -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    caches = os.path.join(root, "build", "bench_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(caches, sub)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root, os.path.join(root, "src")] + [
        p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    from bench import harness

    return harness.main(argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
