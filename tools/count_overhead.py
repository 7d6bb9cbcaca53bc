#!/usr/bin/env python3
"""Seconds the cost model's memory account adds to a dry-run count.

Runs ``repro_torch.launch.dryrun.run_cell`` on each cell in turns with the
live-byte tracking of ``roofline.analyze_step`` off and on (off, on, on,
off, ...), ``--rounds`` pairs, and prints each cell's ``count_s`` lists
and, last, one JSON line of them.  The first count of a cell in a process
also warms DTensor's sharding-propagation caches, so read the warm ones.

    PYTHONPATH=src python tools/count_overhead.py --rounds 2

Runs on the CPU (the count is on ``meta``); it starts fake process groups,
so run it in a process of its own.
"""

from __future__ import annotations

import argparse
import json

from repro_torch import roofline
from repro_torch.launch import dryrun

#: (arch, shape, multi-pod): the dry-run test's cell and a train cell
CELLS = (("internvl2-1b", "decode_32k", True),
         ("internlm2-1.8b", "train_4k", False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    tracked = roofline._CostMode._created
    out = {}
    try:
        for arch, shape, multi_pod in CELLS:
            res = {"off": [], "on": []}
            for _ in range(args.rounds):
                for who in ("off", "on", "on", "off"):
                    roofline._CostMode._created = (
                        tracked if who == "on" else lambda self, out: None)
                    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod,
                                          verbose=False)
                    res[who].append(rec["count_s"])
            name = f"{arch} x {shape} x {'2x16x16' if multi_pod else '16x16'}"
            print(f"{name}: count_s tracking off {res['off']}, on "
                  f"{res['on']}", flush=True)
            out[name] = res
    finally:
        roofline._CostMode._created = tracked
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
