"""Readings for the limits of ``correct``: runs of one cell in one process,
each with its own seed, and the control on some of them.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 1 --seconds 20 [--out FILE]

Each run is a whole run of the cell (set-up, window, check); on a control
seed the check also reads the control (the reference in fp8 in the
program's place) and, for training, the fault of half the batch left out.
One JSON line a run goes to ``--out`` (and to standard output).
"""

import json
import os
import sys
import time


def main(argv=None) -> int:
    import argparse

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root, os.path.join(root, "src")] + [
        p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    import torch

    from bench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        result, numbers, ctrl = harness.run(cell, seed, args.seconds, False,
                                            device, t0, seed in controls)
        line = json.dumps({"workload": cell.name, "seed": seed,
                           "numbers": numbers, "control": ctrl,
                           "wall_s": time.perf_counter() - t0,
                           "result": result})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
