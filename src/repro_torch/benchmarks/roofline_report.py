"""§Roofline summary: reads the dry-run JSONL at the repository root
(``dryrun_*.jsonl``, as ``python -m repro_torch.launch.dryrun --out``
writes it) and prints the per-cell three-term roofline table.  The
port's records carry the reference's keys (``compute_s``, ``memory_s``,
``collective_s``, ``bound``, ``roofline_fraction``, ``mfu_bound``),
counted on ``meta`` against the H100's peaks.

Usage:
  python -m repro_torch.benchmarks.roofline_report
"""

import glob
import json
import os

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def load(paths=None):
    paths = paths or sorted(glob.glob(os.path.join(REPO, "dryrun_*.jsonl")))
    rows = []
    for p in paths:
        with open(p) as f:
            for line in f:
                rec = json.loads(line)
                rec["_file"] = os.path.basename(p)
                rows.append(rec)
    return rows


def run():
    rows = load()
    ok = [r for r in rows if r.get("status") == "ok"]
    skipped = [r for r in rows if r.get("status") == "skipped"]
    failed = [r for r in rows if r.get("status") == "failed"]
    return {"rows": rows, "ok": len(ok), "skipped": len(skipped),
            "failed": len(failed), "us_per_call": 0.0}


def main():
    out = run()
    print(f"roofline_report,0,cells_ok={out['ok']};"
          f"skipped={out['skipped']};failed={out['failed']}")
    for r in out["rows"]:
        if r.get("status") != "ok":
            continue
        print(f"#  {r['arch']:>22s} {r['shape']:>11s} {r['mesh']:>7s} "
              f"c={r['compute_s']:.3f}s m={r['memory_s']:.3f}s "
              f"n={r['collective_s']:.3f}s bound={r['bound']:<10s} "
              f"frac={r['roofline_fraction']:.3f} "
              f"mfu≤{r['mfu_bound']:.3f}")
    return out


if __name__ == "__main__":
    main()
