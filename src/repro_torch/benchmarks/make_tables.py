"""Render the dry-run and roofline tables (markdown) from the dry-run
JSONL that ``python -m repro_torch.launch.dryrun --out`` writes.

    PYTHONPATH=src python -m repro_torch.benchmarks.make_tables dryrun_baseline.jsonl
"""

import json
import sys


def fmt_bytes(b):
    return f"{b/1e9:.1f}"


def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def dryrun_table(rows):
    out = ["| arch | shape | mesh | status | compile s | GB/device (args+temp) | collectives |",
           "|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "ok":
            gb = (r["arg_bytes_per_device"]
                  + (r["memory_analysis"].get("temp_bytes") or 0)) / 1e9
            colls = ", ".join(f"{k}:{v/1e9:.1f}GB"
                              for k, v in sorted(r["collectives"].items()))
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                       f"{r['compile_s']:.0f} | {gb:.1f} | {colls or '—'} |")
        elif r["status"] == "skipped":
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"skipped | — | — | {r['reason'][:60]}… |")
        else:
            out.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                       f"**FAILED** | — | — | {r.get('error','')[:60]} |")
    return "\n".join(out)


def roofline_table(rows):
    out = ["| arch | shape | mesh | compute s | memory s | collective s | "
           "bound | roofline frac | MODEL_FLOPs/HLO | MFU bound |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] != "ok":
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compute_s']:.3f} | {r['memory_s']:.3f} | "
            f"{r['collective_s']:.3f} | {r['bound']} | "
            f"{r['roofline_fraction']:.3f} | {r['model_flops_ratio']:.3f} | "
            f"{r['mfu_bound']:.4f} |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    rows = load(argv[0] if argv else "dryrun_baseline.jsonl")
    print("### Dry-run table\n")
    print(dryrun_table(rows))
    print("\n### Roofline table\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
