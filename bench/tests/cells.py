"""Small cells for the CPU tests: the real cells' traffic kinds, metric
readers and limits, at the port's smoke widths, written as new files into
a directory of their own (a cell added by files alone)."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from bench import harness

SMALL_CONFIGS = {
    "internlm2-small": {
        "hidden_size": 64, "intermediate_size": 128,
        "num_attention_heads": 4, "num_key_value_heads": 2,
        "num_hidden_layers": 2, "vocab_size": 256, "rope_theta": 1e6,
        "tie_word_embeddings": False,
        "reference": {"block": ["attn", "mlp"], "norm_eps": 1e-05},
        "port": {"arch": "internlm2-1.8b", "smoke": True,
                 "fields": {"d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                            "d_ff": 128, "vocab_size": 256}},
    },
    "falcon-mamba-small": {
        "hidden_size": 64, "expand": 2, "state_size": 8, "conv_kernel": 4,
        "time_step_rank": 4, "num_hidden_layers": 2, "vocab_size": 256,
        "tie_word_embeddings": False,
        "reference": {"block": ["mamba", "none"], "norm_eps": 1e-05},
        "port": {"arch": "falcon-mamba-7b", "smoke": True,
                 "fields": {"d_model": 64, "d_inner": 128, "ssm_state": 8,
                            "dt_rank": 4, "vocab_size": 256}},
    },
}

SMALL_TRAFFIC = {
    "train-small": {"batch": 2, "seq": 32, "checked_steps": 3},
    "prefill-small": {"batch": 2, "prompt": 32, "max_len": 32,
                      "checked_rows": 3},
    "decode-small": {"batch": 4, "context": 16, "max_len": 40,
                     "warmup_steps": 40, "checked_rows": 4},
}

#: limits of the small cells' control test, set as the cells' own are
#: (bench/limits/), from the small cells' readings on the CPU: the port in
#: float32 reads under 1e-6 on every number, the reference in fp8 in its
#: place 1e-4 or more on the losses, 3e-3 or more on the others; the cells'
#: own limits are set at full width, where fp8 errors are larger
SMALL_LIMITS = {
    "train": {"loss_gap": 1e-5, "grad_gap": 1e-4, "change_gap": 1e-4},
    "prefill": {"logit_gap": 1e-3},
    "decode": {"served_gap": 1e-3},
}

#: small cell -> (configuration, traffic, the cell whose traffic kind and
#: limits it takes)
SMALL_CELLS = {
    "internlm2-small.train": ("internlm2-small", "train-small",
                              "internlm2-1.8b.train-4k"),
    "falcon-mamba-small.train": ("falcon-mamba-small", "train-small",
                                 "falcon-mamba-7b.train-4k"),
    "internlm2-small.prefill": ("internlm2-small", "prefill-small",
                                "internlm2-1.8b.prefill-32k"),
    "internlm2-small.decode": ("internlm2-small", "decode-small",
                               "internlm2-1.8b.decode-32k"),
}

#: the traffic file of each cell named above
LIKE_TRAFFIC = {"internlm2-1.8b.train-4k": "train-4k",
                "falcon-mamba-7b.train-4k": "train-4k",
                "internlm2-1.8b.prefill-32k": "prefill-32k",
                "internlm2-1.8b.decode-32k": "decode-32k"}

#: each traffic kind's metrics: end to end, and read in a traced run
METRICS = {
    "train": (["train_tokens_per_s"], ["mfu.train", "device_idle.train"]),
    "prefill": (["prefill_tokens_per_s"],
                ["mfu.prefill", "ttft_p50_ms.prefill",
                 "device_idle.prefill"]),
    "decode": (["decode_tokens_per_s", "tpot_p95_ms"],
               ["mfu.decode", "device_idle.decode"]),
}


def _metric(name, workloads, moves=None):
    entry = {"name": name, "unit": "-", "better": "higher",
             "source": "host_clock", "workloads": workloads}
    if moves:
        entry.update(layer="small", moves=moves)
    return entry


def write_cells(root: Path, dtype: str = "float32") -> Path:
    """A benchmark directory at ``root`` holding the small cells; the port
    computes in ``dtype``."""
    bench = root / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(harness.ROOT / "bench" / "metrics", bench / "metrics")
    configs, workloads = [], []
    for name, cfg in SMALL_CONFIGS.items():
        cfg = dict(cfg, name=name)
        cfg["port"] = dict(cfg["port"], overrides={"dtype": dtype})
        path = bench / "configs" / f"{name}.json"
        path.write_text(json.dumps(cfg))
        configs.append({"name": name, "file": str(path.relative_to(root))})
    e2e, per_layer = {}, {}
    for cell, (config, traffic, like) in SMALL_CELLS.items():
        real = harness.read_json(harness.ROOT / "bench" / "traffic"
                                 / f"{LIKE_TRAFFIC[like]}.json")
        small = dict(SMALL_TRAFFIC[traffic], kind=real["kind"],
                     trace_units=2)
        for key in ("optimizer", "z_loss_weight"):
            if key in real:
                small[key] = real[key]
        (bench / "traffic" / f"{cell}.json").write_text(json.dumps(small))
        shutil.copy(harness.ROOT / "bench" / "limits" / f"{like}.json",
                    bench / "limits" / f"{cell}.json")
        workloads.append({"name": cell, "config": config, "traffic": cell,
                          "chips": 1})
        rates, layered = METRICS[real["kind"]]
        for m in rates:
            e2e.setdefault(m, []).append(cell)
        for m in layered:
            per_layer.setdefault(m, (rates[0], []))[1].append(cell)
    spec = {"configs": configs, "workloads": workloads,
            "end_to_end": [_metric(m, c) for m, c in e2e.items()]
            + [{"name": "setup_s", "unit": "s", "better": "lower",
                "source": "host_clock"}],
            "per_layer": [_metric(m, c, moves)
                          for m, (moves, c) in per_layer.items()]}
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
