"""The port's simulation, training and report drivers
(``repro_torch.benchmarks``: ``bench_fleet``, ``bench_serve``,
``elastic_training``, ``roofline_report``, ``make_tables`` and the
runner's ``ALL``) against the reference's ``benchmarks/`` on the CPU.

The reference solves on ``numpy``, the port on ``"torch:cpu"`` (the
cover-DP kernel's plain version); the serving perf model is pinned to
``analytic`` for both (the reference's ``"auto"`` is its roofline mode
whenever JAX imports).  Records are compared once the walls, their rates
and ratios and the host's platform fields are dropped (``without``), lines
with the walls masked (``masked_csv``), and each bench writes nothing but
its ``--json`` path.  The scenario engines build the same few catalogs
over and over: each package's ``generate_catalog`` is run once a seed and
size here.  elastic_training trains different initial parameters in the
two packages (a JAX and a torch generator), so its interrupts, trace
records and the sign of its loss drop are held, both at 12 of its 40
steps.  The dry-run record the reports read is the port's own, written
by ``python -m repro_torch.launch.dryrun`` in a subprocess.
"""

import importlib
import json
import os
import re
import subprocess
import sys

import jax
import pytest

import benchmarks.elastic_training as ref_elastic
import benchmarks.make_tables as ref_tables
import benchmarks.roofline_report as ref_report
import benchmarks.run as ref_run
import repro.serve_sim as ref_serve
import repro.sim.scenario as ref_scenario
import repro_torch.serve_sim as port_serve
import repro_torch.sim.scenario as port_scenario
from repro.core import backend as ref_backend_mod
from repro.runtime import ElasticConfig as RefElasticConfig
from repro_torch.benchmarks import (elastic_training, make_tables,
                                    roofline_report)
from repro_torch.benchmarks import run as port_run
from repro_torch.benchmarks.common import (PLATFORM_FIELDS, WALL_FIELDS,
                                           masked_csv, without)
from repro_torch.core import backend as backend_mod
from tests.test_torch_examples import catalog_once

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = WALL_FIELDS + PLATFORM_FIELDS
#: bench -> the reference's smoke record (fields dropped) and its line
REFERENCE = {}
#: elastic_training's cut: 12 of the reference's 40 steps (one interrupt)
ELASTIC_STEPS = 12


@pytest.fixture(autouse=True)
def backends_on_host(monkeypatch):
    for module in (ref_scenario, port_scenario):
        monkeypatch.setattr(module, "generate_catalog", catalog_once(module))
    monkeypatch.setenv("KUBEPACS_SERVE_PERF", "analytic")
    ref_serve.clear_caches()
    port_serve.clear_caches()
    saved = backend_mod._DEFAULT, ref_backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    ref_backend_mod.set_backend("numpy")
    yield
    backend_mod._DEFAULT, ref_backend_mod._DEFAULT = saved
    ref_serve.clear_caches()
    port_serve.clear_caches()


def reference_smoke(name, capsys):
    if name not in REFERENCE:
        ref = importlib.import_module(f"benchmarks.{name}")
        capsys.readouterr()
        record = ref.main(["--smoke"])
        REFERENCE[name] = without(record, FIELDS), capsys.readouterr().out
    return REFERENCE[name]


def port_smoke(name, capsys, tmp_path, monkeypatch):
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    got = port.main(["--smoke", "--json", "record.json"])
    line = capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == ["record.json"]
    assert json.loads((tmp_path / "record.json").read_text()) == json.loads(
        json.dumps(got))
    assert line.startswith(f"{name},") and line.count("\n") == 1
    return got, line


# ----------------------------------------------------------- bench_fleet ----

def test_bench_fleet_matches_reference(capsys, tmp_path, monkeypatch):
    """Storm, crunch and hetero at ``--smoke``: the equality gate held
    (fleet = run_replicas), memo hit rates and every ``fleet_stats``
    counter the reference's — the same counter names, none dropped — with
    the rates, speedups and their verdicts masked."""
    want, want_line = reference_smoke("bench_fleet", capsys)
    got, line = port_smoke("bench_fleet", capsys, tmp_path, monkeypatch)
    assert without(got, FIELDS) == want
    assert got["equality_checked"] is True
    for scenario in ("storm", "crunch", "hetero"):
        assert got[scenario]["fleet_stats"]["memo_hits"] > 0, scenario
    assert masked_csv(line) == masked_csv(want_line)
    assert "meets_target" not in want["headline"]
    assert "hetero_meets_target" not in want["headline"]


def test_bench_fleet_through_the_fused_plane():
    """bench_fleet's scenarios at 8 replicas under ``"torch:fused:cpu"``:
    the reference's record but for the fused backend's own counters in
    ``fleet_stats`` (``device_cache_*``, which a ``numpy`` fleet has not),
    the fleets through the fused record with no fallback solve."""
    from benchmarks import bench_fleet as ref_fleet
    from repro_torch.benchmarks import bench_fleet
    want = without(ref_fleet.run(smoke=True, fleet_replicas=8), FIELDS)
    backend = backend_mod.set_backend("torch:fused:cpu")
    got = without(bench_fleet.run(smoke=True, fleet_replicas=8), FIELDS)
    for scenario in ("storm", "crunch", "hetero"):
        stats = got[scenario]["fleet_stats"]
        cache = {k for k in stats if k.startswith("device_cache_")}
        assert cache == {"device_cache_hits", "device_cache_misses",
                         "device_cache_entries",
                         "device_cache_fallback_solves",
                         "device_cache_verify_solves",
                         "device_cache_program_builds"}, scenario
        assert stats["device_cache_fallback_solves"] == 0
        for k in cache:
            del stats[k]
    assert got == want
    assert backend.fused_records > 0
    assert backend.device_cache_info()["fallback_solves"] == 0


# ----------------------------------------------------------- bench_serve ----

def test_bench_serve_matches_reference(capsys, tmp_path, monkeypatch):
    """The diurnal workload's five policies at ``--smoke`` (analytic perf
    model): determinism held, zero infeasible decisions, every serving
    report the reference's."""
    want, want_line = reference_smoke("bench_serve", capsys)
    got, line = port_smoke("bench_serve", capsys, tmp_path, monkeypatch)
    assert without(got, FIELDS) == want
    assert got["perf_mode"] == "analytic" and got["determinism_checked"]
    assert got["headline"]["infeasible_decisions"] == 0
    assert masked_csv(line) == masked_csv(want_line)


def test_masked_csv_masks_the_sim_benches_walls():
    """bench_fleet's speedups and their verdict and elastic_training's
    step rate, recovery and provisioning walls are masked; the memo hit
    rates, loss drop, interrupts and trace records stay."""
    a = ("bench_fleet,4719,storm:75.2x@R128;crunch:41.6x;"
         "crunch_hit_rate=0.8752;hetero:3.18x@hit_rate=0.1369;"
         "target>=20.0x:met\n"
         "elastic_training,248086,steps_per_s=4.03;loss_drop=1.057;"
         "interrupts=2;recovery=0.05s;provision=0.08s;trace=32rec\n")
    b = ("bench_fleet,1,storm:7.1x@R128;crunch:4.6x;"
         "crunch_hit_rate=0.8752;hetero:0.9x@hit_rate=0.1369;"
         "target>=20.0x:MISSED\n"
         "elastic_training,1,steps_per_s=12.50;loss_drop=1.057;"
         "interrupts=2;recovery=1.25s;provision=10.50s;trace=32rec\n")
    assert masked_csv(a) == masked_csv(b)
    for old, new in (("=0.8752", "=0.8753"), ("@R128", "@R64"),
                     ("loss_drop=1.057", "loss_drop=1.058"),
                     ("interrupts=2", "interrupts=3"), ("=32rec", "=31rec")):
        assert masked_csv(a) != masked_csv(a.replace(old, new)), old
    # bench_chaos's verdict is no wall: it stays
    chaos = "bench_chaos,1,slo_ppd_ratio=2.8x;target>=1.3x:met\n"
    assert masked_csv(chaos) != masked_csv(chaos.replace("met", "MISSED"))


# ------------------------------------------------------ elastic_training ----

def test_elastic_training_matches_reference(capsys, tmp_path, monkeypatch):
    """12 steps of the smoke internlm2 through ``ElasticSpotTrainer`` on
    the pressure-interrupted market in each package (the reference's
    ``ElasticConfig`` cut to the same steps, x64 off): the same interrupts
    and trace records, a loss drop of the same sign, the line the
    reference's with the walls and the loss drop masked; nothing written
    where it runs."""
    monkeypatch.setattr(ref_elastic, "ElasticConfig", lambda **kw:
                        RefElasticConfig(**{**kw,
                                            "total_steps": ELASTIC_STEPS}))
    monkeypatch.setattr(elastic_training, "run", lambda run=elastic_training
                        .run: run(total_steps=ELASTIC_STEPS))
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    with jax.enable_x64(False):
        want = ref_elastic.main()
    want_line = capsys.readouterr().out
    got = elastic_training.main()
    line = capsys.readouterr().out
    assert list(tmp_path.iterdir()) == []
    assert got["interrupts_handled"] == want["interrupts_handled"] >= 1
    assert got["trace_records"] == want["trace_records"] > 0
    assert (got["loss_drop"] > 0) == (want["loss_drop"] > 0)
    assert set(got) == set(want)
    assert without(got, FIELDS + ("loss_drop",)) == without(
        want, FIELDS + ("loss_drop",))

    def masked(text):
        return masked_csv(re.sub(r"loss_drop=-?\d+\.\d+", "loss_drop=<l>",
                                 text))
    assert line.startswith("elastic_training,")
    assert masked(line) == masked(want_line)


def test_elastic_training_follows_the_default_device(monkeypatch):
    """With no device named the trainer runs where the process default
    solves (the CPU under ``torch:cpu``); ``numpy`` means the card, which
    a host without one refuses."""
    made = []

    class Trainer:
        def __init__(self, *args, device=None, **kw):
            made.append(device)
            raise StopIteration

    monkeypatch.setattr(elastic_training, "ElasticSpotTrainer", Trainer)
    for spec, want in (("torch:cpu", "cpu"), ("torch:fused:cpu", "cpu"),
                       ("numpy", "cuda")):
        backend_mod.set_backend(spec)
        with pytest.raises(StopIteration):
            elastic_training.run(total_steps=1)
        assert made[-1] == want, spec


# ----------------------------------------- roofline_report, make_tables ----

@pytest.fixture(scope="module")
def dryrun_rows(tmp_path_factory):
    """The port's dry-run record of internvl2-1b x decode_32k on the
    2x16x16 mesh (a phase-15d cell), beside a skipped and a failed cell."""
    out_file = tmp_path_factory.mktemp("dryrun") / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internvl2-1b", "--shape", "decode_32k", "--multi-pod",
         "--out", str(out_file)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    cell = json.loads(out_file.read_text().splitlines()[-1])
    assert cell["status"] == "ok"
    skipped = {"arch": "qwen2.5-14b", "shape": "long_500k", "mesh": "16x16",
               "status": "skipped", "reason": "full-attention arch at "
               "500k context: the score matrix does not fit a device"}
    failed = {"arch": "jamba-1.5-large-398b", "shape": "train_4k",
              "mesh": "2x16x16", "status": "failed",
              "error": "RuntimeError: no sharding rule"}
    return [cell, skipped, failed]


def test_roofline_report_matches_reference(dryrun_rows, tmp_path,
                                           monkeypatch, capsys):
    """Both reports over the same ``dryrun_*.jsonl`` files at a root: the
    same rows (each with its ``_file``), counts and printed table,
    ``cells_ok=1``; by default the report reads the repository root."""
    assert roofline_report.REPO == REPO
    (tmp_path / "dryrun_cell.jsonl").write_text(
        json.dumps(dryrun_rows[0]) + "\n")
    (tmp_path / "dryrun_more.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in dryrun_rows[1:]))
    monkeypatch.setattr(ref_report, "REPO", str(tmp_path))
    monkeypatch.setattr(roofline_report, "REPO", str(tmp_path))
    capsys.readouterr()
    want = ref_report.main()
    want_text = capsys.readouterr().out
    got = roofline_report.main()
    text = capsys.readouterr().out
    assert got == want
    assert (got["ok"], got["skipped"], got["failed"]) == (1, 1, 1)
    assert text == want_text
    assert text.startswith("roofline_report,0,cells_ok=1;skipped=1;"
                           "failed=1\n#  ")
    assert "internvl2-1b" in text and "bound=" in text


def test_make_tables_matches_reference(dryrun_rows, tmp_path, monkeypatch,
                                       capsys):
    """The dry-run and roofline tables of the port's records: the
    reference's text, by function and through ``main`` on a file."""
    assert make_tables.dryrun_table(dryrun_rows) == ref_tables.dryrun_table(
        dryrun_rows)
    assert make_tables.roofline_table(dryrun_rows) == \
        ref_tables.roofline_table(dryrun_rows)
    path = tmp_path / "dryrun_x.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in dryrun_rows))
    monkeypatch.setattr(sys, "argv", ["make_tables", str(path)])
    capsys.readouterr()
    ref_tables.main()
    want = capsys.readouterr().out
    make_tables.main()
    assert capsys.readouterr().out == want
    make_tables.main([str(path)])
    got = capsys.readouterr().out
    assert got == want
    assert "| internvl2-1b | decode_32k | 2x16x16 | ok |" in got
    assert "**FAILED**" in got and "skipped" in got


# ---------------------------------------------------------------- runner ----

def test_runner_lists_the_references_twenty_drivers(capsys):
    """``ALL`` is the reference's 20 names in the reference's order, each
    a module of the port with a ``main``."""
    assert [n for n, _ in port_run.ALL] == [n for n, _ in ref_run.ALL]
    assert len(port_run.ALL) == 20
    for name, mod in port_run.ALL:
        assert mod.__name__ == f"repro_torch.benchmarks.{name}"
        assert callable(mod.main)
    with pytest.raises(SystemExit):
        port_run.main(["--only", "nothing"])
    err = capsys.readouterr().err
    assert err.endswith(", ".join(n for n, _ in ref_run.ALL) + "\n")


def test_runner_runs_a_report_with_backend_and_device(tmp_path, monkeypatch,
                                                      capsys):
    """``--only roofline_report --json`` on the host: the driver's line and
    its record beside the backend and device, and no other file."""
    monkeypatch.setattr(roofline_report, "REPO", str(tmp_path / "root"))
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    port_run.main(["--only", "roofline_report", "--json", "out.json"])
    assert capsys.readouterr().out == (
        "name,us_per_call,derived\n"
        "roofline_report,0,cells_ok=0;skipped=0;failed=0\n")
    assert [p.name for p in tmp_path.iterdir()] == ["out.json"]
    record = json.loads((tmp_path / "out.json").read_text())
    assert record == {"roofline_report": {"rows": [], "ok": 0, "skipped": 0,
                                          "failed": 0, "us_per_call": 0.0},
                      "backend": "torch:cpu", "device": "cpu"}
