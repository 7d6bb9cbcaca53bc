"""The port's decision-plane benchmarks (``repro_torch.benchmarks``:
``bench_solver``, ``bench_backend``, ``bench_scale`` and ``perf_gate``)
against the reference's ``benchmarks/`` on the CPU, at ``--smoke``.

The reference solves on ``numpy``, the port on ``"torch:cpu"`` (the
cover-DP kernel's plain version); bench_backend's and bench_scale's device
legs follow the port's default to the CPU (``torch:cpu`` /
``torch:fused:cpu``).  The reference's JAX legs are switched off
(``jax_available`` patched to ``False`` in its bench's namespace), so its
records lack the device legs the port always runs: records are compared
on the keys both hold, once the walls, their ratios and the host's
platform fields are dropped (``without``), and the keys only one side
holds are named here — the deliberate differences (``*_jax*`` become
``*_torch*``; ``jax_available`` becomes ``backend`` / ``device``).  Lines
are compared with the walls masked (``masked_csv``).  Each bench writes
nothing but its ``--json`` path.  perf_gate's two behaviour tests are the
reference's ``tests/test_perf_gate.py``, against the port's gate and its
own two files.
"""

import importlib
import json
import os

import pytest

import benchmarks.bench_backend as ref_bench_backend
import benchmarks.bench_scale as ref_bench_scale
from repro.core import backend as ref_backend_mod
from repro_torch.benchmarks import common, perf_gate
from repro_torch.benchmarks.common import (PLATFORM_FIELDS, WALL_FIELDS,
                                           masked_csv, without)
from repro_torch.core import backend as backend_mod
from repro_torch.core import make_backend
from tests.test_torch_examples import catalog_once

FIELDS = WALL_FIELDS + PLATFORM_FIELDS
#: bench -> the reference's smoke record (fields dropped) and its line
REFERENCE = {}


@pytest.fixture(autouse=True)
def backends_on_host(monkeypatch):
    """The port's default on the host's plain versions, the reference's on
    ``numpy`` with its JAX legs off; each package's catalogs built once."""
    for module in (ref_bench_backend, ref_bench_scale,
                   importlib.import_module("benchmarks.common"),
                   importlib.import_module("repro_torch.benchmarks."
                                           "bench_backend"),
                   importlib.import_module("repro_torch.benchmarks."
                                           "bench_scale"),
                   common):
        monkeypatch.setattr(module, "generate_catalog", catalog_once(module))
    monkeypatch.setattr(ref_bench_backend, "jax_available", lambda: False)
    monkeypatch.setattr(ref_bench_scale, "jax_available", lambda: False)
    saved = backend_mod._DEFAULT, ref_backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    ref_backend_mod.set_backend("numpy")
    yield
    backend_mod._DEFAULT, ref_backend_mod._DEFAULT = saved


def reference_smoke(name, capsys):
    if name not in REFERENCE:
        ref = importlib.import_module(f"benchmarks.{name}")
        capsys.readouterr()
        record = ref.main(["--smoke"])
        REFERENCE[name] = without(record, FIELDS), capsys.readouterr().out
    return REFERENCE[name]


def port_smoke(name, capsys, tmp_path, monkeypatch, argv=()):
    """The port's ``main(["--smoke", "--json", ...])`` in an empty
    directory: its record (equal to what it wrote, the one file there)
    and its line."""
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    monkeypatch.chdir(tmp_path)
    capsys.readouterr()
    got = port.main(["--smoke", "--json", "record.json", *argv])
    line = capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == ["record.json"]
    assert json.loads((tmp_path / "record.json").read_text()) == json.loads(
        json.dumps(got))
    assert line.startswith(f"{name},") and line.count("\n") == 1
    return got, line


def split_keys(a, b, path=""):
    """``(a, b)`` cut to the keys both hold, at any depth, and the dotted
    paths of the keys only ``a`` holds and only ``b`` holds."""
    if isinstance(a, dict) and isinstance(b, dict):
        only_a = {f"{path}{k}" for k in a if k not in b}
        only_b = {f"{path}{k}" for k in b if k not in a}
        cut_a, cut_b = {}, {}
        for k in a.keys() & b.keys():
            cut_a[k], cut_b[k], oa, ob = split_keys(a[k], b[k],
                                                    f"{path}{k}.")
            only_a |= oa
            only_b |= ob
        return cut_a, cut_b, only_a, only_b
    if (isinstance(a, list) and isinstance(b, list) and len(a) == len(b)):
        cuts = [split_keys(x, y, f"{path}[]") for x, y in zip(a, b)]
        return ([c[0] for c in cuts], [c[1] for c in cuts],
                set().union(*(c[2] for c in cuts)),
                set().union(*(c[3] for c in cuts)))
    return a, b, set(), set()


# ---------------------------------------------------------- bench_solver ----

def test_bench_solver_matches_reference(capsys, tmp_path, monkeypatch):
    """The cycle's solves, bundles, residual, E_Total of both solvers and
    the seed's history-matrix size: the reference's record; the walls,
    speedups and ``tracemalloc`` peaks masked in the line."""
    want, want_line = reference_smoke("bench_solver", capsys)
    got, line = port_smoke("bench_solver", capsys, tmp_path, monkeypatch)
    assert without(got, FIELDS) == want
    assert masked_csv(line) == masked_csv(want_line)
    case = got["cases"][0]
    assert case["e_total_engine"] == case["e_total_reference"] > 0
    assert case["cycle_us_engine"] > 0 and case["solve_peak_bytes_engine"] > 0


# --------------------------------------------------------- bench_backend ----

#: the fleet tick's keys only the port's record holds (its device legs and
#: where they ran) and only the reference's (with its JAX legs off)
BACKEND_PORT_ONLY = {
    "configs.fleet_tick.backend", "configs.fleet_tick.device",
    "configs.fleet_tick.batched_torch_selections_equal_numpy",
    "configs.fleet_tick.fused_torch_selections_equal_numpy",
    "configs.fleet_tick.fused_fallback_solves"}
BACKEND_REF_ONLY = {"configs.fleet_tick.jax_available"}


def test_bench_backend_matches_reference(capsys, tmp_path, monkeypatch):
    """The fleet tick at ``--smoke``: equality gate held, the
    ``torch:cpu`` and ``torch:fused:cpu`` legs equal to NumPy's selections
    with no fallback solve, the shared keys the reference's, the line the
    reference's with ``fused_vs_jax`` named ``fused_vs_torch``."""
    want, want_line = reference_smoke("bench_backend", capsys)
    got, line = port_smoke("bench_backend", capsys, tmp_path, monkeypatch)
    cut_got, cut_want, port_only, ref_only = split_keys(
        without(got, FIELDS), want)
    assert cut_got == cut_want
    assert port_only == BACKEND_PORT_ONLY
    assert ref_only == BACKEND_REF_ONLY
    tick = got["configs"]["fleet_tick"]
    assert tick["equality_checked"] is True
    assert tick["batched_torch_selections_equal_numpy"] is True
    assert tick["fused_torch_selections_equal_numpy"] is True
    assert tick["fused_fallback_solves"] == 0
    assert (tick["backend"], tick["device"]) == ("torch:cpu", "cpu")
    for leg in ("batched_torch", "fused_torch", "batched_numpy",
                "sequential_numpy", "pr1"):
        assert tick[f"{leg}_wall_s"] >= 0, leg
    assert got["headline"]["fused_vs_per_dispatch_torch"] > 0
    assert got["scaling"] == []
    assert "fused_vs_torch:" in line and "n/a" not in line
    assert masked_csv(line) == masked_csv(
        want_line.replace("fused_vs_jax:", "fused_vs_torch:"))


def test_bench_backend_scaling_column_on_the_fused_plane():
    """The catalog-size scaling column through ``torch:fused:cpu``: every
    size's selections equal NumPy's with no fallback solve."""
    from repro_torch.benchmarks import bench_backend
    rows = bench_backend.bench_scaling((60, 120), n_dec=3, repeat=1)
    assert [r["offerings"] for r in rows] == [60, 120]
    for row in rows:
        assert row["selections_equal_numpy"] is True
        assert row["fused_fallback_solves"] == 0
        assert row["fused_steady_wall_s"] >= 0


def test_device_legs_need_a_card_or_the_cpu_named():
    """With no device named the legs follow the process default: the CPU
    under ``torch:cpu`` / ``torch:fused:cpu``, the card under ``numpy``,
    where a host without one raises unless the caller names the CPU."""
    assert common.device_specs() == ("torch:cpu", "torch:fused:cpu")
    backend_mod.set_backend("torch:fused:cpu")
    assert common.default_device() == "cpu"
    backend_mod.set_backend("numpy")
    assert common.device_specs() == ("torch", "torch:fused")
    assert common.device_specs("cpu") == ("torch:cpu", "torch:fused:cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_backend(common.device_specs()[1])
    with pytest.raises(ValueError):
        common.device_specs("tpu")


# ----------------------------------------------------------- bench_scale ----

def test_bench_scale_matches_reference(capsys, tmp_path, monkeypatch):
    """5 k, 20 k and 1 M pods: tiers, certificates and verification of
    every α the reference's (the ladder solved on ``torch:cpu``), the fused
    leg on ``torch:fused:cpu`` equal to NumPy at every scale, a fused
    record at 5 k and 20 k, none falling back."""
    want, want_line = reference_smoke("bench_scale", capsys)
    got, line = port_smoke("bench_scale", capsys, tmp_path, monkeypatch)
    cut_got, cut_want, port_only, ref_only = split_keys(
        without(got, FIELDS), want)
    assert cut_got == cut_want
    assert port_only == {"backend", "device", "fused_records",
                         "fused_fallback_solves",
                         "scales.[]fused_selection_equal_numpy"}
    assert ref_only == set()
    assert [r["pods"] for r in got["scales"]] == [5_000, 20_000, 1_000_000]
    assert all(r["fused_selection_equal_numpy"] for r in got["scales"])
    assert got["headline"]["verified_scales"] == [5_000, 20_000]
    assert (got["backend"], got["device"]) == ("torch:fused:cpu", "cpu")
    assert got["fused_records"] > 0 and got["fused_fallback_solves"] == 0
    assert masked_csv(line) == masked_csv(want_line)


def test_masked_csv_masks_the_decision_benches_walls():
    """bench_solver's cycle walls, speedup and peaks, bench_backend's walls
    and ratios (``n/a`` / ``None`` where a leg did not run) and
    bench_scale's ratio, verdict and 1 M wall are masked; the rest of a
    line stays."""
    a = ("bench_solver,2073,100x1000:2073us(vs508us,0.25x,mem57Kvs3347K)\n"
         "bench_backend,11750,numpy:0.094s;fused:1.097s(compile:0.92s);"
         "fused_vs_numpy:0.09x;fused_vs_torch:0.69x\n"
         "bench_scale,58000,ratio_1m_vs_5k:1.17x;meets_2x:True;"
         "verified:[5000, 20000];1m_best:0.058s\n")
    b = ("bench_solver,9999,100x1000:9999us(vs1us,12.5x,mem1Kvs2K)\n"
         "bench_backend,1,numpy:1.5s;fused:n/as(compile:n/as);"
         "fused_vs_numpy:Nonex;fused_vs_torch:Nonex\n"
         "bench_scale,1,ratio_1m_vs_5k:2.5x;meets_2x:False;"
         "verified:[5000, 20000];1m_best:1.2e-05s\n")
    assert masked_csv(a) == masked_csv(b)
    assert masked_csv(a) != masked_csv(a.replace("100x1000", "250x5000"))
    assert masked_csv(a) != masked_csv(a.replace("20000]", "50000]"))


# ------------------------------------------------------------- perf_gate ----

def test_gate_mode_fails_fast_when_reference_missing(tmp_path, monkeypatch,
                                                     capsys):
    """A deleted or unshipped PERF_REFERENCE_torch.json must be a gate
    failure (before any measurement runs), never a no-op pass."""
    monkeypatch.setattr(perf_gate, "REFERENCE_PATH",
                        str(tmp_path / "PERF_REFERENCE_torch.json"))
    monkeypatch.setattr(perf_gate, "TRAJECTORY_PATH",
                        str(tmp_path / "PERF_trajectory_torch.jsonl"))
    monkeypatch.setattr(
        perf_gate, "measure",
        lambda *a, **k: pytest.fail("gate mode must not measure without "
                                    "a reference file"))
    assert perf_gate.run(update=False, smoke=True) == 1
    out = capsys.readouterr().out
    assert "reference file missing" in out and "--update" in out
    assert not os.path.exists(perf_gate.REFERENCE_PATH)   # not auto-created
    assert not os.path.exists(perf_gate.TRAJECTORY_PATH)  # nothing appended


def test_update_mode_writes_reference(tmp_path, monkeypatch):
    """--update is the only path that (re)creates the reference file."""
    monkeypatch.setattr(perf_gate, "REFERENCE_PATH",
                        str(tmp_path / "PERF_REFERENCE_torch.json"))
    monkeypatch.setattr(perf_gate, "TRAJECTORY_PATH",
                        str(tmp_path / "PERF_trajectory_torch.jsonl"))
    fake = {"config": {"n_items": 1, "base_pods": 1, "n_decisions": 1},
            "backend": "torch:cpu", "device": "cpu",
            "metrics": {"batched_numpy_speedup_vs_pr1": 2.0},
            "checks": {"pr1_equality": True}, "raw": {}}
    monkeypatch.setattr(perf_gate, "measure", lambda *a, **k: fake)
    assert perf_gate.run(update=True, smoke=True) == 0
    with open(perf_gate.REFERENCE_PATH) as f:
        ref = json.load(f)
    assert ref["metrics"]["batched_numpy_speedup_vs_pr1"]["value"] == 2.0
    assert ref["device"] == "cpu"
    assert os.path.exists(perf_gate.TRAJECTORY_PATH)
    # and the freshly written reference gates a repeat measurement green
    assert perf_gate.run(update=False, smoke=True) == 0


def test_gate_paths_are_the_ports_own():
    """The port's gate reads and appends its own two files at the
    repository root, never the reference gate's."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert perf_gate.REFERENCE_PATH == os.path.join(
        root, "PERF_REFERENCE_torch.json")
    assert perf_gate.TRAJECTORY_PATH == os.path.join(
        root, "PERF_trajectory_torch.jsonl")


def test_gate_measurement_matches_the_reference_checks():
    """One real measurement at ``--smoke`` on the host: every correctness
    check true, the reference's metric and check names with ``jax`` named
    ``torch``, and the serving cost ratio (no wall in it) equal to the
    reference's gate measurement.  (The chaos and region ratios are their
    benches' smoke sweeps, which ``tests/test_torch_paper_benches.py``
    holds to the reference.)"""
    from benchmarks.bench_serve import gate_measurement as ref_serve
    measured = perf_gate.measure(4, repeat=1)
    assert measured["checks"] and all(measured["checks"].values())
    assert set(measured["checks"]) == {
        "pr1_equality", "fused_selections_equal_numpy",
        "torch_selections_equal_numpy", "fused_zero_fallbacks",
        "scale_gcd_tier_bitwise", "serve_slo_attainment_ok",
        "serve_zero_infeasible", "serve_determinism",
        "chaos_availability_ok", "chaos_determinism",
        "chaos_inert_when_healthy", "region_determinism",
        "region_single_region_inert", "region_identity_config_inert"}
    assert set(measured["metrics"]) == {
        "batched_numpy_speedup_vs_pr1", "fused_vs_batched_numpy",
        "fused_vs_per_dispatch_torch", "scale_1m_vs_5k_ratio",
        "serve_qps_per_dollar_ratio", "chaos_hardened_vs_naive_ratio",
        "region_failover_vs_pinned_ratio"}
    assert measured["metrics"]["serve_qps_per_dollar_ratio"] == \
        ref_serve()["serve_qps_per_dollar_ratio"]
    assert (measured["backend"], measured["device"]) == ("torch:cpu", "cpu")
    # the measurement gates green against a reference written from itself
    assert perf_gate.gate(measured,
                          perf_gate._default_reference(measured)) == []
