"""The port's decision examples (``repro_torch.examples.quickstart``,
``.provision_cluster``, ``.run_scenario``) against the reference's
``examples/`` on the CPU.

The reference example runs through ``runpy`` with ``sys.argv`` patched, the
port's through ``main(argv)``; both print to ``capsys``.  The printed lines
must be equal once the fields that print a wall or a rate are masked (the
``{:.2f}s`` walls and the fleet line's replicas/s) and the trace path is
named by a placeholder; the JSONL traces that ``run_scenario`` records must
be byte-equal across the two packages.  The port's process-default backend
is the card, so an autouse fixture names the host (``"torch:cpu"``, the
cover-DP kernel's plain version) and pins the reference's to ``numpy``;
both packages' ServeSim run the analytic perf model (the reference's
``"auto"`` is its roofline mode whenever jax imports).

A tour builds its scenario's catalog three times (the live run, the replay
and the seed sweep), most of a smoke run's wall on the CPU: each package's
``generate_catalog`` is run once a seed and size here, and the scenario
engines are handed fresh lists of its (frozen) offerings.
"""

import os
import pkgutil
import runpy
import subprocess
import sys
import tempfile

import pytest

import repro.serve_sim as ref_serve
import repro.sim.scenario as ref_scenario
import repro_torch.examples as port_examples
import repro_torch.serve_sim as port_serve
import repro_torch.sim.scenario as port_scenario
from repro.core import backend as ref_backend_mod
from repro_torch.core import backend as backend_mod
from repro_torch.examples import (masked_walls, provision_cluster,
                                  quickstart, recorded, run_scenario)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")

#: each README and docstring invocation of the scenario tour, at --smoke
SCENARIO_FLAGS = [
    [],
    ["--policy", "kubepacs_risk:12"],
    ["--replicas", "256"],
    ["--workload", "diurnal"],
    ["--workload", "bursty"],
    ["--workload", "flash", "--policy", "karpenter_like"],
    ["--faults", "combined", "--policy", "hardened"],
    ["--faults", "feed:0.5"],
    ["--regions", "3"],
    ["--regions", "3:0.8", "--faults", "region", "--policy", "hardened"],
]


#: (package, seed, max_offerings) -> that package's generated catalog
CATALOGS = {}


def catalog_once(module):
    generate = module.generate_catalog

    def cached(seed=0, max_offerings=None):
        key = (module.__name__, seed, max_offerings)
        if key not in CATALOGS:
            CATALOGS[key] = generate(seed=seed, max_offerings=max_offerings)
        return list(CATALOGS[key])
    return cached


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


def reference_stdout(capsys, monkeypatch, name, argv):
    path = os.path.join(EXAMPLES, name + ".py")
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [path, *argv])
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out


def port_stdout(capsys, module, argv):
    capsys.readouterr()
    module.main(argv)
    return capsys.readouterr().out


def test_quickstart_prints_the_reference_decision(capsys, monkeypatch):
    want = reference_stdout(capsys, monkeypatch, "quickstart", [])
    got = port_stdout(capsys, quickstart, [])
    assert "KubePACS decision" in got
    assert masked_walls(got) == masked_walls(want)


def test_provision_cluster_prints_the_reference_log(capsys, monkeypatch):
    argv = ["--hours", "12", "--pods", "60"]
    want = reference_stdout(capsys, monkeypatch, "provision_cluster", argv)
    got = port_stdout(capsys, provision_cluster, argv)
    assert "12h summary" in got
    assert masked_walls(got) == masked_walls(want)


@pytest.mark.parametrize("flags", SCENARIO_FLAGS,
                         ids=lambda f: " ".join(f) or "default")
def test_run_scenario_matches_reference(flags, capsys, monkeypatch,
                                        tmp_path):
    """The tour's lines equal, and the live run's trace byte-equal to the
    reference's (the serving workloads record none)."""
    traces = [str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")]
    want = reference_stdout(capsys, monkeypatch, "run_scenario",
                            ["--smoke", "--trace", traces[0], *flags])
    got = port_stdout(capsys, run_scenario,
                      ["--smoke", "--trace", traces[1], *flags])
    assert masked_walls(got, traces[1]) == masked_walls(want, traces[0])
    if "--workload" in flags:
        assert got.startswith("serving ")
        assert not any(os.path.exists(t) for t in traces)
        return
    assert "byte-identical trace=True" in got
    with open(traces[0], "rb") as f_ref, open(traces[1], "rb") as f_port:
        ref_bytes = f_ref.read()
        assert ref_bytes and f_port.read() == ref_bytes


def test_run_scenario_fleet_through_the_fused_plane(capsys, monkeypatch,
                                                    tmp_path):
    """``--replicas 256`` with the fused plane as the process default (the
    fleet's batched ticks through ``fused_rows``' plain version): the
    reference's lines, and no fleet falls back to a host solve."""
    argv = ["--smoke", "--replicas", "256"]
    traces = [str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")]
    want = reference_stdout(capsys, monkeypatch, "run_scenario",
                            [*argv, "--trace", traces[0]])
    backend_mod.set_backend("torch:fused:cpu")
    with recorded(run_scenario, "FleetSim") as fleets:
        got = port_stdout(capsys, run_scenario,
                          [*argv, "--trace", traces[1]])
    assert masked_walls(got, traces[1]) == masked_walls(want, traces[0])
    (fleet,) = fleets
    stats = fleet.stats()
    assert stats["memo_unique_solves"] > 0
    assert fleet.solve_batch.backend is backend_mod.get_backend()
    assert fleet.solve_batch.backend.fused_records > 0
    assert stats["device_cache_fallback_solves"] == 0


def test_run_scenario_rejects_region_faults_without_regions():
    with pytest.raises(SystemExit, match="--faults region needs"):
        run_scenario.main(["--smoke", "--faults", "region"])


def test_run_scenario_default_trace_is_in_the_temporary_directory(
        monkeypatch, tmp_path, capsys):
    """Without ``--trace`` the tour records to ``kubepacs_scenario.jsonl``
    in the temporary directory (the reference's default is ``/tmp``)."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run_scenario.main(["--smoke"])
    trace = tmp_path / "kubepacs_scenario.jsonl"
    assert trace.stat().st_size > 0
    assert f"-> {trace} (" in capsys.readouterr().out


def test_examples_import_neither_jax_nor_the_reference():
    """Every module of ``repro_torch.examples`` imports with ``jax``,
    ``jaxlib`` and ``repro`` blocked."""
    names = [m.name for m in pkgutil.iter_modules(port_examples.__path__)]
    assert sorted(names) == ["provision_cluster", "quickstart",
                             "run_scenario", "serve_batched",
                             "train_elastic_spot"]
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            + "".join(f"import repro_torch.examples.{n}\n" for n in names)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
