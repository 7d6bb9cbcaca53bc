"""The port's paper drivers (``repro_torch.benchmarks``: the ten figure
and table drivers and their runner) against the reference's
``benchmarks/`` on the CPU.

The reference solves on ``numpy``, the port on ``"torch:cpu"`` (the
cover-DP kernel's plain version), both on one reduced catalog,
``generate_catalog(seed=0, max_offerings=300)``, built once a package:
each driver's ``run(cat=...)`` returns the reference's record with only
the wall fields removed, and ``main()`` prints the reference's line once
the walls are masked (``masked_csv``).  fig6b builds its own catalogs, so
both packages' fig6b modules get a ``generate_catalog`` cut to the same
300 offerings (its ``regions=`` kept).  The decision plane is bitwise, so
floats compare with ``==``.
"""

import importlib
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import repro.core as ref_core
import repro_torch.benchmarks as port_benchmarks
import repro_torch.core as port_core
from repro.core import backend as ref_backend_mod
from repro_torch.benchmarks import run as port_run
from repro_torch.benchmarks.common import masked_csv, without
from repro_torch.core import backend as backend_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVERS = [name for name, _ in port_run.ALL[:10]]
#: the drivers the fused plane decides: each calls ``bracketed_gss`` (and
#: two ``solve_ilp_batch``) with the process default handed over
FUSED_DRIVERS = ("fig5_sota", "table2_fixed_alpha", "fig6_alpha")
SMALL = 300

#: (package, seed, max_offerings, regions) -> that package's catalog
CATALOGS = {}
#: driver -> the reference's record on the reduced catalog
REFERENCE = {}


def small_catalog(core, seed=0, regions=None):
    key = (core.__name__, seed, SMALL, regions)
    if key not in CATALOGS:
        kw = {} if regions is None else {"regions": regions}
        CATALOGS[key] = core.generate_catalog(seed=seed, max_offerings=SMALL,
                                              **kw)
    return list(CATALOGS[key])


@pytest.fixture(autouse=True)
def backends_on_host(monkeypatch):
    """The port's default on the host's plain versions, the reference's on
    ``numpy``; every driver's ``common.catalog()`` and fig6b's
    ``generate_catalog`` cut to the reduced catalog."""
    for pkg, core in (("benchmarks", ref_core),
                      ("repro_torch.benchmarks", port_core)):
        common = importlib.import_module(f"{pkg}.common")
        monkeypatch.setattr(common, "catalog",
                            lambda seed=0, max_offerings=2000, core=core:
                            small_catalog(core, seed))
        fig6b = importlib.import_module(f"{pkg}.fig6b_cross_provider")
        monkeypatch.setattr(fig6b, "generate_catalog",
                            lambda seed=0, regions=None, core=core:
                            small_catalog(core, seed, regions))
    saved = backend_mod._DEFAULT, ref_backend_mod._DEFAULT
    backend_mod.set_backend("torch:cpu")
    ref_backend_mod.set_backend("numpy")
    yield
    backend_mod._DEFAULT, ref_backend_mod._DEFAULT = saved


def drivers(name):
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.benchmarks.{name}"))


def cat_kw(name, core):
    return ({} if name == "fig6b_cross_provider"
            else {"cat": small_catalog(core)})


def reference_record(name):
    if name not in REFERENCE:
        ref, _ = drivers(name)
        REFERENCE[name] = without(ref.run(**cat_kw(name, ref_core)))
    return REFERENCE[name]


@pytest.mark.parametrize("name", DRIVERS)
def test_driver_matches_reference(name, capsys):
    """The record with the walls removed, ``main()``'s line with them
    masked, and the runner's ``--only`` printing that line."""
    ref, port = drivers(name)
    got = port.run(**cat_kw(name, port_core))
    assert without(got) == reference_record(name)

    capsys.readouterr()
    ref.main()
    want = capsys.readouterr().out
    port_run.main(["--only", name])
    line = capsys.readouterr().out
    assert want.startswith(f"{name},") and want.count("\n") == 1
    assert masked_csv(line) == masked_csv("name,us_per_call,derived\n"
                                          + want)


def test_fused_plane_decides_the_paper_drivers():
    """fig5, table2 and fig6 under ``"torch:fused:cpu"``: the reference's
    records, every decision through the fused record and none falling back
    to a host solve."""
    for name in FUSED_DRIVERS:
        backend = backend_mod.set_backend("torch:fused:cpu")
        _, port = drivers(name)
        got = port.run(cat=small_catalog(port_core))
        assert without(got) == reference_record(name), name
        assert backend.fused_records > 0, name
        assert backend.device_cache_info()["fallback_solves"] == 0, name


def test_masked_csv_masks_every_wall():
    """The walls the drivers print: ``us_per_call``, ``{:.2f}s``, fig12's
    ``recovery_ours=...s_`` and bench_risk's ``overhead=...x``; the rest
    of a line stays."""
    a = ("fig12_interrupts,44118,repl_node_price_reduction=42.8%;"
         "recovery_ours=0.04s_vs_karpenter~2.0s;lost_pods=256\n"
         "fig7_tolerance,35747,eps=0.1:solves=7(pred~6),t=0.02s,E=1.0000\n"
         "bench_risk,9942,brier=0.195;overhead=1.379x\n")
    b = ("fig12_interrupts,55840,repl_node_price_reduction=42.8%;"
         "recovery_ours=0.06s_vs_karpenter~2.0s;lost_pods=256\n"
         "fig7_tolerance,38546,eps=0.1:solves=7(pred~6),t=0.01s,E=1.0000\n"
         "bench_risk,30906,brier=0.195;overhead=0.837x\n")
    assert masked_csv(a) == masked_csv(b)
    assert "karpenter~2.0s;lost_pods=256" in masked_csv(a)
    assert masked_csv(a) != masked_csv(a.replace("=256", "=257"))


def test_runner_rejects_an_unknown_name(capsys):
    with pytest.raises(SystemExit) as exc:
        port_run.main(["--only", "fig99_nothing"])
    assert exc.value.code == 2
    assert "choose from: fig5_sota" in capsys.readouterr().err


def test_runner_json_names_backend_and_device(tmp_path):
    """``--json`` writes the records beside the backend's spec and the
    device; no ``trajectory`` of the reference's ``BENCH_*.json``."""
    path = tmp_path / "paper.json"
    port_run.main(["--only", "fig9_t3_fulfillment", "--json", str(path)])
    record = json.loads(path.read_text())
    assert sorted(record) == ["backend", "device", "fig9_t3_fulfillment"]
    assert record["backend"] == "torch:cpu" and record["device"] == "cpu"
    assert record["fig9_t3_fulfillment"]["monotone"] is True


def test_benchmarks_import_neither_jax_nor_the_reference():
    """Every module of ``repro_torch.benchmarks`` imports with ``jax``,
    ``jaxlib``, ``repro`` and ``benchmarks`` blocked."""
    names = [m.name for m in pkgutil.iter_modules(port_benchmarks.__path__)]
    assert sorted(names) == sorted(
        ["common", "run", *DRIVERS, "bench_risk", "bench_chaos",
         "bench_region", "bench_solver", "bench_backend", "bench_scale",
         "bench_fleet", "bench_serve", "perf_gate", "elastic_training",
         "roofline_report", "make_tables"])
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro',\n"
            "                                  'benchmarks'):\n"
            "            raise ImportError('blocked: ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            + "".join(f"import repro_torch.benchmarks.{n}\n" for n in names)
            + "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
