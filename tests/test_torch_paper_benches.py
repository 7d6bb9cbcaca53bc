"""The port's risk, chaos and region benchmarks
(``repro_torch.benchmarks.bench_{risk,chaos,region}``) against the
reference's ``benchmarks/`` on the CPU, at ``--smoke``.

The reference solves on ``numpy``, the port on ``"torch:cpu"``.  Each
bench's record must equal the reference's once the walls (``wall_s``,
bench_risk's ``decision_overhead_us``) and the host's platform fields are
dropped, its line must equal the reference's with the walls masked, it
must write nothing but the ``--json`` path, and the chaos and region
contract checks must all hold (``run`` raises if
one does not).  The scenario engines build the same few catalogs over and
over, most of a smoke run's wall on the CPU: each package's
``generate_catalog`` is run once a seed and size here, as
``tests/test_torch_examples.py`` does.
"""

import importlib
import json

import pytest

import repro.sim.scenario as ref_scenario
import repro_torch.sim.scenario as port_scenario
from repro.core import backend as ref_backend_mod
from repro_torch.benchmarks.common import (PLATFORM_FIELDS, WALL_FIELDS,
                                           masked_csv, without)
from repro_torch.core import backend as backend_mod
from tests.test_torch_examples import catalog_once

BENCHES = ("bench_risk", "bench_chaos", "bench_region")
FIELDS = WALL_FIELDS + PLATFORM_FIELDS
#: bench -> the reference's smoke record (fields dropped) and its line
REFERENCE = {}


@pytest.fixture(autouse=True)
def backends_on_host(monkeypatch):
    for module in (ref_scenario, port_scenario):
        monkeypatch.setattr(module, "generate_catalog", catalog_once(module))
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


@pytest.mark.parametrize("name", BENCHES)
def test_bench_matches_reference_at_smoke(name, capsys, monkeypatch,
                                          tmp_path):
    """The port's record, also as written to ``--json`` (the one file the
    run writes), and its line equal to the reference's."""
    port = importlib.import_module(f"repro_torch.benchmarks.{name}")
    want, want_line = reference_smoke(name, capsys)
    monkeypatch.chdir(tmp_path)
    got = port.main(["--smoke", "--json", "record.json"])
    line = capsys.readouterr().out
    assert [p.name for p in tmp_path.iterdir()] == ["record.json"]
    assert json.loads((tmp_path / "record.json").read_text()) == json.loads(
        json.dumps(got))
    assert without(got, FIELDS) == want
    assert line.startswith(f"{name},")
    assert masked_csv(line) == masked_csv(want_line)
    if name != "bench_risk":
        assert got["contracts"] and all(got["contracts"].values())
        assert got["headline"]["meets_target"]
    if name == "bench_chaos":
        ladder = got["storms"]["combined"]["hardened"]["ladder"]
        assert ladder and sum(ladder.values()) > 0


def test_chaos_fleets_through_the_fused_plane(capsys):
    """bench_chaos at ``--smoke`` under ``"torch:fused:cpu"``: the
    reference's record, the kubepacs fleets' decisions through the fused
    record (handed the process default), none falling back to a host
    solve."""
    from repro_torch.benchmarks import bench_chaos
    want, want_line = reference_smoke("bench_chaos", capsys)
    backend = backend_mod.set_backend("torch:fused:cpu")
    got = bench_chaos.main(["--smoke"])
    assert without(got, FIELDS) == want
    assert masked_csv(capsys.readouterr().out) == masked_csv(want_line)
    assert backend.fused_records > 0
    assert backend.device_cache_info()["fallback_solves"] == 0
