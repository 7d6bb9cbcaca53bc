"""The readers of the program's spans (``bench/span_readers.py`` and the
seven ``bench/metrics/*_ms.*.py`` that use it): the right device ms a unit
from synthetic records, None where there is nothing to read, a refusal
where the records disagree with the trace or the model; and traced CPU
runs of the small cells with the spans in place."""

from __future__ import annotations

import time
import types

import pytest

from bench import harness, span_readers
from bench.tests import cells

SEED = 2**31 + 1013

TRAIN = {"forward_ms.train": "forward", "loss_ms.train": "loss",
         "backward_ms.train": "backward",
         "optimizer_ms.train": "optimizer"}
PREFILL = {"mixer_ms.prefill": "mixer", "ffn_ms.prefill": "ffn",
           "head_ms.prefill": "head"}
CONFIG = {"num_hidden_layers": 3,
          "reference": {"block": ["attn", "mlp"]}}


def read(name, run):
    cell = types.SimpleNamespace(root=harness.ROOT)
    return harness.reader(cell, name)(run)


def fake_run(kind, units, config=CONFIG):
    return types.SimpleNamespace(
        kind=kind, trace=types.SimpleNamespace(units=units),
        cell=types.SimpleNamespace(config=config))


class Records:
    """Synthetic records: ``add(name, parent, ms)`` returns the record."""

    def __init__(self):
        self.records = []

    def add(self, name, parent=None, ms=1.0):
        rec = types.SimpleNamespace(
            id=len(self.records), name=span_readers.PREFIX + name,
            parent=parent.id if parent else None,
            top=parent.top if parent else len(self.records), device_ms=ms)
        self.records.append(rec)
        return rec


def train_records(units, cpu=False, layers=3):
    """``units`` steps: forward 100 + i, loss 10, backward 500 (the
    recompute's spans under it), optimizer 50 ms; ms None if ``cpu``."""
    r = Records()
    for i in range(units):
        def ms(x):
            return None if cpu else x
        top = r.add("train_step", ms=ms(700.0))
        fwd = r.add("forward", top, ms(100.0 + i))
        for _ in range(layers):
            r.add("mixer", fwd, ms(20.0))
            r.add("ffn", fwd, ms(10.0))
        r.add("head", fwd, ms(5.0))
        r.add("loss", top, ms(10.0))
        bwd = r.add("backward", top, ms(500.0))
        for _ in range(layers):
            r.add("mixer", bwd, ms(20.0))
        r.add("optimizer", top, ms(50.0))
    return r.records


def prefill_records(units, layers=3, cpu=False):
    r = Records()
    for _ in range(units):
        top = r.add("prefill", ms=None if cpu else 300.0)
        fwd = r.add("forward", top, None if cpu else 290.0)
        for j in range(layers):
            r.add("mixer", fwd, None if cpu else 60.0 + j)
            r.add("ffn", fwd, None if cpu else 20.0)
        r.add("head", fwd, None if cpu else 7.5)
    # a decode step's spans are not the prefill's
    dec = r.add("decode_step", ms=3.0)
    r.add("mixer", r.add("forward", dec, 2.0), 1.0)
    return r.records


def with_records(monkeypatch, records):
    monkeypatch.setattr(span_readers, "program_records", lambda: records)


def test_train_readers(monkeypatch):
    with_records(monkeypatch, train_records(2))
    run = fake_run("train", 2)
    want = {"forward": 100.5, "loss": 10.0, "backward": 500.0,
            "optimizer": 50.0}
    for name, span in TRAIN.items():
        assert read(name, run) == pytest.approx(want[span])
    for name in PREFILL:
        assert read(name, run) is None


def test_prefill_readers(monkeypatch):
    with_records(monkeypatch, prefill_records(2))
    run = fake_run("prefill", 2)
    want = {"mixer": 183.0, "ffn": 60.0, "head": 7.5}
    for name, span in PREFILL.items():
        assert read(name, run) == pytest.approx(want[span])
    for name in TRAIN:
        assert read(name, run) is None


@pytest.mark.parametrize("name", sorted({**TRAIN, **PREFILL}))
def test_nothing_to_read(monkeypatch, name):
    kind = name.split(".")[1]
    make = train_records if kind == "train" else prefill_records
    # no trace
    with_records(monkeypatch, make(1))
    run = fake_run(kind, 1)
    run.trace = None
    assert read(name, run) is None
    # a program without the spans, or no records
    for records in (None, []):
        with_records(monkeypatch, records)
        assert read(name, fake_run(kind, 1)) is None
    # a CPU run: records without device time
    with_records(monkeypatch, make(1, cpu=True))
    assert read(name, fake_run(kind, 1)) is None


@pytest.mark.parametrize("name", sorted({**TRAIN, **PREFILL}))
def test_refuses_a_count_unlike_the_trace(monkeypatch, name):
    kind = name.split(".")[1]
    make = train_records if kind == "train" else prefill_records
    with_records(monkeypatch, make(3))
    with pytest.raises(ValueError, match="top-level"):
        read(name, fake_run(kind, 2))


@pytest.mark.parametrize("name", ["mixer_ms.prefill", "ffn_ms.prefill"])
def test_refuses_a_layer_count_unlike_the_model(monkeypatch, name):
    with_records(monkeypatch, prefill_records(1, layers=2))
    with pytest.raises(ValueError, match="the model makes"):
        read(name, fake_run("prefill", 1))


def test_layers_read_the_blocks():
    mamba = {"num_hidden_layers": 4, "reference": {"block": ["mamba",
                                                             "none"]}}
    assert span_readers.layers(fake_run("prefill", 1, mamba), "mixer") == 4
    assert span_readers.layers(fake_run("prefill", 1, mamba), "ffn") == 0
    assert span_readers.layers(fake_run("prefill", 1), "ffn") == 3


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.write_cells(tmp_path_factory.mktemp("bench_spans"))


@pytest.mark.parametrize("name,readers,present", [
    ("internlm2-small.prefill", PREFILL,
     {"mfu.prefill", "ttft_p50_ms.prefill"}),
    ("internlm2-small.train", TRAIN, {"mfu.train"}),
    ("falcon-mamba-small.train", TRAIN, {"mfu.train"})])
def test_traced_small_cell(root, name, readers, present):
    from repro_torch import spans

    spans.clear()
    cell = harness.load_cell(name, root)
    result, _, _ = harness.run(cell, SEED, 0, True, "cpu",
                               time.perf_counter())
    assert result["correct"], result["checks"]
    # the per-layer metrics a CPU run reports, as before the spans
    assert present <= set(result["metrics"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    units = cell.traffic["trace_units"]
    top = "prefill" if cell.traffic["kind"] == "prefill" else "train_step"
    records = spans.records()
    tops = [r for r in records if r.parent is None]
    assert [r.name for r in tops] == [span_readers.PREFIX + top] * units
    # the readers agree with the counts and find no device time on the CPU
    run = harness.Run(cell, 0.0, None, types.SimpleNamespace(units=units))
    for metric in readers:
        assert harness.reader(cell, metric)(run) is None
    spans.clear()
