"""The port's spans (``repro_torch.spans``) on the CPU, at smoke widths:
nothing recorded with the profiler off; under ``torch.profiler`` the tree
of a train step, a prefill and a decode step, each span a ``cpu_op`` of
the trace (never a user annotation) and without device time; the parent
taken across threads; the bounded store."""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import optim, serving, spans
from repro_torch.configs import get_config
from repro_torch.models import transformer
from repro_torch.train import loop


@pytest.fixture(autouse=True)
def empty_store():
    spans.clear()
    yield
    spans.clear()


def model(arch):
    cfg = get_config(arch, smoke=True)
    gen = torch.Generator().manual_seed(0)
    return cfg, transformer.init_params(cfg, gen, device="cpu")


def tokens(cfg, b, s, seed=1):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (b, s), generator=gen)


def train_step(cfg, params, opt):
    ids = tokens(cfg, 2, 17)
    step = loop.make_train_step(cfg, optim.OptConfig())
    return step(params, opt, {"tokens": ids[:, :-1], "targets": ids[:, 1:]})


def serve(cfg, params):
    ids = tokens(cfg, 2, 9)
    _, caches = serving.prefill_fn(params, {"tokens": ids[:, :8]}, cfg=cfg,
                                   max_len=12)
    serving.decode_fn(params, caches, {"tokens": ids[:, 8:]}, 8, cfg=cfg)


def tree(records):
    """``(name, [children...])`` of each top-level record, names without
    the prefix."""
    kids = {r.id: [] for r in records}
    tops = []
    for r in records:
        (kids[r.parent] if r.parent is not None else tops).append(r)

    def node(r):
        return (r.name[len(spans.PREFIX):], [node(k) for k in kids[r.id]])
    return [node(r) for r in tops]


def test_off_records_nothing():
    cfg, params = model("internlm2-1.8b")
    assert spans.span("forward") is spans.span("mixer")
    train_step(cfg, params, optim.init_opt_state(params))
    serve(cfg, params)
    assert spans.records() == []


def test_train_step_tree():
    cfg, params = model("internlm2-1.8b")
    opt = optim.init_opt_state(params)
    with profile(activities=[ProfilerActivity.CPU]):
        train_step(cfg, params, opt)
    layer = [("mixer", []), ("ffn", [])]
    n = cfg.n_layers
    assert tree(spans.records()) == [("train_step", [
        ("forward", layer * n + [("head", [])]),
        ("loss", []),
        ("backward", layer * n),           # the remat recompute
        ("optimizer", [])])]
    recs = spans.records()
    assert all(r.device_ms is None for r in recs)
    assert all(r.end_ns >= r.start_ns for r in recs)
    top = recs[0]
    assert all(top.start_ns <= r.start_ns and r.end_ns <= top.end_ns
               for r in recs)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "falcon-mamba-7b",
                                  "qwen3-moe-30b-a3b"])
def test_prefill_and_decode_layers(arch):
    cfg, params = model(arch)
    with profile(activities=[ProfilerActivity.CPU]):
        serve(cfg, params)
    n_ffn = sum(1 for spec in cfg.layout if spec.ffn != "none")
    for top, name in zip(tree(spans.records()), ("prefill", "decode_step")):
        assert top[0] == name
        [(fwd, parts)] = top[1]
        assert fwd == "forward"
        names = [p[0] for p in parts]
        assert names.count("mixer") == cfg.n_layers
        assert names.count("ffn") == n_ffn
        assert names[-1] == "head" and names.count("head") == 1
    assert len(tree(spans.records())) == 2


def test_spans_are_cpu_ops(tmp_path):
    cfg, params = model("internlm2-1.8b")
    opt = optim.init_opt_state(params)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step(cfg, params, opt)
        serve(cfg, params)
    ours = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    assert len(ours) == len(spans.records())
    assert not any(e.is_user_annotation for e in ours)
    assert not any("Backward" in e.name for e in ours)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    cats = {e.get("cat") for e in events
            if str(e.get("name", "")).startswith(spans.PREFIX)}
    assert cats == {"cpu_op"}
    assert {r.name for r in spans.records()} == {
        spans.PREFIX + n for n in ("train_step", "forward", "mixer", "ffn",
                                   "head", "loss", "backward", "optimizer",
                                   "prefill", "decode_step")}


def test_parent_is_innermost_in_the_process(monkeypatch):
    # the profiler's state is the thread's own, and autograd hands it to
    # its worker threads; a plain thread here is told it is on
    monkeypatch.setattr(spans, "_enabled", lambda: True)
    seen = []

    def other():
        with spans.span("mixer") as rec:
            seen.append(rec)

    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("backward") as outer:
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert seen[0].parent == outer.id and seen[0].top == outer.id


def test_span_closes_on_an_exception():
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(RuntimeError):
            with spans.span("forward"):
                with spans.span("mixer"):
                    raise RuntimeError("stop")
        with spans.span("head") as after:
            pass
    fwd, mixer, head = spans.records()
    assert mixer.end_ns is not None and fwd.end_ns is not None
    assert head is after and head.parent is None


def test_store_keeps_the_last_tops():
    made = []
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(spans.KEEP + 6):
            with spans.span("decode_step") as top:
                with spans.span("mixer"):
                    pass
            made.append(top)
    recs = spans.records()
    tops = [r for r in recs if r.parent is None]
    assert tops == made[6:]                 # the first six dropped
    assert len(recs) == 2 * spans.KEEP
    assert all(r.top in {t.id for t in tops} for r in recs)
