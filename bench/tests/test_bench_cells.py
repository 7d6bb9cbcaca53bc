"""The harness on the CPU: small cells added as new files in a directory of
their own run end to end through the port, agree with the reference in
float32, and their control (the reference in fp8 in the program's place)
and the planted faults come out not correct under the cells' limits."""

from __future__ import annotations

import functools
import time

import pytest
import torch

from bench import harness
from bench.tests import cells

SEED = 2**31 + 977


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return cells.write_cells(tmp_path_factory.mktemp("bench"))


def run(root, name, traced=False, control=False):
    """One run whose window holds one unit, so that what it serves does
    not depend on the host's speed (a small decode cell starts its second
    answer in it)."""
    cell = harness.load_cell(name, root)
    return harness.run(cell, SEED, 0, traced, "cpu", time.perf_counter(),
                       control)


@pytest.mark.parametrize("name", sorted(cells.SMALL_CELLS))
def test_small_cell_runs_and_agrees(root, name):
    result, numbers, ctrl = run(root, name, control=True)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    metrics = result["metrics"]
    assert "setup_s" in metrics and len(metrics) >= 2
    assert all(m["value"] > 0 for m in metrics.values())
    # the control in place of the program fails a number with a limit
    kind = harness.load_cell(name, root).traffic["kind"]
    small = {k: {"limit": v} for k, v in cells.SMALL_LIMITS[kind].items()}
    assert harness.judge(numbers, small)[0], numbers
    assert not harness.judge(ctrl["fp8"], small)[0], ctrl
    if "half_batch" in ctrl:
        # the fault of half the batch left out, in the program's place
        cell = harness.load_cell(name, root)
        assert not harness.judge(ctrl["half_batch"], cell.limits)[0], ctrl


def test_traced_run_reports_per_layer(root):
    result, _, _ = run(root, "internlm2-small.prefill", traced=True)
    assert result["correct"]
    assert {"mfu.prefill", "ttft_p50_ms.prefill"} <= set(result["metrics"])
    assert "busy_s" in result["device"] and "window_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_state_left_unchanged_fails(root, monkeypatch):
    from repro_torch import optim

    def unchanged(params, grads, state, cfg, ranks=None):
        return params, state, {"lr": torch.zeros(()),
                               "grad_norm": torch.zeros(())}

    monkeypatch.setattr(optim, "adamw_update", unchanged)
    result, numbers, _ = run(root, "falcon-mamba-small.train")
    assert not result["correct"]
    assert numbers["change_gap"] >= 0.99


def test_half_batch_in_the_program_fails(root, monkeypatch):
    from repro_torch.models import transformer

    real = transformer.loss_fn

    @functools.wraps(real)
    def half(params, cfg, batch, **kw):
        rows = batch["tokens"].shape[0] // 2
        return real(params, cfg, {k: v[:rows] for k, v in batch.items()},
                    **kw)

    monkeypatch.setattr(transformer, "loss_fn", half)
    result, _, _ = run(root, "internlm2-small.train")
    assert not result["correct"]


def _altered(fn):
    """``fn``'s logits with the best token of each last position moved to
    another token."""
    def wrapped(*args, **kw):
        logits, caches = fn(*args, **kw)
        last = logits[:, -1]
        best = last.argmax(dim=-1)
        last.scatter_(-1, ((best + 1) % last.shape[-1])[:, None],
                      last.max(dim=-1, keepdim=True).values + 1.0)
        return logits, caches
    return wrapped


@pytest.mark.parametrize("name,entry", [
    ("internlm2-small.prefill", "prefill_fn"),
    ("internlm2-small.decode", "decode_fn")])
def test_altered_token_fails(root, monkeypatch, name, entry):
    from repro_torch import serving

    monkeypatch.setattr(serving, entry, _altered(getattr(serving, entry)))
    result, _, _ = run(root, name)
    assert not result["correct"], result["checks"]


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "internlm2-1.8b.train-4k", "--seed",
                       "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""
