"""The scan backward's frozen least time against hand-worked figures and
the port's cost model, and its reader's kernel pattern."""

from __future__ import annotations

import importlib.util
import re

import pytest

from bench import backward_costs, harness


def _reader():
    path = harness.ROOT / "bench" / "metrics" / \
        "mamba_scan_bwd_roofline.train.py"
    spec = importlib.util.spec_from_file_location("scan_bwd_reader", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_scan_bwd_by_hand():
    # falcon-mamba-7b's backward at B 4 x S 4,096: the exponentials bind
    # (0.5135 ms), above the float32 work (0.4947 ms) and the bytes (0.40)
    exps = 4 * 4096 * 8192 * 16
    least = backward_costs.scan_bwd_least_s(4, 4096, 8192, 16, 2)
    assert least == pytest.approx(exps / (132 * 16 * 1.98e9))
    assert least == pytest.approx(0.5135e-3, rel=1e-3)
    flops = 15 * exps + 7 * 4 * 4096 * 8192
    assert flops / 67e12 == pytest.approx(0.4947e-3, rel=1e-3)
    assert flops / 67e12 < least
    nbytes = 2 * (5 * 4 * 4096 * 8192 + 4 * 4 * 4096 * 16) \
        + 8 * (8192 * 16 + 8192)
    assert nbytes == 1_345_388_544
    assert nbytes / 3.35e12 < least


@pytest.mark.parametrize("shape", [(4, 4096, 8192, 16, 2),
                                   (1, 4096, 8192, 16, 4),
                                   (4, 1024, 16384, 16, 2),
                                   (2, 64, 32, 8, 4)])
def test_frozen_copy_equals_the_ports_cost_model(shape):
    from repro_torch import roofline

    ms, _ = roofline.scan_bwd_bound(*shape)
    assert backward_costs.scan_bwd_least_s(*shape) * 1e3 == \
        pytest.approx(ms)


def test_reader_patterns_read_the_backward_kernels_alone():
    reader = _reader()
    launch = re.compile(reader.LAUNCH).search
    timed = re.compile(reader.PATTERN).search
    fwd = re.compile(r"(^|[\s:])scan_kernel<").search
    names = {kind: f"void (anonymous namespace)::{kind}<__nv_bfloat16>"
                   f"(__nv_bfloat16 const*, int)"
             for kind in ("scan_bwd_kernel", "scan_bwd_sums", "scan_kernel")}
    assert launch(names["scan_bwd_kernel"])
    assert not launch(names["scan_bwd_sums"])
    assert not launch(names["scan_kernel"])
    assert timed(names["scan_bwd_kernel"]) and timed(names["scan_bwd_sums"])
    assert not timed(names["scan_kernel"])
    assert fwd(names["scan_kernel"])
    assert not fwd(names["scan_bwd_kernel"])
    assert not fwd(names["scan_bwd_sums"])


class _Trace:
    def __init__(self, kernels):
        self.kernels = kernels

    def kernel_seconds(self, match):
        hits = [length for name, _, length in self.kernels if match(name)]
        return len(hits), sum(hits)


class _Cell:
    config = {"expand": 2, "hidden_size": 4096, "state_size": 16}
    traffic = {"batch": 4, "seq": 4096}


class _Run:
    def __init__(self, kernels, kind="train"):
        self.kind, self.cell = kind, _Cell()
        self.trace = None if kernels is None else _Trace(kernels)


def test_reader_takes_both_kernels_time_a_launch_each():
    read = _reader().read
    least = backward_costs.scan_bwd_least_s(4, 4096, 8192, 16, 2)
    kernels = [("scan_bwd_kernel<__nv_bfloat16>", 0, 4e-3),
               ("scan_bwd_sums<__nv_bfloat16>", 0, 1e-3),
               ("scan_kernel<__nv_bfloat16>", 0, 1.3e-3)] * 8
    assert read(_Run(kernels)) == pytest.approx(100 * least / 5e-3)
    # the parent's program: no such kernel, no reading; and no trace
    assert read(_Run(kernels[2:3] * 8)) is None
    assert read(_Run(None)) is None
    assert read(_Run(kernels, kind="prefill")) is None
