"""The port's cover-DP backend (``repro_torch.core.backend`` and
``repro_torch.core.cover_dp``) against the reference package.

On this host ``TorchBackend("cpu")`` runs the kernel's plain torch version;
it must be bitwise equal — dp bytes and bits — to the reference
``NumpyBackend``, the per-dispatch ``jax`` scan, the ``jax:pallas`` step
kernel and the fused plane's ``_cover_kernel`` (both in interpret mode).
The CUDA kernel itself is held to the same plain version on the card by
``chip_smoke.py``.
"""

import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from repro.core import NumpyBackend as RefNumpyBackend
from repro.core import make_backend as ref_make_backend
from repro_torch import resolve_device
from repro_torch.core import NumpyBackend, TorchBackend, make_backend
from repro_torch.core import backend as backend_mod
from repro_torch.core.cover_dp import CoverBatch, cover_dp

REPO = pathlib.Path(__file__).resolve().parents[1]
TORCH_CPU = TorchBackend("cpu")


def _groups(rng, n, t_max=200, b_max=30):
    """Ragged groups with +inf costs, pb == 1 and pb > T all present."""
    out = []
    for _ in range(n):
        T = int(rng.integers(1, t_max + 1))
        B = int(rng.integers(0, b_max + 1))
        pods = rng.integers(1, T + T // 2 + 2, size=B).astype(np.int64)
        pods[rng.random(B) < 0.15] = 1
        costs = rng.uniform(0.0, 3.0, size=B)
        costs[rng.random(B) < 0.25] = np.inf
        out.append((pods, costs, T))
    return out


def _assert_bitwise(got, want):
    assert len(got) == len(want)
    for (dp, bits), (dw, bw) in zip(got, want):
        assert dp.dtype == np.float64 and bits.dtype == np.bool_
        assert dp.tobytes() == np.asarray(dw).tobytes()
        assert bits.shape == np.asarray(bw).shape
        assert np.array_equal(bits, np.asarray(bw))


def test_groups_cover_the_edge_cases():
    groups = _groups(np.random.default_rng(0), 60)
    assert any(np.isinf(c).any() for _p, c, _t in groups)
    assert any((p == 1).any() for p, _c, _t in groups)
    assert any((p > t).any() for p, _c, t in groups)
    assert any(len(p) == 0 for p, _c, _t in groups)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_cpu_equals_reference_numpy(seed):
    groups = _groups(np.random.default_rng(seed), 60)
    ref = RefNumpyBackend()
    _assert_bitwise(TORCH_CPU.cover_bits(groups), ref.cover_bits(groups))
    for dp, dw in zip(TORCH_CPU.cover_values(groups), ref.cover_values(groups)):
        assert dp.tobytes() == dw.tobytes()


@pytest.mark.parametrize("spec,n_groups", [("jax", 12), ("jax:pallas", 3)])
def test_torch_cpu_equals_reference_jax(spec, n_groups):
    """``jax:pallas`` runs ``relax_kernel`` in interpret mode, hence few,
    small groups (one (16, 256) bucket)."""
    rng = np.random.default_rng(7)
    groups = _groups(rng, n_groups, t_max=200,
                     b_max=30 if spec == "jax" else 16)
    _assert_bitwise(TORCH_CPU.cover_bits(groups),
                    ref_make_backend(spec).cover_bits(groups))


def test_torch_cpu_equals_pallas_cover_kernel_interpret():
    """The fused plane's ``_cover_kernel`` (interpret mode) at the inputs of
    its own self-check, ``_run_pallas_check``: W=129, B=256, rng 17."""
    import jax

    fused = ref_make_backend("jax:fused")
    W, B = 129, 256
    cover = jax.jit(fused._pallas_cover_fn(W, B, True))
    rng = np.random.default_rng(17)
    pods = rng.integers(1, 200, size=B).astype(np.int64)
    costs = rng.uniform(0.01, 3.0, size=B)
    costs[rng.random(B) < 0.25] = np.inf
    dp_k, bits_k = cover(pods, costs)
    (dp, bits), = TORCH_CPU.cover_bits([(pods, costs, W - 1)])
    _assert_bitwise([(dp, bits)], [(np.asarray(dp_k), np.asarray(bits_k))])


def test_cover_values_equals_cover_bits_dp():
    groups = _groups(np.random.default_rng(9), 20)
    for dp, (dp2, _bits) in zip(TORCH_CPU.cover_values(groups),
                                TORCH_CPU.cover_bits(groups)):
        assert dp.tobytes() == dp2.tobytes()


def test_bits_budget_splits_dispatch_without_changing_results():
    groups = _groups(np.random.default_rng(4), 25)
    small = TorchBackend("cpu")
    small.bits_budget = 2000
    assert len(list(small._slices(groups, True))) > 5
    _assert_bitwise(small.cover_bits(groups), NumpyBackend().cover_bits(groups))


def test_port_numpy_backend_is_the_reference_oracle():
    groups = _groups(np.random.default_rng(5), 30)
    _assert_bitwise(NumpyBackend().cover_bits(groups),
                    RefNumpyBackend().cover_bits(groups))


def test_cpu_batch_runs_plain_version_and_counts_no_launch():
    groups = _groups(np.random.default_rng(6), 8)
    batch = CoverBatch.build(groups, torch.device("cpu"))
    before = cover_dp.launches
    dp, bits = cover_dp(batch, True)
    assert cover_dp.launches == before
    assert dp.dtype == torch.float64 and bits.dtype == torch.bool
    assert dp.numel() == sum(t + 1 for _p, _c, t in groups)
    assert bits.numel() == sum(len(p) * (t + 1) for p, _c, t in groups)
    dp_v, none = cover_dp(batch, False)
    assert none is None and torch.equal(dp_v, dp)


def test_cover_batch_rejects_bad_groups():
    with pytest.raises(ValueError):
        CoverBatch.build([(np.array([0, 2]), np.array([1.0, 1.0]), 5)],
                         torch.device("cpu"))
    with pytest.raises(ValueError):
        CoverBatch.build([(np.array([1, 2]), np.array([1.0]), 5)],
                         torch.device("cpu"))


def test_empty_dispatch():
    assert TORCH_CPU.cover_bits([]) == []
    assert TORCH_CPU.cover_values([]) == []


def test_torch_spec_runs_on_the_card_or_raises():
    """No fallback: without CUDA the card's backend raises instead of
    quietly running on the host."""
    if torch.cuda.is_available():
        assert make_backend("torch").device.type == "cuda"
        assert resolve_device().type == "cuda"
        return
    for build in (lambda: make_backend("torch"), TorchBackend, resolve_device):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()


def test_make_backend_specs(monkeypatch):
    assert isinstance(make_backend("numpy"), NumpyBackend)
    cpu = make_backend("torch:cpu")
    assert isinstance(cpu, TorchBackend) and cpu.device.type == "cpu"
    assert cpu.name == "torch:cpu"
    for spec in ("jax", "jax:pallas", "jax:fused", "jax:fused:pallas", "cuda"):
        with pytest.raises(ValueError):
            make_backend(spec)
    monkeypatch.setattr(backend_mod, "_DEFAULT", None)
    monkeypatch.delenv("KUBEPACS_SOLVER_BACKEND", raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            backend_mod.get_backend()     # the default is the card
    monkeypatch.setenv("KUBEPACS_SOLVER_BACKEND", "torch:cpu")
    monkeypatch.setattr(backend_mod, "_DEFAULT", None)
    assert backend_mod.get_backend().device.type == "cpu"


def _port_files():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) >= 14
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                if top in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert bad == []
