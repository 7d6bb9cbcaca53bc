"""The port's dry-run (``repro_torch.launch.dryrun``): the reference's
``test_dryrun_cell_subprocess`` cell counted on 512 fake ranks, and the
static per-device argument bytes of every cell against the reference's
pspecs and ``_tree_device_bytes`` arithmetic.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host
devices when it is imported, so this file never imports it: its
``_tree_device_bytes`` is compiled from the module's source alone.  The
dry-run starts a process group of its own, so the cell runs in a
subprocess.
"""

import ast
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

import repro.sharding as ref_sharding
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.configs import shape_applicable as ref_shape_applicable
from repro.models import transformer as ref_tf

from repro_torch import sharding
from repro_torch.configs import SHAPES, get_config, shape_applicable
from repro_torch.launch import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


def _reference_tree_device_bytes():
    """``_tree_device_bytes`` of ``src/repro/launch/dryrun.py``, compiled
    from its source (importing the module would set ``XLA_FLAGS``)."""
    path = os.path.join(REPO, "src", "repro", "launch", "dryrun.py")
    tree = ast.parse(open(path).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "_tree_device_bytes")
    ns = {"jax": jax, "jnp": jnp, "np": np, "P": P}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["_tree_device_bytes"]


REF_TREE_DEVICE_BYTES = _reference_tree_device_bytes()


def _reference_arg_bytes(arch, shape_name, multi_pod):
    """The reference dry-run's ``arg_bytes`` expression for the cell, on a
    stub mesh of the production sizes."""
    cfg = ref_get_config(arch)
    shape = REF_SHAPES[shape_name]
    long_ctx = shape.name == "long_500k"
    mk = (ref_sharding.multi_pod_rules if multi_pod
          else ref_sharding.single_pod_rules)
    rules = mk(fsdp=cfg.fsdp, long_context=long_ctx)
    mesh = types.SimpleNamespace(shape=dict(MESHES[multi_pod]))
    token = ref_sharding._ACTIVE.set((mesh, rules))
    try:
        params = REF_TREE_DEVICE_BYTES(ref_tf.abstract_params(cfg),
                                       ref_tf.param_pspecs(cfg, rules), mesh)
        if shape.kind == "train":
            return params * 3.0
        if shape.kind == "prefill":
            return params
        return params + REF_TREE_DEVICE_BYTES(
            ref_tf.abstract_cache(cfg, shape.global_batch, shape.seq_len),
            ref_tf.cache_pspecs(cfg, rules, long_ctx), mesh)
    finally:
        ref_sharding._ACTIVE.reset(token)


def _port_arg_bytes(arch, shape_name, multi_pod):
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mk = sharding.multi_pod_rules if multi_pod else sharding.single_pod_rules
    rules = mk(fsdp=cfg.fsdp, long_context=shape.name == "long_500k")
    sizes = MESHES[multi_pod]
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes),
                                 shape=tuple(sizes.values()))
    with sharding.mesh_context(mesh, rules):
        return dryrun.arg_bytes_per_device(cfg, shape, rules, mesh)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("shape_name", sorted(REF_SHAPES))
@pytest.mark.parametrize("arch", ref_list_archs())
def test_arg_bytes_per_device_match_reference(arch, shape_name, multi_pod):
    applicable = shape_applicable(get_config(arch), SHAPES[shape_name])
    assert applicable == ref_shape_applicable(ref_get_config(arch),
                                              REF_SHAPES[shape_name])
    got = _port_arg_bytes(arch, shape_name, multi_pod)
    assert got == _reference_arg_bytes(arch, shape_name, multi_pod)
    assert got > 0


@pytest.fixture(scope="module")
def cell_record(tmp_path_factory):
    """The record of ``python -m repro_torch.launch.dryrun --arch
    internvl2-1b --shape decode_32k --multi-pod``, run once."""
    out_file = tmp_path_factory.mktemp("dryrun") / "dryrun.jsonl"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "internvl2-1b", "--shape", "decode_32k", "--multi-pod",
         "--out", str(out_file)],
        env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out_file.read_text().splitlines()[-1])


def test_dryrun_cell_subprocess(cell_record):
    """One real (arch × shape × multi-pod mesh) cell counts on the 2×16×16
    = 512-rank production mesh (a fake process group), with the
    reference's ``memory_analysis`` keys counted on ``meta`` and no XLA
    cost keys."""
    rec = cell_record
    assert rec["status"] == "ok"
    assert rec["n_devices"] == 512
    assert rec["flops_per_device"] > 0
    assert rec["arg_bytes_per_device"] == _reference_arg_bytes(
        "internvl2-1b", "decode_32k", True)
    assert rec["unknown_trip_counts"] == 0
    mem = rec["memory_analysis"]
    assert set(mem) == {"temp_bytes", "argument_bytes", "output_bytes"}
    assert all(isinstance(v, int) and v >= 0 for v in mem.values())
    # the laid-out arguments: the parameters and cache of the reference's
    # arithmetic, and the batch's 128 tokens over the 2 x 16 pod x data
    # ranks (4 int32 on a device)
    assert mem["argument_bytes"] == rec["arg_bytes_per_device"] + 4 * 4
    assert mem["temp_bytes"] >= mem["output_bytes"] > 0
    for key in ("xla_cost_flops", "xla_cost_bytes"):
        assert key not in rec
    for key in ("compute_s", "memory_s", "collective_s", "bound", "step_s",
                "roofline_fraction", "model_flops_global",
                "model_flops_ratio", "mfu_bound", "bytes_per_device",
                "wire_bytes_per_device", "collectives", "n_collectives"):
        assert key in rec, key


def test_make_tables_renders_the_port_record(cell_record):
    """``benchmarks.make_tables.dryrun_table`` reads the port's record:
    its GB column is ``(arg_bytes_per_device + temp_bytes) / 1e9``."""
    from benchmarks.make_tables import dryrun_table, roofline_table

    rec = cell_record
    row = dryrun_table([rec]).splitlines()[-1].split("|")
    gb = (rec["arg_bytes_per_device"]
          + rec["memory_analysis"]["temp_bytes"]) / 1e9
    assert row[1:5] == [" internvl2-1b ", " decode_32k ", " 2x16x16 ",
                        " ok "]
    assert row[6].strip() == f"{gb:.1f}"
    assert "internvl2-1b" in roofline_table([rec])


def test_skipped_and_failed_cells_are_recorded(tmp_path, monkeypatch):
    """A full-attention arch at long_500k is recorded skipped; a cell that
    raises is recorded failed with its error and the exit code is 1."""
    rec = dryrun.run_cell("qwen2.5-14b", "long_500k", verbose=False)
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]

    def broken(*a, **k):
        raise RuntimeError("no sharding rule")
    monkeypatch.setattr(dryrun, "run_cell", broken)
    out_file = tmp_path / "f.jsonl"
    rc = dryrun.main(["--arch", "internvl2-1b", "--shape", "decode_32k",
                      "--out", str(out_file)])
    assert rc == 1
    rec = json.loads(out_file.read_text().splitlines()[-1])
    assert rec["status"] == "failed" and "no sharding rule" in rec["error"]
