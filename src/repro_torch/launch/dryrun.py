"""Multi-pod dry-run: count every (arch × shape × mesh) cell on abstract
tensors.

For each cell this starts a fake process group (``FakeStore``, backend
``"fake"``) of 256 or 512 ranks, builds the production mesh (16×16
single-pod, 2×16×16 multi-pod) on it, lays abstract (``meta``) DTensor
parameters, optimizer state, batch and cache out on it under the cell's
pspecs (each rank's shard a storage of its own, as the step finds them at
rest), runs the sharded step (train_step / prefill / decode per the
shape's kind) once under :func:`repro_torch.roofline.analyze_step` — the
per-device FLOPs, bytes, collective wire bytes and live device bytes of
rank 0, with nothing of the model's size allocated — and tears the group
down.  It records:

  * the static per-device argument bytes, the reference's arithmetic;
  * ``memory_analysis``, with the keys of XLA's ``memory_analysis()`` in
    the reference's record, counted on ``meta``: ``argument_bytes`` (the
    distinct storages of the laid-out arguments), ``output_bytes`` (the
    storages of the return value that the step created) and
    ``temp_bytes``, the step's peak of live bytes *outputs included* (XLA
    leaves its outputs out), so that ``arg_bytes_per_device + temp_bytes``
    is the counted peak of one device: the fit check against
    ``roofline.HBM_BYTES``, one H100's 80 GB, as the reference's
    args + temp;
  * every ``Roofline.as_dict()`` term at the H100 constants;
  * the collective wire bytes by op and their count.

The reference also records XLA's ``cost_analysis()``; a torch program has
no compiled artifact, so ``xla_cost_flops`` and ``xla_cost_bytes`` are
left out.  ``count_s`` is the seconds of the counting run, and the
reference's ``compile_s`` holds the same seconds.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod --out f.jsonl
Exit code != 0 on any cell failure (a sharding the step cannot run, a
missing DTensor rule).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Iterable, Tuple

import torch

from .. import optim, roofline, serving, sharding
from ..configs import SHAPES, get_config, list_archs, shape_applicable
from ..data.pipeline import batch_pspecs, batch_specs
from ..models import transformer
from ..train.loop import make_sharded_train_step
from .mesh import make_production_mesh

#: torch dtype of each batch spec's numpy dtype
_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def _abstract_batch(cfg, shape):
    return {k: torch.empty(v.shape, dtype=_DTYPES[str(v.dtype)],
                           device="meta")
            for k, v in batch_specs(cfg, shape).items()}


def _abstract_opt(aparams):
    f32 = {name: torch.empty(p.shape, dtype=torch.float32, device="meta")
           for name, p in aparams.named_parameters()}
    return {"m": f32,
            "v": {k: torch.empty_like(t) for k, t in f32.items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _tree_device_bytes(leaves: Iterable[Tuple[Tuple[int, ...], int, tuple]],
                       sizes: dict) -> float:
    """Per-device bytes of ``(shape, itemsize, spec)`` leaves on a mesh of
    ``sizes`` (``{axis: size}``): each leaf's bytes over the product of the
    sizes of the axes its spec names."""
    total = 0.0
    for shape, itemsize, spec in leaves:
        n = 1
        for d in shape:
            n *= int(d)
        denom = 1
        for ax in spec:
            if ax is None:
                continue
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                denom *= sizes[a]
        total += n * itemsize / denom
    return total


def arg_bytes_per_device(cfg, shape, rules: sharding.MeshRules,
                         mesh) -> float:
    """Static per-device bytes of the cell's arguments: the parameters
    (times 3 for a train step: parameters and the two AdamW moments, as the
    reference counts them), plus the decode cache.  Pure arithmetic on the
    schema and the pspecs; ``mesh`` needs only ``mesh_dim_names`` and
    ``shape``, and must be the active one (the cache specs read it)."""
    sizes = sharding.mesh_sizes(mesh)
    p_item = torch.empty((), dtype=getattr(torch, cfg.param_dtype)
                         ).element_size()
    pspecs = transformer.param_pspecs(cfg, rules)
    params = _tree_device_bytes(
        ((pd.shape, p_item, pspecs[path]) for path, pd in
         transformer.flat_schema(transformer.model_schema(cfg))), sizes)
    if shape.kind == "train":
        return params * 3.0
    if shape.kind == "prefill":
        return params
    long_ctx = shape.name == "long_500k"
    c_item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    specs = transformer.cache_pspecs(cfg, rules, long_ctx)
    cache = _tree_device_bytes(
        ((pd.shape, c_item, specs[i][name])
         for i, spec in enumerate(cfg.layout)
         for name, pd in transformer._layer_cache_def(
             cfg, spec, shape.global_batch, shape.seq_len).items()), sizes)
    return params + cache


def _at_rest(cfg, shape, rules: sharding.MeshRules, mesh, bpspecs, args):
    """The cell's arguments laid out on ``mesh`` as its step lays them out
    (parameters in place), so that the count meets each device's shards
    and the step's own layout calls find nothing to move."""
    pspecs = transformer.param_pspecs(cfg, rules)
    params, rest = args[0], args[1:]
    transformer.distribute_params(params, pspecs, mesh)
    if shape.kind == "train":
        opt, batch = rest
        return (params, sharding.distribute_tree(
            opt, {"m": pspecs, "v": pspecs, "step": sharding.P()}, mesh),
            sharding.distribute_tree(batch, bpspecs, mesh))
    if shape.kind == "prefill":
        return params, sharding.distribute_tree(rest[0], bpspecs, mesh)
    cache, batch, pos = rest
    specs = transformer.cache_pspecs(cfg, rules,
                                     long_context=shape.name == "long_500k")
    return (params, sharding.distribute_tree(cache, specs, mesh),
            sharding.distribute_tree(batch, bpspecs, mesh), pos)


def _fake_group(world: int):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group is already initialised; "
                           "run the dry-run in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             fsdp: bool = False, seq_act: bool = True, attn_mode: str = "none",
             ep_shard_map: bool = False, causal_skip: bool = False,
             attn_chunk: int = None,
             remat: str = None, capacity_factor: float = None,
             verbose: bool = True) -> dict:
    import torch.distributed as dist

    cfg = get_config(arch)
    overrides = {}
    if remat is not None:
        overrides["remat_policy"] = remat
    if capacity_factor is not None:
        overrides["capacity_factor"] = capacity_factor
    if fsdp:
        overrides["fsdp"] = True
    if causal_skip:
        overrides["attn_causal_skip"] = True
    if attn_chunk:
        overrides["attn_chunk_q"] = attn_chunk
        overrides["attn_chunk_kv"] = attn_chunk
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "fsdp": fsdp, "seq_act": seq_act, "attn_mode": attn_mode,
           "ep_shard_map": ep_shard_map,
           "remat": cfg.remat_policy, "capacity_factor": cfg.capacity_factor}

    if not shape_applicable(cfg, shape):
        rec["status"] = "skipped"
        rec["reason"] = ("long_500k requires sub-quadratic token mixing; "
                         f"{cfg.family} is full-attention (DESIGN.md §4)")
        return rec

    long_ctx = shape.name == "long_500k"
    n_dev = 512 if multi_pod else 256
    _fake_group(n_dev)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        mk_rules = (sharding.multi_pod_rules if multi_pod
                    else sharding.single_pod_rules)
        rules = mk_rules(fsdp=cfg.fsdp, long_context=long_ctx)
        rules = dataclasses.replace(rules, seq_act=seq_act,
                                    attn_mode=attn_mode,
                                    ep_shard_map=ep_shard_map)

        t0 = time.perf_counter()
        with sharding.mesh_context(mesh, rules):
            aparams = transformer.abstract_params(cfg)
            abatch = _abstract_batch(cfg, shape)
            bpspecs = batch_pspecs(cfg, shape, rules)
            if shape.kind == "train":
                step = make_sharded_train_step(cfg, optim.OptConfig(), rules,
                                               bpspecs, donate=False)
                args = (aparams, _abstract_opt(aparams), abatch)
            elif shape.kind == "prefill":
                step = serving.make_sharded_prefill(cfg, rules, bpspecs,
                                                    max_len=shape.seq_len)
                args = (aparams, abatch)
            else:                                     # decode
                acache = transformer.abstract_cache(cfg, shape.global_batch,
                                                    shape.seq_len)
                step = serving.make_sharded_decode(cfg, rules, bpspecs,
                                                   long_context=long_ctx,
                                                   donate=False)
                # the last slot: a full cache
                args = (aparams, acache, abatch, shape.seq_len - 1)
            arg_bytes = arg_bytes_per_device(cfg, shape, rules, mesh)
            args = _at_rest(cfg, shape, rules, mesh, bpspecs, args)
            t_lower = time.perf_counter() - t0

            t0 = time.perf_counter()
            hc = roofline.analyze_step(step, *args, n_devices=n_dev)
            t_count = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()

    rl = roofline.roofline_of(
        hc, n_dev, roofline.model_flops(cfg, shape,
                                        transformer.active_params(cfg)))
    rec.update({
        "status": "ok",
        "n_devices": n_dev,
        "lower_s": round(t_lower, 2),
        "count_s": round(t_count, 2),
        "compile_s": round(t_count, 2),
        "arg_bytes_per_device": arg_bytes,
        "memory_analysis": {"temp_bytes": hc.peak_bytes,
                            "argument_bytes": hc.argument_bytes,
                            "output_bytes": hc.output_bytes},
        "collectives": {k: round(v) for k, v in hc.wire_by_op.items()},
        "n_collectives": hc.n_collectives,
        "unknown_trip_counts": hc.unknown_trip_counts,
        **rl.as_dict(),
    })
    if verbose:
        fits = arg_bytes + hc.peak_bytes
        print(f"[dryrun] {arch} × {shape_name} × {rec['mesh']}: "
              f"count {t_count:.1f}s  "
              f"flops/dev {rl.flops_per_device:.3e}  "
              f"bytes/dev {rl.bytes_per_device:.3e}  "
              f"wire/dev {rl.wire_bytes_per_device:.3e}  "
              f"bound={rl.bound}  frac={rl.roofline_fraction:.3f}  "
              f"args+temp/dev {fits / 1e9:.2f} GB "
              f"({'fits' if fits <= roofline.HBM_BYTES else 'EXCEEDS'} "
              f"{roofline.HBM_BYTES / 1e9:.0f} GB)")
        print(f"[dryrun]   memory_analysis: {rec['memory_analysis']}")
        print(f"[dryrun]   collectives: {rec['collectives']} "
              f"({hc.n_collectives} ops)")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--attn-mode", default="none",
                    choices=["none", "auto", "ulysses", "cp"])
    ap.add_argument("--ep-shard-map", action="store_true")
    ap.add_argument("--causal-skip", action="store_true")
    ap.add_argument("--attn-chunk", type=int, default=None)
    ap.add_argument("--no-seq-act", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = run_cell(arch, shape, multi_pod=mp, fsdp=args.fsdp,
                                   seq_act=not args.no_seq_act,
                                   attn_mode=args.attn_mode,
                                   ep_shard_map=args.ep_shard_map,
                                   causal_skip=args.causal_skip,
                                   attn_chunk=args.attn_chunk,
                                   remat=args.remat,
                                   capacity_factor=args.capacity_factor)
                except Exception as e:   # noqa: BLE001 — cell failure is a bug
                    traceback.print_exc()
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "2x16x16" if mp else "16x16",
                           "status": "failed", "error": repr(e)}
                    failures += 1
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
