"""The multi-pod dry-run: the JAX package's `launch/dryrun.py`.

For every (architecture x input shape) cell, count one rank's step
(train, prefill or decode) on the production mesh and emit its roofline
report:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k [--multi-pod] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The mesh is a fake process group of the production mesh's size (16x16,
or 2x16x16 with --multi-pod; `launch.mesh.make_production_mesh`): this
process is rank 0, every collective it dispatches returns at once and
moves nothing. The step runs under `FakeTensorMode`, so nothing is
allocated: each param is rank 0's block of it (`sharding.model_layout`:
the port's tensor-parallel layout over "model", replicated over "data"),
its batch its block of rows, its cache its block (batch over DP, KV
heads over "model" where they divide, else the head its query heads
read). `roofline.counter.count()` charges the step's aten ops, kernel
ops and collectives (the ring model), and the report is
`roofline.analysis.build_report` with `n_devices` the mesh's size, as
the reference ends in its `build_report`. The reference lowers and
compiles with XLA; there is no compiler here, and no memory analysis.

A cell is written as skipped ({"skipped": true, "reason": ...}) where
`specs.applicable` skips it, and where the port does not shard its
family or its dims over "model" (`sharding.check_tp`: ROADMAP queue 1
item 2). With --out each report is a JSON file there
(<arch>__<shape>__<singlepod|multipod>.json); without it the reports are
only printed: nothing is written unasked.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import SHAPES, get_shape
from repro_torch.core.tree import tree_map
from repro_torch.distributed import context as ctx
from repro_torch.distributed import sharding as SH
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as S
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline import counter
from repro_torch.training import train_loop as TL


def _skipped(arch, shape, reason) -> dict:
    return {"arch": arch, "shape": shape, "skipped": True, "reason": reason}


def _local_params(cfg, mesh):
    params = M.init_params(cfg, torch.Generator(), "cpu")
    return tree_map(lambda s, x: SH.Sharding(mesh, s).local(x),
                    SH.model_layout(cfg, params, mesh), params)


def _local_batch(batch, mesh, multi_pod):
    dp = ctx.axis_size(mesh_lib.dp_axes(multi_pod), mesh)
    specs = S.batch_pspec(batch, multi_pod=multi_pod, dp=dp)
    return {k: SH.Sharding(mesh, specs[k]).local(v) for k, v in batch.items()}


def _local_cache(cfg, cache, mesh, multi_pod):
    """Rank 0's block of the cache: `sharding.cache_specs`, but the KV
    heads that do not divide over "model" cut to the one this rank's
    query heads read (models.attention), where the reference keeps them
    all."""
    tp = ctx.axis_size("model", mesh)
    specs = SH.cache_specs(cache, mesh, multi_pod=multi_pod)
    kv_head = None
    if cfg.n_kv_heads % tp:
        kv_head = ctx.model_index(mesh) // (tp // cfg.n_kv_heads)

    def one(path_s, leaf):
        spec = SH.Sharding(mesh, _spec_at(specs, path_s))
        out = spec.local(leaf)
        if kv_head is not None and path_s.rsplit("/", 1)[-1] in ("k", "v"):
            out = out.narrow(out.dim() - 2, kv_head, 1)
        return out
    return SH._map_paths(one, cache)


def _spec_at(tree, path_s):
    for k in path_s.split("/"):
        tree = tree[k]
    return tree


def _count(cfg, cell, mesh, multi_pod):
    """The Costs of one rank's step of `cell`, counted on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(), ctx.mesh_context(mesh, multi_pod=multi_pod):
        if cell.kind == "train":
            opt = AdamW(lr=cosine_schedule(3e-4, 2000, 100_000),
                        state_dtype="float32")
            state = TL.init_state(cfg, opt, torch.Generator(), "cpu",
                                  mesh=mesh)
            step = TL.make_train_step(cfg, opt, accum=1, mesh=mesh)
            batch = S.train_batch_specs(cfg, cell)
            with counter.count() as costs:
                step(state, batch)
            return costs
        params = _local_params(cfg, mesh)
        if cell.kind == "prefill":
            batch = _local_batch(S.prefill_batch_specs(cfg, cell), mesh,
                                 multi_pod)
            cache = _local_cache(cfg, S.cache_specs_struct(cfg, cell), mesh,
                                 multi_pod)
            with torch.no_grad(), counter.count() as costs:
                M.prefill(cfg, params, batch, cache)
            return costs
        token, pos, cache = S.decode_inputs(cfg, cell)
        token = _local_batch({"t": token}, mesh, multi_pod)["t"]
        cache = _local_cache(cfg, cache, mesh, multi_pod)
        with torch.no_grad(), counter.count() as costs:
            M.decode_step(cfg, params, token, pos, cache)
        return costs


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               overrides: dict | None = None, verbose: bool = True):
    """Count one cell. Returns (costs or None, its report as a dict)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = get_shape(shape_name)
    ok, reason = S.applicable(cfg, cell)
    if not ok:
        return None, _skipped(arch, shape_name, reason)
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod)
    try:
        SH.check_tp(cfg, ctx.axis_size("model", mesh))
    except (NotImplementedError, ValueError) as e:
        return None, _skipped(arch, shape_name, str(e))
    mesh_name = "x".join(str(s) for s in mesh.shape)
    n_dev = mesh.size()

    t0 = time.time()
    costs = _count(cfg, cell, mesh, multi_pod)
    t_count = time.time() - t0
    report = roofline.build_report(
        cfg, cell, kind=cell.kind, costs=costs, mesh_name=mesh_name,
        n_devices=n_dev,
        note=f"rank 0's step on a fake process group of {n_dev}, counted "
             f"under FakeTensorMode")
    rj = report.to_json()
    rj["count_seconds"] = t_count
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] counted in "
              f"{t_count:.1f}s; collectives {costs.collective_summary()}")
        print("  " + report.summary_line())
    return costs, rj


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=None,
                    help="a directory for the reports' JSON files (none: "
                         "print them only)")
    args = ap.parse_args(argv)
    if args.all:
        cells = [(a, s.name) for a in ARCH_NAMES for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    failures, reports = [], []
    for arch, shape in cells:
        tag = "multipod" if args.multi_pod else "singlepod"
        try:
            _, rj = lower_cell(arch, shape, multi_pod=args.multi_pod)
        except Exception:
            failures.append((arch, shape))
            traceback.print_exc()
            continue
        reports.append(rj)
        if rj.get("skipped"):
            print(f"[{arch} x {shape}] skipped: {rj['reason']}")
        if args.out:
            with open(os.path.join(args.out,
                                   f"{arch}__{shape}__{tag}.json"), "w") as f:
                json.dump(rj, f, indent=2)
        else:
            print(json.dumps(rj))
    if failures:
        print("FAILED cells:", failures)
        sys.exit(1)
    print("dry-run complete:", len(cells), "cells")
    return reports


if __name__ == "__main__":
    main()
