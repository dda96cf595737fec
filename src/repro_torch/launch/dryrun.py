"""Multi-pod dry-run: every (arch x shape) cell on the production meshes,
per-chip counts and roofline terms, nothing allocated.

The port of ``repro/launch/dryrun.py``. Where the reference lowers and
compiles each cell for 256 or 512 forced host devices, this runs the
port's own step once on one rank of a fake process group of 512 ranks
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), with parameters, AdamW state and batches as ``DTensor``s placed
by the sharding rules and fake tensors (``FakeTensorMode``) as their
local shards. ``op_analysis`` counts the rank's per-chip work on its
local shards, and ``roofline`` turns it into terms for an H100. The
train step includes its backward and the AdamW update, with every layer
rematerialised. A failing cell is a ``fail`` row and the run exits
non-zero.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape decode_32k --mesh multipod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out results.jsonl
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import (SHAPES, SHAPES_BY_NAME, get, list_archs,
                                 shape_applicable)
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import (MeshShape, make_production_mesh,
                                     mesh_over_group)
from repro_torch.launch.op_analysis import OpAnalyzer, nbytes
from repro_torch.launch.roofline import build_report, format_row
from repro_torch.serve.serve_step import make_prefill_step, make_serve_step
from repro_torch.sharding.local import is_dtensor
from repro_torch.sharding.partition import axis_sizes, make_policy
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import leaves

#: Ranks of the fake world: the two-pod mesh, the pod mesh its first 256.
WORLD = 512


def fake_world(size: int = WORLD) -> None:
    """This process's fake process group of ``size`` ranks (made once;
    a process has one)."""
    if dist.is_initialized():
        if dist.get_world_size() < size:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks exists; the "
                               f"dry-run needs {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def opt_config_for(cfg: ModelConfig) -> OptimizerConfig:
    """bf16 moments above 5e10 parameters, as the reference."""
    return OptimizerConfig(
        state_dtype=torch.bfloat16 if cfg.param_count() > 5e10 else None)


def attention_impl_for(seq_len: int) -> str:
    """Naive attention up to 1024 positions, the flash kernel beyond."""
    return "naive" if seq_len <= 1024 else "blockwise"


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Any,
               analyzer: OpAnalyzer, *, seq_axes=None,
               n_microbatches: int = 1,
               fsdp_threshold: float = 5e9) -> Dict[str, float]:
    """Build the abstract inputs of one cell on ``mesh`` and run its step
    once under ``analyzer``. Must run inside ``FakeTensorMode``. Returns
    the per-chip argument and output bytes (local shards) and
    ``temp_bytes``, the peak that ``MemTracker`` saw the step allocate on
    this rank beyond its arguments."""
    policy = make_policy(cfg, mesh, fsdp_threshold)
    params = ispec.abstract_params(cfg, mesh, policy)
    if shape.kind == "train":
        opt_cfg = opt_config_for(cfg)
        step = make_train_step(cfg, opt_cfg, n_microbatches=n_microbatches,
                               attention_impl=attention_impl_for(
                                   shape.seq_len), remat=True)
        opt = ispec.abstract_opt_state(params, opt_cfg)
        batch = ispec.abstract_batch(cfg, shape, mesh, policy)
        args = (params, opt, batch)
    elif shape.kind == "prefill":
        step = make_prefill_step(cfg, attention_impl_for(shape.seq_len))
        batch = ispec.abstract_batch(cfg, shape, mesh, policy)
        args = (params, batch.get("tokens"), batch.get("embeds"))
    elif shape.kind == "decode":
        step = make_serve_step(cfg)
        dec = ispec.abstract_decode_inputs(cfg, shape, mesh, policy,
                                           seq_axes=seq_axes)
        args = (params, dec["tokens"], dec["state"], dec["pos"])
    else:
        raise ValueError(shape.kind)
    tracker = MemTracker()
    with implicit_replication(), tracker, analyzer:
        out = step(*args)
    peak = tracker.get_tracker_snapshot("peak")
    return {"argument_bytes": local_bytes(args),
            "output_bytes": local_bytes(out),
            "temp_bytes": sum(v.get("Total", 0) for v in peak.values())}


def local_bytes(tree: Any) -> int:
    """Bytes of the local shards of every tensor in ``tree``."""
    return sum(nbytes(t.to_local() if is_dtensor(t) else t)
               for t in leaves(tree))


# Sequence parallelism winners, measured per arch on train_4k by the
# reference (its §Perf D): dense attention stacks gain; MoE archs and
# nemotron lose.
SP_WINNERS = frozenset({"qwen1.5-0.5b", "olmo-1b", "llama3.2-3b",
                        "hubert-xlarge", "internvl2-2b"})


def apply_variant(cfg: ModelConfig, variant: str,
                  arch: Optional[str] = None) -> ModelConfig:
    """'baseline' reverts the reference's hillclimb changes (sequential
    mLSTM, einsum MoE dispatch, one-hot KV update); 'optimized' keeps
    them and turns on sequence parallelism for :data:`SP_WINNERS` (by
    ``arch``, default ``cfg.name``: a reduced config keeps its arch's)."""
    if variant == "baseline":
        return dataclasses.replace(cfg, mlstm_impl="sequential",
                                   moe_dispatch="einsum",
                                   kv_update="onehot")
    if (arch or cfg.name) in SP_WINNERS:
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    return cfg


def run_cell(arch: str, shape_name: str, mesh_name: str,
             dump_ops: Optional[str] = None, verbose: bool = True,
             variant: str = "optimized", *,
             cfg: Optional[ModelConfig] = None,
             shape: Optional[ShapeConfig] = None,
             mesh_shape: Optional[MeshShape] = None) -> dict:
    """One cell's row. ``cfg``, ``shape`` and ``mesh_shape`` override the
    registered config, the named shape and the production mesh (the
    tests run reduced configs on small fake meshes)."""
    cfg = apply_variant(cfg or get(arch), variant, arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skip", "reason": reason}
    if mesh_shape is None:
        fake_world(WORLD)
        mesh = make_production_mesh(multi_pod=mesh_name == "multipod")
    else:
        fake_world(mesh_shape.size)
        mesh = mesh_over_group(mesh_shape)
    chips = mesh.size()
    analyzer = OpAnalyzer(mesh, record_ops=dump_ops is not None)
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True):
        ma = lower_cell(cfg, shape, mesh, analyzer)
    t_lower = time.time() - t0
    cost = analyzer.cost
    if dump_ops:
        os.makedirs(dump_ops, exist_ok=True)
        fn = os.path.join(dump_ops, f"{arch}_{shape_name}_{mesh_name}.tsv")
        with open(fn, "w") as f:
            f.write("op\tlaunches\tflops\tbytes\n")
            for name, n, fl, b in analyzer.op_table():
                f.write(f"{name}\t{n}\t{fl:.6e}\t{b:.6e}\n")
    hbm = float(ma["argument_bytes"] + ma["temp_bytes"] +
                ma["output_bytes"])
    report = build_report(arch, shape, mesh_name, chips, cost, cfg,
                          hbm_per_chip=hbm, axis_sizes=axis_sizes(mesh))
    row = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips, "variant": variant,
        "lower_s": round(t_lower, 2),
        "memory_analysis": dict(ma),
        "hlo_flops_per_chip": report.flops_per_chip,
        "hlo_bytes_per_chip": report.bytes_per_chip,
        "coll_bytes_per_chip": report.coll_bytes_per_chip,
        "coll_by_kind": report.coll_by_kind,
        "coll_by_axis": dict(cost.coll_by_axis),
        "compute_s": report.compute_s,
        "memory_s": report.memory_s,
        "collective_s": report.collective_s,
        "serial_s": report.serial_s,
        "seq_iters": report.seq_iters,
        "bottleneck": report.bottleneck,
        "model_flops": report.model_flops,
        "useful_ratio": report.useful_ratio,
        "roofline_fraction": report.roofline_fraction,
        "hbm_per_chip": hbm,
    }
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] lower {t_lower:.1f}s")
        print("  memory_analysis:", row["memory_analysis"])
        print("  " + format_row(report))
    return row


def main(argv=None) -> None:
    """Run the cells the flags name; exit non-zero if any failed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=list_archs(), default=None)
    ap.add_argument("--shape", choices=[s.name for s in SHAPES], default=None)
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="JSONL output path")
    ap.add_argument("--dump-ops", default=None,
                    help="directory to write each cell's per-op table")
    ap.add_argument("--variant", choices=["baseline", "optimized"],
                    default="optimized")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]

    rows = []
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                try:
                    row = run_cell(arch, shape, mesh_name,
                                   dump_ops=args.dump_ops,
                                   variant=args.variant)
                except Exception as e:   # a cell failure is a sharding bug
                    traceback.print_exc()
                    row = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "fail", "error": repr(e)}
                    failures += 1
                rows.append(row)
                if row["status"] == "skip":
                    print(f"[{arch} x {shape} x {mesh_name}] SKIP: "
                          f"{row['reason']}")
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(row) + "\n")
    ok = sum(1 for r in rows if r["status"] == "ok")
    sk = sum(1 for r in rows if r["status"] == "skip")
    print(f"\ndry-run: {ok} ok, {sk} skipped, {failures} failed")
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
