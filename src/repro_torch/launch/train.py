"""Training launcher: the end-to-end entry point that wires the raw-array
cached data pipeline, the sharded model, AdamW, async checkpointing and
resume together.

The port of ``repro/launch/train.py``. Parameters, AdamW moments and
batches are ``DTensor``s on the mesh of the devices this job has
(``launch.mesh.make_host_mesh``: ``(1, 1)`` on one card, over a
one-rank NCCL group), placed by the sharding rules
(:func:`place_params`, :func:`place_batch`); the attention kernels run
on each rank's local shards. The reference builds the 256-chip
production mesh for ``--scale full``; this machine is not a pod, so
``--scale full`` trains the full configuration on the host mesh, and
the production meshes are reached by the dry-run
(``repro_torch.launch.dryrun``). ``--device`` (default ``cuda``) picks
the device; ``cpu`` runs the kernels' plain versions over gloo. A
``telemetry`` handed to :func:`main` is the pipeline's and the step's,
and traces each batch's placement (``launch.place_batch``) and the
loss's read back (``launch.readback``) besides.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen1.5-0.5b --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import tempfile
import time

import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get, list_archs, reduced
from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import build_pipeline
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import init_params, resolve_device
from repro_torch.obs.telemetry import NULL_TELEMETRY, Telemetry
from repro_torch.sharding.local import is_dtensor
from repro_torch.sharding.partition import (ShardingPolicy, batch_spec,
                                            make_policy, param_specs, place,
                                            place_tree)
from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                          latest_checkpoint,
                                          restore_checkpoint)
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
from repro_torch.train.train_step import make_train_step
from repro_torch.train.tree import Tree


def place_params(params: Tree, mesh, policy: ShardingPolicy) -> Tree:
    """The parameters as ``DTensor``s on ``mesh``, placed by
    ``param_specs`` (the reference's ``param_shardings`` +
    ``device_put``)."""
    return place_tree(params, param_specs(params, mesh, policy), mesh)


def place_batch(batch: dict, mesh, policy: ShardingPolicy,
                telemetry: Telemetry = NULL_TELEMETRY) -> dict:
    """Each batch field as a ``DTensor`` on ``mesh``, its batch dim over
    the DP axes by ``batch_spec``."""
    with telemetry.tracer.span("launch.place_batch"):
        return {k: place(v, batch_spec(mesh, policy, v.shape[0],
                                       v.ndim - 1), mesh)
                for k, v in batch.items()}


def scalar(x, telemetry: Telemetry = NULL_TELEMETRY) -> float:
    """A metric (plain or ``DTensor``) as a Python float."""
    with telemetry.tracer.span("launch.readback"):
        return float(x.full_tensor() if is_dtensor(x) else x)


def placed_state(cfg: ModelConfig, opt_cfg: OptimizerConfig, seed: int,
                 mesh, policy: ShardingPolicy):
    """Parameters from ``seed`` on ``mesh``'s device type, placed, and
    their AdamW state (moments placed like them)."""
    params = place_params(init_params(cfg, seed=seed,
                                      device=mesh.device_type), mesh, policy)
    return params, adamw_init(params, opt_cfg)


@contextlib.contextmanager
def settled_heap():
    """The step loop's heap: what set-up left is collected and every
    object that survives is frozen out of the collector's sight
    (``gc.freeze``) until the loop ends (``gc.unfreeze``). A full
    collection walks every object the process tracks, the libraries'
    few hundred thousand among them; the steps' survivors set one off
    every few steps, in the middle of a step, where the host stops
    feeding the device for a quarter of a second (a 27-layer model's
    step on an H100). Frozen, those objects are not walked again, and a
    full collection walks only what the steps made."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def main(argv=None, telemetry: Telemetry = NULL_TELEMETRY) -> dict:
    """Parse the flags, train, and return ``{"losses", "pipeline_stats"}``;
    the job records into ``telemetry``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen1.5-0.5b")
    ap.add_argument("--scale", choices=["reduced", "full"], default="reduced")
    ap.add_argument("--d-model", type=int, default=128,
                    help="reduced-scale width")
    ap.add_argument("--periods", type=int, default=2)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--data-policy", choices=["cost", "chunk_lru",
                                              "file_lru"], default="cost")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.scale == "reduced":
        cfg = reduced(cfg, d_model=args.d_model, n_periods=args.periods,
                      vocab=args.vocab)

    data_dir = args.data_dir or tempfile.mkdtemp(prefix="repro_data_")
    pipeline = build_pipeline(
        data_dir, n_samples=max(args.batch * 8, 64), seq=args.seq,
        vocab=cfg.vocab_size, n_hosts=4, batch=args.batch,
        policy=args.data_policy,
        host_budget_bytes=8 << 20, seed=args.seed, telemetry=telemetry)

    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    mesh = make_host_mesh(device=dev)
    policy = make_policy(cfg, mesh)
    params, opt_state = placed_state(cfg, opt_cfg, args.seed, mesh, policy)
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=args.microbatches,
                              telemetry=telemetry)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = AsyncCheckpointer(args.ckpt_dir, keep=3)
        latest = latest_checkpoint(args.ckpt_dir)
        if latest:
            tree, start, extra = restore_checkpoint(
                latest, {"params": params, "opt": opt_state})
            params, opt_state = tree["params"], tree["opt"]
            if "pipeline" in extra:
                pipeline.set_state(extra["pipeline"])
            print(f"restored step {start} from {latest}")

    losses = []
    t0 = time.time()
    with settled_heap():
        for step in range(start, args.steps):
            batch = pipeline.next_batch()
            batch = place_batch({k: torch.from_numpy(v).to(dev)
                                 for k, v in batch.items()}, mesh, policy,
                                telemetry)
            with implicit_replication():
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
            losses.append(scalar(metrics["loss"], telemetry))
            if step % args.log_every == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"step {step:5d} loss {losses[-1]:.4f} "
                      f"lr {scalar(metrics['lr']):.2e} "
                      f"gnorm {scalar(metrics['grad_norm']):.3f} "
                      f"({dt:.1f}s)")
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, {"params": params, "opt": opt_state},
                          extra={"pipeline": pipeline.state()})
    if ckpt:
        ckpt.wait()
    stats = pipeline.stats
    print(f"data pipeline: {stats.cache_hit_steps}/{stats.steps} cache-hit "
          f"steps, {stats.bytes_scanned/1e6:.1f} MB raw scanned")
    return {"losses": losses, "pipeline_stats": stats}


if __name__ == "__main__":
    main()
