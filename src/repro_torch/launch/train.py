"""Training launcher: the end-to-end entry point that wires the raw-array
cached data pipeline, the model, AdamW, async checkpointing and resume
together.

The port of ``repro/launch/train.py``, on one device: the model is not
sharded (``sharding/partition.py`` and ``launch/mesh.py`` are later
slices of the port), so ``--scale full`` trains the full configuration
on the one card. ``--device`` (default ``cuda``) picks the device;
``cpu`` runs the kernels' plain versions.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --arch qwen1.5-0.5b --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import tempfile
import time

import torch

from repro_torch.configs import get, list_archs, reduced
from repro_torch.data.pipeline import build_pipeline
from repro_torch.models.model import init_params, resolve_device
from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                          latest_checkpoint,
                                          restore_checkpoint)
from repro_torch.train.optimizer import OptimizerConfig, adamw_init
from repro_torch.train.train_step import make_train_step


def main(argv=None) -> dict:
    """Parse the flags, train, and return ``{"losses", "pipeline_stats"}``."""
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
        host_budget_bytes=8 << 20, seed=args.seed)

    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=10,
                              total_steps=args.steps)
    params = init_params(cfg, seed=args.seed, device=dev)
    opt_state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, n_microbatches=args.microbatches)

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
    for step in range(start, args.steps):
        batch = pipeline.next_batch()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
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
