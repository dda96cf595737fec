"""Training cells of a latent-attention model (``"driver": "train_mla"``):
the launcher's loop as ``drivers.train`` drives it (its ``Program``, its
checked steps and its readings), with what such a model adds:

- the step's model FLOPs count 6 (D + DV) a live attention pair, the q/k
  and value head widths apart (``counts.mla``);
- the step runs with a ``Telemetry`` that records only in the traced
  tail, where it counts the MoE layers' routing (``moe.held_pairs``,
  ``moe.kept_pairs``) and its spans (``mla.*``, ``moe.*``, ``train.*``)
  lie in the profiler's trace; the tail also records the flash calls
  with both head widths;
- one more reading, ``bias_gap``: the balancing biases after the checked
  steps against the reference's, the summed absolute difference over
  the summed absolute reference bias;
- the window and the traced tail run as the launcher's step loop does,
  on a settled heap (``repro_torch.launch.train.settled_heap``): the
  objects set-up left are frozen out of the garbage collector's full
  collections, which would otherwise stop the host for a quarter of a
  second every few steps;
- the reference's seconds (``reference_s``) in the record."""
from __future__ import annotations

import dataclasses
import importlib
import time

import numpy as np
import torch

from portbench import common
from portbench.counts import mla, ops, peaks
from portbench.drivers import train
from portbench.traffic import corpus

#: The MoE counters the traced tail reads.
COUNTERS = ("moe.pairs", "moe.held_pairs", "moe.kept_pairs", "moe.slots")


def biases(program: train.Program) -> dict:
    """The balancing biases of the program's tree, by leaf name, float32
    on the host: copies, which the steps after do not move."""
    from repro_torch.models.moe import BIAS
    from repro_torch.train.tree import named_leaves
    return {n: train._local(t).float().cpu().clone()
            for n, t in named_leaves(program.params)
            if n.endswith("/" + BIAS)}


def bias_gap(got: dict, want: dict) -> float:
    """sum |got - want| / sum |want| over every bias element."""
    diff = sum(float((got[n] - want[n]).abs().sum()) for n in want)
    size = sum(float(want[n].abs().sum()) for n in want)
    return diff / max(size, 1e-30)


def build(cell: dict, conf: dict, seed: int, dev, ref):
    """The program, its step made with a ``Telemetry`` that is off until
    the traced tail starts it: (program, telemetry)."""
    from repro_torch.obs.telemetry import Telemetry
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import make_train_step
    program = train.Program(cell, conf, seed, dev, ref)
    tel = Telemetry(mode="off")
    program.step_fn = make_train_step(
        program.cfg, OptimizerConfig(**cell["params"]["optimizer"]),
        n_microbatches=1, telemetry=tel)
    return program, tel


def check_steps(program, conf, cell, seed, ref) -> dict:
    """``drivers.train.check_steps``, then the biases as they stand."""
    out = train.check_steps(program, conf, cell, seed, ref)
    t = time.perf_counter()
    out["biases"] = biases(program)
    out["read_s"] += time.perf_counter() - t
    return out


def readings(prog: dict, ref: dict) -> dict:
    """``drivers.train.readings`` and ``bias_gap``."""
    out = train.readings(prog, ref)
    out["bias_gap"] = bias_gap(prog["biases"], ref["biases"])
    return out


def run(cell: dict, conf: dict, opts: common.Options) -> common.Outcome:
    """One run of a latent-attention training cell."""
    p = cell["params"]
    dev = opts.device
    ref = importlib.import_module(f"portbench.reference.{conf['reference']}")
    program, tel = build(cell, conf, opts.seed, dev, ref)
    checked = check_steps(program, conf, cell, opts.seed, ref)
    common.synchronize(dev)
    setup_s = time.perf_counter() - opts.t0 - checked["read_s"]

    # The window: closed-loop steps until --seconds have passed, then the
    # traced tail, both on the launcher's settled heap.
    from repro_torch.launch.train import settled_heap
    with settled_heap():
        stats0 = dataclasses.replace(program.pipeline.stats)
        walls, pipe = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < opts.seconds:
            nb, wall, _ = program.step()
            walls.append(wall)
            pipe.append(nb)
        window_s = time.perf_counter() - t0
        stats1 = dataclasses.replace(program.pipeline.stats)
        trace = traced_tail(program, tel, p["trace_steps"]) \
            if opts.trace else None

    cfg = program.cfg
    tokens = program.batch * program.seq
    pairs = ops.live_pairs(program.batch, cfg.n_heads, program.seq, True)
    qk, dv = cfg.attention_dims
    flops = mla.train_step_flops(ref.active_params(conf), tokens, qk, dv,
                                 pairs, cfg.n_layers)
    record = {"steps": len(walls), "window_s": window_s,
              "step_flops": flops, "peak_flops": peaks.BF16_FLOPS_PER_S,
              "pipeline_s": sum(pipe),
              "pipeline_steps": stats1.steps - stats0.steps,
              "pipeline_cache_hit_steps":
                  stats1.cache_hit_steps - stats0.cache_hit_steps}
    if trace is not None:
        record["trace"] = trace
    memory_peak = common.memory_peak(dev)
    n_served = len(program.batches)
    served = program.batches
    program.close()

    # The reference, once the program's state is freed.
    batches = [corpus.expected_batch(program.docs, i, program.batch,
                                     program.seq) for i in range(n_served)]
    mismatched = sum(int((a["tokens"] != b["tokens"]).sum() +
                         (a["labels"] != b["labels"]).sum())
                     for a, b in zip(served, batches))
    common.reference_mode(dev)
    t0 = time.perf_counter()
    want = ref.train(conf, p["optimizer"], opts.seed,
                     [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                      for b in batches[:p["check_steps"]]], dev)
    record["reference_s"] = time.perf_counter() - t0
    numbers = readings(checked, want)
    numbers["batch_mismatches"] = mismatched
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    checks = [common.Check(n, numbers[n], limit)
              for n, limit in cell["limits"].items()]
    e2e = {"setup_s": setup_s,
           "train_tokens_per_s": tokens * len(walls) / window_s,
           "train_step_p90_s": float(np.percentile(walls, 90))}
    return common.Outcome(e2e=e2e, record=record, checks=checks,
                          attempted=n_served, failed=0,
                          memory_peak_bytes=memory_peak)


def traced_tail(program: train.Program, tel, n: int) -> dict:
    """``n`` more steps under the profiler with ``tel`` recording: the
    device's busy time, the kernels' device seconds, the idle gaps by the
    host span they fall in (the program's spans among them), the flash
    calls with their shapes (``work``) and the MoE counters
    (``counters``)."""
    from repro_torch.kernels.flash_attention.flash_attention import LAUNCHES
    cfg = program.cfg
    before = dict(LAUNCHES)
    tel.start()
    try:
        with common.Profiled(program.dev) as prof:
            for _ in range(n):
                program.step(spans=prof.span)
    finally:
        rec = tel.stop()
    qk, dv = cfg.attention_dims
    shape = {"batch": program.batch, "seq": program.seq,
             "heads": cfg.n_heads, "qk_dim": qk, "v_dim": dv,
             "causal": True, "elem_bytes": 2, "lse": True}
    work = {name: dict(shape, calls=LAUNCHES[k] - before.get(k, 0))
            for name, k in (("mla_flash_fwd", "flash_attention_fwd"),
                            ("mla_flash_bwd", "flash_attention_bwd"))}
    counters = {c: rec.registry.counter(c).value for c in COUNTERS}
    return dict(prof.result(), work=work, counters=counters)
