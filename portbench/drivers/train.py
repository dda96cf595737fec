"""Training cells: the port's training launcher's loop
(``repro_torch.launch.train``) over the raw-array token pipeline.

Each step is the launcher's: ``RawArrayTokenPipeline.next_batch`` (a
subarray query through the caching cluster), ``place_batch`` onto the
device mesh, the ``make_train_step`` step under ``implicit_replication``,
and the loss read back on the host. Set-up makes the corpus and the
weights from the seed, places them as the launcher does, and drives the
first ``check_steps`` steps through that same loop; the plain reference
follows those steps after the window, from the same weights and its own
batches. Every batch the pipeline served is compared with the one the
corpus says it must serve."""
from __future__ import annotations

import dataclasses
import gc
import importlib
import shutil
import statistics
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import common
from portbench.counts import ops, peaks
from portbench.traffic import corpus


def program_config(conf: dict):
    """The port's config for ``conf``: its ``program.arch`` with
    ``program.replace`` applied (a dotted key replaces a field of a
    nested config), held to the configuration's keys by
    ``program.same`` (port field -> configuration key; dotted alike)."""
    from repro_torch.configs import get
    prog = conf["program"]
    cfg = get(prog["arch"])
    top = {k: v for k, v in prog.get("replace", {}).items() if "." not in k}
    for key, value in prog.get("replace", {}).items():
        if "." in key:
            group, field = key.split(".")
            top[group] = dataclasses.replace(top.get(group,
                                                     getattr(cfg, group)),
                                             **{field: value})
    cfg = dataclasses.replace(cfg, **top)
    for field, key in prog["same"].items():
        got = cfg
        for part in field.split("."):
            got = getattr(got, part)
        if got != conf[key]:
            raise ValueError(f"port config {field} = {got!r}, the "
                             f"configuration's {key} = {conf[key]!r}")
    return cfg


def _local(t: torch.Tensor) -> torch.Tensor:
    """A placed leaf's whole tensor (a plain tensor as it is)."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


class Program:
    """The port's training job as the launcher builds it, from the seed."""

    def __init__(self, cell: dict, conf: dict, seed: int, dev, ref):
        from repro_torch.arrayio.catalog import FileReader, build_catalog
        from repro_torch.arrayio.generator import GeneratedFile
        from repro_torch.core.geometry import Box
        from repro_torch.data.pipeline import RawArrayTokenPipeline
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.launch.train import place_params
        from repro_torch.sharding.partition import make_policy
        from repro_torch.train.optimizer import OptimizerConfig, adamw_init
        from repro_torch.train.train_step import make_train_step
        p = cell["params"]
        self.cfg = program_config(conf)
        self.dev = dev
        self.batch, self.seq = p["batch"], p["seq"]
        self.docs = corpus.documents(p, conf["vocab_size"], seed)
        self.tmp = tempfile.mkdtemp(prefix="portbench_")
        files = [GeneratedFile(c, a, Box(tuple(int(x) for x in c.min(0)),
                                         tuple(int(x) for x in c.max(0))))
                 for c, a in corpus.file_arrays(self.docs, p["n_files"])]
        catalog, data = build_catalog(files, self.tmp, p["fmt"],
                                      p["n_hosts"])
        self.pipeline = RawArrayTokenPipeline(
            catalog, FileReader(catalog, data), n_hosts=p["n_hosts"],
            host_budget_bytes=p["host_budget_bytes"], batch=self.batch,
            seq=self.seq, policy=p["data_policy"])
        opt_cfg = OptimizerConfig(**p["optimizer"])
        self.mesh = make_host_mesh(device=dev)
        self.policy = make_policy(self.cfg, self.mesh)
        self.params = place_params(ref.as_tree(ref.make_params(conf, seed,
                                                               dev)),
                                   self.mesh, self.policy)
        self.opt_state = adamw_init(self.params, opt_cfg)
        self.step_fn = make_train_step(self.cfg, opt_cfg, n_microbatches=1)
        self.batches: List[Dict[str, np.ndarray]] = []

    def step(self, spans=common.no_span):
        """One launcher step: (seconds in ``next_batch``, seconds of the
        whole step, the loss)."""
        from torch.distributed.tensor.experimental import \
            implicit_replication

        from repro_torch.launch.train import scalar
        t0 = time.perf_counter()
        with spans("next_batch"):
            raw = self.pipeline.next_batch()
        t1 = time.perf_counter()
        self.batches.append(raw)
        with spans("place_batch"):
            batch = self.feed(raw)
        with spans("train_step"):
            with implicit_replication():
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
        with spans("loss_readback"):
            loss = scalar(metrics["loss"])
        self.metrics = metrics
        return t1 - t0, time.perf_counter() - t0, loss

    def feed(self, raw: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A served batch on the device, placed as the launcher places
        it."""
        from repro_torch.launch.train import place_batch
        return place_batch({k: torch.from_numpy(v).to(self.dev)
                            for k, v in raw.items()}, self.mesh, self.policy)

    def leaf_norms(self, tree) -> Dict[str, float]:
        from repro_torch.train.tree import named_leaves
        return {n: float(_local(t).float().norm())
                for n, t in named_leaves(tree)}

    def leaf_samples(self, tree) -> Dict[str, torch.Tensor]:
        """Each leaf's elements at ``sample_index``, float32, on the
        host."""
        from repro_torch.train.tree import named_leaves
        from portbench.reference.moe_lm import sample_index
        out = {}
        for n, t in named_leaves(tree):
            flat = _local(t).reshape(-1)
            out[n] = flat[sample_index(flat.numel()).to(flat.device)
                          ].float().cpu()
        return out

    def close(self):
        """Free the job's device state and its files."""
        self.params = self.opt_state = self.step_fn = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(self.tmp, ignore_errors=True)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              names) -> Dict[str, float]:
    """Each leaf's |got - want| over the larger of want and the median
    of want over ``names``."""
    med = statistics.median(want[n] for n in names)
    return {n: abs(got[n] - want[n]) / max(want[n], med) for n in names}


def readings(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the check, program (or control) against the
    reference:

    - ``first_grad_gap``: the worst leaf's gap between the norms of the
      first clipped gradient;
    - ``first_grad_l2``: the median leaf's relative L2 distance between
      the first clipped gradients (on each leaf's ``sample_index``);
    - ``change_gap``: the worst leaf's gap between the norms of the
      parameters' change over the checked steps, leaving out the leaves
      whose reference gradient is under a thousandth of the median
      leaf's (round-off alone moves them under Adam);
    - and, read but not compared (``PERF.md`` says why): ``loss_gap``,
      the worst step's relative loss gap, and ``grad_norm_gap``, the
      first step's relative gap of the global norm before clipping."""
    names = sorted(ref["first_grad"])
    grad = leaf_gaps(prog["first_grad"], ref["first_grad"], names)
    l2 = {n: float((prog["first_grad_sample"][n] -
                    ref["first_grad_sample"][n]).norm() /
                   ref["first_grad_sample"][n].norm().clamp(min=1e-30))
          for n in names}
    med = statistics.median(ref["first_grad"].values())
    moved = [n for n in names if ref["first_grad"][n] >= 1e-3 * med]
    change = leaf_gaps(prog["change"], ref["change"], moved)
    return {
        "first_grad_gap": max(grad.values()),
        "first_grad_l2": statistics.median(l2.values()),
        "change_gap": max(change.values()),
        "loss_gap": max(abs(a - b) / abs(b) for a, b in
                        zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": abs(prog["grad_norm"] - ref["grad_norm"]) /
        ref["grad_norm"],
        "worst_grad_leaf": max(grad, key=grad.get),
        "worst_l2_leaf": max(l2, key=l2.get),
        "worst_change_leaf": max(change, key=change.get)}


def check_steps(program: Program, conf: dict, cell: dict, seed: int,
                ref) -> dict:
    """Drive the first ``check_steps`` steps and read what the reference
    is compared with: each step's loss, each leaf's first clipped
    gradient (from the first moment after one step) and each leaf's
    change over the steps. Returns them with the seconds the readings
    took (not set-up)."""
    p = cell["params"]
    out: dict = {"losses": [], "read_s": 0.0}
    for i in range(p["check_steps"]):
        out["losses"].append(program.step()[2])
        if i == 0:
            t = time.perf_counter()
            from repro_torch.launch.train import scalar
            out["grad_norm"] = scalar(program.metrics["grad_norm"])
            b1 = p["optimizer"]["b1"]
            out["first_grad"] = {
                n: v / (1 - b1)
                for n, v in program.leaf_norms(program.opt_state["m"]).items()}
            out["first_grad_sample"] = {
                n: v / (1 - b1)
                for n, v in program.leaf_samples(program.opt_state["m"]).items()}
            out["read_s"] += time.perf_counter() - t
    t = time.perf_counter()
    from repro_torch.train.tree import named_leaves
    start = ref.make_params(conf, seed, program.dev)
    out["change"] = {n: float((_local(x).float() - start[n].float()).norm())
                     for n, x in named_leaves(program.params)}
    del start
    out["read_s"] += time.perf_counter() - t
    return out


def run(cell: dict, conf: dict, opts: common.Options) -> common.Outcome:
    """One run of a training cell."""
    p = cell["params"]
    dev = opts.device
    ref = importlib.import_module(f"portbench.reference.{conf['reference']}")
    program = Program(cell, conf, opts.seed, dev, ref)
    checked = check_steps(program, conf, cell, opts.seed, ref)
    common.synchronize(dev)
    setup_s = time.perf_counter() - opts.t0 - checked["read_s"]

    # The window: closed-loop steps until --seconds have passed.
    stats0 = dataclasses.replace(program.pipeline.stats)
    walls, pipe = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < opts.seconds:
        nb, wall, _ = program.step()
        walls.append(wall)
        pipe.append(nb)
    window_s = time.perf_counter() - t0
    stats1 = dataclasses.replace(program.pipeline.stats)

    cfg = program.cfg
    tokens = program.batch * program.seq
    pairs = ops.live_pairs(program.batch, cfg.n_heads, program.seq, True)
    flops = ops.train_step_flops(ref.active_params(conf), tokens,
                                 cfg.resolved_head_dim, pairs, cfg.n_layers)
    record = {"steps": len(walls), "window_s": window_s,
              "step_flops": flops, "peak_flops": peaks.BF16_FLOPS_PER_S,
              "pipeline_s": sum(pipe),
              "pipeline_steps": stats1.steps - stats0.steps,
              "pipeline_cache_hit_steps":
                  stats1.cache_hit_steps - stats0.cache_hit_steps}
    if opts.trace:
        record["trace"] = _traced_tail(program, p["trace_steps"])
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
    want = ref.train(conf, p["optimizer"], opts.seed,
                     [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
                      for b in batches[:p["check_steps"]]], dev)
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


def _traced_tail(program: Program, n: int) -> dict:
    """``n`` more steps under the profiler: the device's busy time, the
    kernels' device seconds, the idle gaps by the host span they fall
    in, and the attention kernels' calls and shapes."""
    from repro_torch.kernels.flash_attention.flash_attention import LAUNCHES
    cfg = program.cfg
    before = dict(LAUNCHES)
    with common.Profiled(program.dev) as prof:
        for _ in range(n):
            program.step(spans=prof.span)
    shape = {"batch": program.batch, "seq": program.seq,
             "heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
             "head_dim": cfg.resolved_head_dim, "causal": True,
             "elem_bytes": 2, "lse": True}
    work = {k: dict(shape, calls=LAUNCHES[k] - before.get(k, 0))
            for k in ("flash_attention_fwd", "flash_attention_bwd")}
    return dict(prof.result(), work=work)
