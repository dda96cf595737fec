"""Readings that set a cell's limits: the program's sound runs, the
lower-precision control, and faults planted in the timed path.

  python3 portbench/control.py --workload <cell> --seeds <n,n,...> \\
      [--control-seeds <n,...>] [--fault <name> --fault-seeds <n,...>]

Training cells: for every seed of ``--seeds`` the program's first
``check_steps`` steps against the float32 reference (the lower
readings); for ``--control-seeds`` the reference computed with float8
products against the float32 one (the control, the precision below the
configuration's bfloat16); for ``--fault-seeds`` the program with
``--fault`` planted (``half_batch``: every other position of each row left
out of the loss, its mean taken over the rest). Join cells: for
``--control-seeds`` the reference's counts with the L1 distance in
bfloat16 against the exact ones. Each reading is printed as one JSON
line, with the numbers the cell compares; no measured window is run. The
device is the first CUDA device (``--device`` picks another, e.g. the
CPU for tests)."""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

import torch  # noqa: E402

from portbench import common  # noqa: E402
from portbench.drivers import join, train  # noqa: E402
from portbench.traffic import arrays, corpus  # noqa: E402


def plant_half_batch(program) -> None:
    """Fault: every step leaves every other position of each row out of
    the loss, whose mean is taken over the rest (planted where the served
    batch goes to the device)."""
    feed = program.feed

    def half(raw):
        labels = raw["labels"].copy()
        labels[:, 1::2] = -1
        return feed(dict(raw, labels=labels))
    program.feed = half


def plant_unchanged(program) -> None:
    """Fault: every step returns the parameters and moments it was
    given."""
    step_fn = program.step_fn

    def unchanged(params, opt_state, batch):
        kept = ([t.clone() for t in _leaves(params)],
                [t.clone() for t in _leaves(opt_state)])
        out_p, out_o, metrics = step_fn(params, opt_state, batch)
        with torch.no_grad():
            for t, k in zip(_leaves(out_p) + _leaves(out_o),
                            kept[0] + kept[1]):
                t.copy_(k)
        return out_p, out_o, metrics
    program.step_fn = unchanged


def _leaves(tree):
    from repro_torch.train.tree import leaves
    return leaves(tree)


FAULTS = {"half_batch": plant_half_batch, "unchanged": plant_unchanged}


def train_readings(cell: dict, conf: dict, seed: int, dev, fault=None,
                   control: bool = False) -> dict:
    """One seed's readings of a training cell."""
    p = cell["params"]
    ref = importlib.import_module(f"portbench.reference.{conf['reference']}")
    program = train.Program(cell, conf, seed, dev, ref)
    if fault:
        FAULTS[fault](program)
    t0 = time.perf_counter()
    got = train.check_steps(program, conf, cell, seed, ref)
    program_s = time.perf_counter() - t0
    program.close()
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                corpus.expected_batch(program.docs, i, p["batch"],
                                      p["seq"]).items()}
               for i in range(p["check_steps"])]
    common.reference_mode(dev)
    t0 = time.perf_counter()
    want = ref.train(conf, p["optimizer"], seed, batches, dev)
    ref_s = time.perf_counter() - t0
    out = {"seed": seed, "fault": fault, "program_s": program_s,
           "reference_s": ref_s, "program": train.readings(got, want),
           "losses": got["losses"], "ref_losses": want["losses"],
           "ref_grad_norm": want["grad_norm"]}
    if control:
        gc.collect()
        t0 = time.perf_counter()
        low = ref.train(conf, p["optimizer"], seed, batches, dev,
                        precision="fp8")
        out["control_s"] = time.perf_counter() - t0
        out["control"] = train.readings(low, want)
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def join_control(cell: dict, conf: dict, seed: int, dev) -> dict:
    """One seed's control of a join cell: how many of the sequence's
    boxes the bfloat16 distance counts wrong."""
    p = {**conf, **cell["params"]}
    files = arrays.ptf_files(p, seed)
    boxes = sorted({arrays.query_box(p, i) for i in
                    range(len(p["sequence"]))})
    t0 = time.perf_counter()
    exact = join.counts(p, files, dev, boxes)
    exact_s = time.perf_counter() - t0
    low = join.counts(p, files, dev, boxes, dtype=torch.bfloat16)
    return {"seed": seed, "exact": [exact[b] for b in boxes],
            "bf16": [low[b] for b in boxes], "reference_s": exact_s,
            "control": {"wrong_counts": sum(exact[b] != low[b]
                                            for b in boxes)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", choices=sorted(FAULTS))
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    faulty = [int(s) for s in args.fault_seeds.split(",") if s]
    cell = json.loads((HERE / "workloads" /
                       f"{args.workload}.json").read_text())
    conf = json.loads((HERE / "configs" /
                       f"{cell['config']}.json").read_text())
    dev = torch.device(args.device)
    if cell["driver"] == "join":
        for s in controls:
            print(json.dumps(join_control(cell, conf, s, dev)), flush=True)
        return 0
    for s in seeds:
        print(json.dumps(train_readings(cell, conf, s, dev,
                                        control=s in controls)), flush=True)
    for s in controls:
        if s not in seeds:
            print(json.dumps(train_readings(cell, conf, s, dev,
                                            control=True)), flush=True)
    for s in faulty:
        print(json.dumps(train_readings(cell, conf, s, dev,
                                        fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
