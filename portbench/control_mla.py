"""Readings that set a latent-attention training cell's limits
(``"driver": "train_mla"``): ``control.py``'s sound runs, float8
control and planted faults with the balancing biases' reading
(``bias_gap``) beside the others.

  python3 portbench/control_mla.py --workload <cell> --seeds <n,n,...> \\
      [--control-seeds <n,...>] [--fault <name> --fault-seeds <n,...>]

For every seed of ``--seeds`` the program's first ``check_steps`` steps
against the float32 reference; for ``--control-seeds`` the reference
computed with float8 products against the float32 one; for
``--fault-seeds`` the program with ``control.py``'s ``--fault`` planted
(``half_batch``: every other position of each row left out of the loss).
One JSON line a seed; no measured window is run. The device is the first CUDA device
(``--device`` picks another)."""
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
from portbench.control import FAULTS  # noqa: E402
from portbench.drivers import train_mla  # noqa: E402
from portbench.traffic import corpus  # noqa: E402


def readings(cell: dict, conf: dict, seed: int, dev, fault=None,
             control: bool = False) -> dict:
    """One seed's readings: the program's (with ``fault`` planted when
    given), and the control's when asked."""
    p = cell["params"]
    ref = importlib.import_module(f"portbench.reference.{conf['reference']}")
    program, _ = train_mla.build(cell, conf, seed, dev, ref)
    if fault:
        FAULTS[fault](program)
    t0 = time.perf_counter()
    got = train_mla.check_steps(program, conf, cell, seed, ref)
    program_s = time.perf_counter() - t0
    program.close()
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                corpus.expected_batch(program.docs, i, p["batch"],
                                      p["seq"]).items()}
               for i in range(p["check_steps"])]
    common.reference_mode(dev)
    t0 = time.perf_counter()
    want = ref.train(conf, p["optimizer"], seed, batches, dev)
    out = {"seed": seed, "fault": fault, "program_s": program_s,
           "reference_s": time.perf_counter() - t0,
           "program": train_mla.readings(got, want),
           "losses": got["losses"], "ref_losses": want["losses"]}
    if control:
        gc.collect()
        t0 = time.perf_counter()
        low = ref.train(conf, p["optimizer"], seed, batches, dev,
                        precision="fp8")
        out["control_s"] = time.perf_counter() - t0
        out["control"] = train_mla.readings(low, want)
    if dev.type == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


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
    for s in seeds + [c for c in controls if c not in seeds]:
        print(json.dumps(readings(cell, conf, s, dev, control=s in controls)),
              flush=True)
    for s in faulty:
        print(json.dumps(readings(cell, conf, s, dev, fault=args.fault)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
