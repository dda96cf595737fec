"""Alternating A/B of the port's host-bound paths on one card: this
checkout against another (an earlier commit unpacked with ``git
archive``), a fresh process each time, in the order other, this, this,
other, ... so that a drift of the card or the host falls on both sides.

Each process measures, with ``repro_torch`` of its own checkout:

- ``first_decode_s``: the first ``decode_step`` of llama3.2-3b (full
  width and depth, random bf16 weights from seed 0; 4 lanes, max_len
  512) in the process, the kernels already built: what a new serving
  process pays on its first request beyond the library loads;
- ``llama_decode_ms``, ``moe_decode_ms``: the median of 30 greedy
  ``serve_step`` calls (after 5 warm-up calls) of llama3.2-3b and of
  deepseek-moe-16b at full width and depth (4 lanes; max_len 512 and
  256), host clock around each call, which ends in a synchronize. They
  run before ``torch.distributed.tensor`` is imported, as in a serving
  process (each row records that in ``serving_imported_dtensor``);
- ``launcher_step_s``: the median wall of steps 2-4 of
  ``repro_torch.launch.train.main`` (llama3.2-3b ``--scale full``, B 2 x
  S 4096, 4 steps, the raw-array token pipeline), each step timed
  around the launcher's own train step with a synchronize; and
  ``launcher_s``, the wall of the whole ``main`` call.

A metric is "worse" (or "better") when the change's value exceeds (or
falls below) the other's in at least nine tenths of the pairs and the
medians differ by more than the spread of the other side's runs (the
distance between its quartiles); "unchanged" when the median ratio lies
within 2 % and so does that spread; else "unresolved".

  python3 chip_ab.py --other build/checkout/parent --pairs 10

It needs a card. Standard output gets one JSON line for each process
(its numbers, side, pair and card), then the card's name and power
limit and the summary.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
METRICS = ("first_decode_s", "llama_decode_ms", "moe_decode_ms",
           "launcher_step_s", "launcher_s")


def measure() -> dict:
    """The metrics of the module docstring, in this process."""
    import torch
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.models.model import init_decode_state, init_params
    from repro_torch.serve.serve_step import make_serve_step

    for lib in (fa.LIBRARY, fa.LIBRARY_BWD, pa.LIBRARY):
        lib.load()
    dev = torch.device("cuda")
    out = {}

    def decode(arch, max_len, first_key=None):
        cfg = get(arch)
        params = init_params(cfg, seed=0, device=dev)
        state = init_decode_state(cfg, 4, max_len, device=dev)
        step = make_serve_step(cfg)
        g = torch.Generator(device=dev).manual_seed(0)
        pos = torch.tensor([max_len // 5 * (i + 1) for i in range(4)],
                           dtype=torch.int32, device=dev)
        walls = []
        for i in range(35):
            tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=g,
                                device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, tok, state, pos)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        if first_key:
            out[first_key] = walls[0]
        del params, state
        torch.cuda.empty_cache()
        return statistics.median(walls[5:]) * 1e3

    out["llama_decode_ms"] = decode("llama3.2-3b", 512, "first_decode_s")
    out["moe_decode_ms"] = decode("deepseek-moe-16b", 256)
    out["serving_imported_dtensor"] = "torch.distributed.tensor" in \
        sys.modules

    # Imported only now: the launcher imports ``torch.distributed.tensor``,
    # which a serving process never loads and which slows the eager
    # dispatch of plain tensors.
    from repro_torch.launch import train as launch_train
    steps = []
    make = launch_train.make_train_step

    def timed_make(*a, **k):
        fn = make(*a, **k)

        def step(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*args)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            return res
        return step

    launch_train.make_train_step = timed_make
    t0 = time.perf_counter()
    launch_train.main(["--arch", "llama3.2-3b", "--scale", "full",
                       "--batch", "2", "--seq", "4096", "--steps", "4",
                       "--log-every", "4"])
    out["launcher_s"] = time.perf_counter() - t0
    out["launcher_step_s"] = statistics.median(steps[1:])
    return out


def run_one(checkout: Path, label: str) -> dict:
    """One fresh process of ``measure`` on ``checkout``'s package."""
    env = dict(os.environ, PYTHONPATH=str(checkout / "src"))
    t0 = time.time()
    proc = subprocess.run([sys.executable, str(HERE / "chip_ab.py"),
                           "--measure"], env=env, capture_output=True,
                          text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{label} failed:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-3000:]}")
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("AB "))
    return dict(json.loads(line[3:]), side=label,
                process_s=time.time() - t0)


def verdict(change, other) -> dict:
    """The rule of the module docstring over paired values."""
    n = len(change)
    up = sum(c > o for c, o in zip(change, other))
    down = sum(c < o for c, o in zip(change, other))
    med = statistics.median(c / o for c, o in zip(change, other))
    q1, _, q3 = statistics.quantiles(other, n=4)
    spread = q3 - q1
    gap = statistics.median(change) - statistics.median(other)
    if up >= 0.9 * n and gap > spread:
        word = "worse"
    elif down >= 0.9 * n and -gap > spread:
        word = "better"
    elif abs(med - 1) <= 0.02 and spread <= 0.02 * statistics.median(other):
        word = "unchanged"
    else:
        word = "unresolved"
    return {"verdict": word, "median_ratio": med, "pairs_change_higher":
            up, "change_median": statistics.median(change),
            "other_median": statistics.median(other), "other_spread":
            spread}


def main(argv=None) -> int:
    """Run the pairs and print the summary."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="root of the checkout to compare with")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--measure", action="store_true",
                    help="measure this process's repro_torch and print it")
    args = ap.parse_args(argv)
    if args.measure:
        print("AB " + json.dumps(measure()), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_ab.py needs a CUDA card", file=sys.stderr)
        return 1
    other = Path(args.other).resolve()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    rows = {"change": [], "other": []}
    for i in range(args.pairs):
        order = ("other", "change") if i % 2 == 0 else ("change", "other")
        for side in order:
            row = run_one(HERE if side == "change" else other, side)
            row.update(pair=i, card=card)
            print(json.dumps(row), flush=True)
            rows[side].append(row)
    summary = {m: verdict([r[m] for r in rows["change"]],
                          [r[m] for r in rows["other"]]) for m in METRICS}
    print(card)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
