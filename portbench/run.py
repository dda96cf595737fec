"""Run one cell of the port's benchmark once and print its result line.

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json`` at the
repository's root; its file ``portbench/workloads/<cell>.json`` names its
configuration (``portbench/configs/<config>.json``), its driver
(``portbench/drivers/<driver>.py``), its traffic's parameters and the
limits of the numbers its check compares. With ``--trace 0`` the result
carries the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, each read from the run's record by
``portbench/metrics/<metric>.py``. The last line of standard output is
one JSON object; the numbers compared, each beside its limit, end both
the result and standard error. A run needs as many CUDA devices as the
cell asks for, and exits with 1, printing no result, without them, or
when JAX or the JAX package has been loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# Build and kernel caches at fixed paths inside the checkout, so that only
# a checkout's first run builds.
for _var, _dir in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(CHECKOUT / "build" / "portbench" / _dir)
sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(entry: dict, cell: str) -> bool:
    """Whether a metric of ``BENCHMARK.json`` is reported in ``cell``."""
    return cell in entry.get("workloads", [cell])


def metric_reader(name: str, root: Path):
    """``read(record)`` of ``<root>/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def find_cell(bench: dict, name: str, root: Path):
    """(the cell's entry, its file, its configuration's file)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = load_json(root / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if cell[key] != entry[key]:
            raise SystemExit(f"{name}: {key} {cell[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    if not any(c["name"] == entry["config"] for c in bench["configs"]):
        raise SystemExit(f"{name}: no configuration {entry['config']!r}")
    conf = load_json(root / "configs" / f"{entry['config']}.json")
    return entry, cell, conf


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: Path = HERE, bench_file: Path = None,
         device=None) -> int:
    """Run the cell; returns the exit code. ``root`` holds ``configs/``,
    ``workloads/`` and ``metrics/``; ``device`` (tests only) skips the
    look for CUDA devices and runs there."""
    args = parse(argv)
    bench = load_json(bench_file or CHECKOUT / "BENCHMARK.json")
    entry, cell, conf = find_cell(bench, args.workload, root)

    import torch

    from portbench import common
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    opts = common.Options(seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, t0=T0)
    driver = importlib.import_module(f"portbench.drivers.{cell['driver']}")
    out = driver.run(cell, conf, opts)

    found = common.forbidden_modules()
    if found:
        print(f"loaded modules of forbidden packages: {found}",
              file=sys.stderr)
        return 1
    if args.trace:
        metrics = {}
        reported = {m["name"] for m in bench["end_to_end"]
                    if applies(m, args.workload)}
        for m in bench["per_layer"]:
            if not applies(m, args.workload) or m["moves"] not in reported:
                continue
            value = metric_reader(m["name"], root)(out.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out.e2e[m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, args.workload)}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else device.type,
                "count": entry["chips"],
                "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": dev_info}
    trace = out.record.get("trace")
    if args.trace and trace is not None:
        dev_info["busy_s"] = trace["busy_s"]
        dev_info["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.checks}
    print(f"timing: setup {out.e2e['setup_s']:.3f} s, window "
          f"{out.record['window_s']:.3f} s, process "
          f"{time.perf_counter() - T0:.3f} s", file=sys.stderr)
    for c in out.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
