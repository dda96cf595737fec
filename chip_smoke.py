"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the kernels' ``sm_90a`` build) and the
CUDA toolkit; exits non-zero without them. Phases, each fatal on failure:

  1. device  — the card's name and power limit (``nvidia-smi``);
  2. build   — compile ``simjoin.cu`` with nvcc (seconds, ptxas report);
  3. kernels — both CUDA kernels against their plain PyTorch versions on
               the card, exact per-block-pair equality over a sweep of
               d, eps, cross/self joins, ragged sizes, large coordinates,
               batched stacks and pair lists with pad rows; kernel times
               at k=8, Na=Nb=8192, d=3;
  4. geo     — the clustered GEO workload on ``backend="torch_device"``
               under every prune mode, held to its exact match and
               block-pair counts;
  5. ptf     — the main path: the PTF deployment (32 hdf5 files, 8
               nodes on one card, ptf2 queries at eps=300) with
               prune="auto" through ``RawArrayCluster.run_workload``,
               launch counts set to 0 before and read after that run,
               then the same workload with ``impl="plain"`` on the
               card, equal per query and in every non-timing summary
               key; the largest dense and pair-list batches of the run
               are replayed through kernel and plain version, compared
               and timed. It runs at 50,000 cells per file (2.6 M
               cells): at the deployment's 100,000 the host-side
               bitmap refinement of prune="auto" alone outlasts the
               run's time limit;
  6. ptf-full — the deployment at full size (5.2 M cells) with
               prune="block" (no bitmap stage, pair-list kernel only),
               kernel run against plain run the same way.

Prints the kernels' JSON record and the card's name and power limit on
the two lines before the last, and ``{"ok": true, "device": ...}`` last.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.arrayio.catalog import FileReader, build_catalog  # noqa: E402
from repro_torch.arrayio.generator import (make_geo_files,  # noqa: E402
                                           make_ptf_files)
from repro_torch.core.cluster import (RawArrayCluster,  # noqa: E402
                                      workload_summary)
from repro_torch.core.workload import geo_workload, ptf2_workload  # noqa: E402
from repro_torch.kernels.simjoin import ops, prune, simjoin  # noqa: E402
from repro_torch.kernels.simjoin.ref import count_pairs_ref  # noqa: E402

N_NODES = 8
KERNEL_SRC = "src/repro_torch/kernels/simjoin/simjoin.cu"
REPLACES = {
    "simjoin_block_counts": "src/repro/kernels/simjoin/simjoin.py:73",
    "simjoin_pruned_block_counts": "src/repro/kernels/simjoin/simjoin.py:108",
}
# The bound's rates, H100 SXM data sheet at 700 W: the 67 TFLOP/s
# float32 CUDA-core peak (128 lanes per SM, an FMA
# counted as 2 operations) bounds any 32-bit operation rate of the CUDA
# cores from above, int32 included (64 INT32 lanes per SM, plus IMAD on
# the float32 lanes), so ops / 67e12 is a least time. 3.35 TB/s HBM3.
OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def cell_pair_ops(d: int) -> int:
    """int32 operations one cell pair needs: per dimension a subtraction,
    an absolute value and an addition (into the distance, the last one
    into the count), plus the ``<= eps`` comparison."""
    return 3 * d + 1

# The GEO constants (BENCH_kernels.json, geo_workload_pruning): identical
# in every prune mode and on every backend of the reference.
GEO_MATCHES = 100126
GEO_TOTAL = 3548
GEO_EVALUATED = {"dense": 3548, "block": 1122, "bitmap": 1084, "auto": 1084}
GEO_KILLED = 38


def log(msg: str) -> None:
    """One progress line, flushed."""
    print(msg, flush=True)


def card_label() -> str:
    """``name, power.limit`` as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean milliseconds of ``fn()`` on the card (CUDA events, warmed)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------- kernels


def stack(sides, sentinel, dev):
    """Pad (n, d) host coordinate sets to one (k, d, N) int32 stack."""
    n = max(s.shape[0] for s in sides)
    n = -(-max(n, 1) // simjoin.BLOCK) * simjoin.BLOCK
    out = []
    for s in sides:
        cm = ops.pad_cm_np(s, sentinel)
        if cm.shape[1] < n:
            cm = np.pad(cm, ((0, 0), (0, n - cm.shape[1])),
                        constant_values=sentinel)
        out.append(cm)
    return torch.from_numpy(np.stack(out)).to(dev)


def check_dense(a_sides, b_sides, eps, same, dev):
    """Kernel vs plain per-block-pair grids on the card; returns the max
    absolute difference (must be 0)."""
    a = stack(a_sides, simjoin.SENTINEL, dev)
    b = stack(b_sides, -simjoin.SENTINEL, dev)
    got = simjoin.simjoin_block_counts(a, b, eps, same)
    want = simjoin.simjoin_block_counts_plain(a, b, eps, same)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"dense kernel != plain: eps={eps} same={same} "
                             f"shape={tuple(a.shape)}x{tuple(b.shape)}")
    return err


def pair_stack(a_sorted, b_sorted, eps, same, dev):
    """Host-built pair lists padded to one power-of-two length."""
    lists = [prune.build_block_pairs(x, y, simjoin.BLOCK, eps, same)[0]
             for x, y in zip(a_sorted, b_sorted)]
    plen = prune.padded_pair_len(max(p.shape[0] for p in lists))
    return torch.from_numpy(np.stack([prune.pad_pairs(p, plen)
                                      for p in lists])).to(dev)


def check_pruned(a_sides, b_sides, eps, same, dev):
    """Pair-list kernel vs plain on sorted sides; returns the max
    absolute difference (must be 0) and the number of pad rows seen."""
    a_s = [prune.spatial_sort(x) for x in a_sides]
    b_s = a_s if same else [prune.spatial_sort(x) for x in b_sides]
    pairs = pair_stack(a_s, b_s, eps, same, dev)
    if pairs.shape[1] == 0 or not bool((pairs[..., 2] != 0).any()):
        return 0, 0
    a = stack(a_s, simjoin.SENTINEL, dev)
    b = stack(b_s, -simjoin.SENTINEL, dev)
    got = simjoin.simjoin_pruned_block_counts(a, b, pairs, eps, same)
    want = simjoin.simjoin_pruned_block_counts_plain(a, b, pairs, eps, same)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if err or not torch.equal(got, want):
        raise AssertionError(f"pruned kernel != plain: eps={eps} "
                             f"same={same} pairs={tuple(pairs.shape)}")
    return err, int((pairs[..., 2] == 0).sum())


def clustered(rng, n, d, domain=153_064, spread=300):
    """Clustered integer coordinates in [0, domain]."""
    centers = rng.integers(spread, domain - spread, (6, d))
    pick = rng.integers(0, 6, n)
    return (centers[pick] + rng.integers(-spread, spread + 1, (n, d)))


def phase_kernels(dev):
    """Exact kernel-vs-plain sweep plus kernel rates at one large shape."""
    rng = np.random.default_rng(0)
    max_err = {"simjoin_block_counts": 0, "simjoin_pruned_block_counts": 0}
    pad_rows = 0
    cases = 0
    sizes = [(1, 1), (7, 13), (128, 128), (130, 255), (300, 41), (1024, 77),
             (1000, 1000)]
    for d in (2, 3):
        for n, m in sizes:
            for maker in ("small", "wide", "clustered"):
                def gen(k):
                    if maker == "small":
                        return rng.integers(0, 60, (k, d))
                    if maker == "wide":
                        return rng.integers(0, 153_065, (k, d))
                    return clustered(rng, k, d)
                a, b = gen(n), gen(m)
                for eps in (0, 1, 300):
                    for same in (False, True):
                        bb = a if same else b
                        e = check_dense([a], [bb], eps, same, dev)
                        max_err["simjoin_block_counts"] = max(
                            max_err["simjoin_block_counts"], e)
                        e, pr = check_pruned([a], [bb], eps, same, dev)
                        max_err["simjoin_pruned_block_counts"] = max(
                            max_err["simjoin_pruned_block_counts"], e)
                        pad_rows += pr
                        cases += 1
    # eps = 0 over duplicated cells, and batched k > 1 stacks.
    dup = np.repeat(np.array([[10, 10, 10], [10, 10, 10], [99, 1, 5]]),
                    100, axis=0)
    check_dense([dup], [dup], 0, True, dev)
    check_pruned([dup], [dup], 0, True, dev)
    for same in (False, True):
        a_sides = [clustered(rng, int(rng.integers(1, 900)), 3)
                   for _ in range(5)]
        b_sides = a_sides if same else [clustered(rng, int(rng.integers(
            1, 900)), 3) for _ in range(5)]
        check_dense(a_sides, b_sides, 300, same, dev)
        _, pr = check_pruned(a_sides, b_sides, 300, same, dev)
        pad_rows += pr
    if pad_rows == 0:
        raise AssertionError("the sweep never produced a valid == 0 row")
    # The oracle on a small input, end to end through ops.
    a = rng.integers(0, 400, (300, 3))
    b = rng.integers(0, 400, (200, 3))
    for same in (False, True):
        bb = a if same else b
        got = int(ops.count_similar_pairs(a, bb, 20, same, device=dev))
        want = int(count_pairs_ref(torch.from_numpy(a).to(dev),
                                   torch.from_numpy(bb).to(dev), 20, same))
        if got != want:
            raise AssertionError(f"ops vs oracle: {got} != {want}")
    log(f"kernels: {cases} sweep cases + duplicates + batched stacks, "
        f"{pad_rows} pad rows, kernel == plain bit for bit, "
        f"max_abs_err {max_err}")
    # Rates at one large shape: k=8 tasks of 8192 x 8192 cells, d=3.
    k, n, d = 8, 8192, 3
    a = torch.from_numpy(np.stack([ops.pad_cm_np(clustered(rng, n, d),
                                                 simjoin.SENTINEL)
                                   for _ in range(k)])).to(dev)
    b = torch.from_numpy(np.stack([ops.pad_cm_np(clustered(rng, n, d),
                                                 -simjoin.SENTINEL)
                                   for _ in range(k)])).to(dev)
    nb = n // simjoin.BLOCK
    bi, bj = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
    full = np.stack([bi.ravel(), bj.ravel(), np.ones(nb * nb, int)],
                    axis=1).astype(np.int32)
    pairs = torch.from_numpy(np.stack([full] * k)).to(dev)
    pairs_n = k * n * n
    dense_ms = cuda_ms(lambda: simjoin.simjoin_block_counts(a, b, 300,
                                                            False))
    pruned_ms = cuda_ms(lambda: simjoin.simjoin_pruned_block_counts(
        a, b, pairs, 300, False))
    log(f"kernels: k={k} Na=Nb={n} d={d} ({pairs_n} cell pairs): "
        f"dense {dense_ms:.4f} ms = {pairs_n / dense_ms * 1e3:.4e} "
        f"cell pairs/s; pair-list (all {nb * nb} block pairs) "
        f"{pruned_ms:.4f} ms = {pairs_n / pruned_ms * 1e3:.4e} cell "
        f"pairs/s [{card_label()}]")
    return max_err


# ------------------------------------------------------------ workloads


def make_cluster(catalog, data, budget_frac, **kw):
    """The port's cluster over ``catalog`` with a per-node budget of
    dataset bytes / ``budget_frac`` / N_NODES."""
    total = sum(f.n_cells * f.cell_bytes for f in catalog.files)
    return RawArrayCluster(catalog, FileReader(catalog, data), N_NODES,
                           total // budget_frac // N_NODES, policy="cost",
                           min_cells=8192, backend="torch_device",
                           device="cuda", **kw)


def phase_geo(root):
    """The GEO workload of the reference's kernel bench under every prune
    mode, held to its constants."""
    files = make_geo_files(n_files=4, n_seeds=300, clones_per_seed=40,
                           seed=11)
    catalog, data = build_catalog(files, str(root / "geo"), "csv",
                                  n_nodes=N_NODES)
    queries = geo_workload(catalog.domain, eps=500, range_frac=0.5)
    for mode in ("dense", "block", "bitmap", "auto"):
        t0 = time.perf_counter()
        cluster = make_cluster(catalog, data, 8, prune=mode)
        executed = cluster.run_workload(queries)
        s = workload_summary(executed)
        matches = sum(e.matches or 0 for e in executed)
        killed = s.get("block_pairs_bitmap_killed")
        log(f"geo[{mode}]: matches {matches}, block pairs "
            f"{s['block_pairs_evaluated']:.0f}/{s['block_pairs_total']:.0f}"
            f", bitmap killed {killed}, "
            f"{time.perf_counter() - t0:.2f} s wall")
        if matches != GEO_MATCHES:
            raise AssertionError(f"geo[{mode}] matches {matches}")
        if s["block_pairs_total"] != GEO_TOTAL:
            raise AssertionError(f"geo[{mode}] total {s}")
        if s["block_pairs_evaluated"] != GEO_EVALUATED[mode]:
            raise AssertionError(f"geo[{mode}] evaluated {s}")
        if mode in ("bitmap", "auto") and killed != GEO_KILLED:
            raise AssertionError(f"geo[{mode}] killed {killed}")


class BatchRecorder:
    """Wraps an executor's ``dispatch`` to keep the largest dense and
    pair-list batch (by cell pairs) of a run for replay, and brackets
    each dispatch with CUDA events so the run's device-busy time (kernel
    plus per-task reduction) can be summed afterwards."""

    def __init__(self, executor):
        self.largest = {}
        self.events = []
        self._dispatch = executor.dispatch
        executor.dispatch = self

    def busy_s(self) -> float:
        """Seconds the card spent inside dispatched work (synchronizes)."""
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.events) / 1e3

    def __call__(self, batch, eps, arrays=None):
        """Dispatch, then remember the batch if it is the largest yet."""
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self._dispatch(batch, eps, arrays=arrays)
        end.record()
        self.events.append((start, end))
        kind = batch.fn_key[0]
        if kind == "dense":
            k, _, na = arrays[0].shape
            work = k * na * arrays[1].shape[2]
        else:
            work = int((arrays[2][..., 2] != 0).sum()) * simjoin.BLOCK ** 2
        if work > self.largest.get(kind, (0,))[0]:
            self.largest[kind] = (work, arrays, int(eps), batch.same)
        return out


def non_timing(summary):
    """Summary keys that are not measured timings (``*_s``,
    ``measured_*``)."""
    return {k: v for k, v in summary.items()
            if not k.endswith("_s") and not k.startswith("measured_")}


def phase_ptf(root, tag, cells, prune_mode, plain_budget_s, main_path):
    """One PTF run through the kernels (launch counts set to 0 just
    before and read just after), then the same workload through the
    plain versions on the card, query by query while ``plain_budget_s``
    lasts; per-query matches and non-timing summary keys must agree.
    On the ``main_path`` run every kernel must have launched."""
    t0 = time.perf_counter()
    files = make_ptf_files(n_files=32, cells_per_file_mean=cells,
                           skew=1.1, seed=21)
    catalog, data = build_catalog(files, str(root / tag), "hdf5",
                                  n_nodes=N_NODES)
    queries = ptf2_workload(catalog.domain, n_queries=10, eps=300)
    n_cells = sum(f.n_cells for f in catalog.files)
    n_bytes = sum(f.n_cells * f.cell_bytes for f in catalog.files)
    t_data = time.perf_counter() - t0
    log(f"{tag}: {len(files)} files, {n_cells} cells, {n_bytes} bytes, "
        f"generate + write {t_data:.2f} s")

    cluster = make_cluster(catalog, data, 4, prune=prune_mode)
    recorder = BatchRecorder(cluster.executor)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for name in simjoin.LAUNCHES:
        simjoin.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    executed = cluster.run_workload(queries)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(simjoin.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    busy = recorder.busy_s()
    summary = workload_summary(executed)
    if main_path and any(v == 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never launched: "
                             f"{launches}")
    evaluated_pairs = summary["block_pairs_evaluated"] * simjoin.BLOCK ** 2
    busiest_pairs = summary["compute_time_s"] * cluster.cost.cell_pairs_per_sec
    label = card_label()
    log(f"{tag}[kernel]: device busy {busy:.6f} s of {t_run:.3f} s "
        f"run_workload wall = idle share {1 - busy / t_run:.6f}, "
        f"{len(recorder.events)} dispatches [{card_label()}]")
    log(f"{tag}[kernel]: run_workload {t_run:.3f} s wall, launches "
        f"{launches}, per-query matches "
        f"{[e.matches for e in executed]} [{label}]")
    log(f"{tag}[kernel]: planner (opt_time_s) {summary['opt_time_s']:.3f} s, "
        f"prep_s {summary['prep_s']:.3f}, dispatch_s "
        f"{summary['dispatch_s']:.3f}, measured_compute_s "
        f"{summary['measured_compute_s']:.3f}, measured_net_s "
        f"{summary['measured_net_s']:.3f}, bitmap_build_s "
        f"{summary.get('bitmap_build_s', 0.0):.3f} [{label}]")
    log(f"{tag}[kernel]: block pairs {summary['block_pairs_evaluated']:.0f}/"
        f"{summary['block_pairs_total']:.0f} = {evaluated_pairs:.0f} cell "
        f"pairs on the card; busiest-node dense work {busiest_pairs:.0f} "
        f"cell pairs; max_memory_allocated {peak} bytes [{label}]")
    log(f"{tag}[kernel]: device_stats {cluster.backend.device_stats}")
    log(f"{tag}[kernel]: summary {json.dumps(summary)}")

    # The same workload with the plain versions on the card, query by
    # query while the time budget lasts.
    plain = make_cluster(catalog, data, 4, prune=prune_mode, impl="plain")
    t0 = time.perf_counter()
    plain_exec = []
    for q in queries:
        plain_exec.append(plain.run_query(q))
        if time.perf_counter() - t0 > plain_budget_s:
            break
    torch.cuda.synchronize()
    n = len(plain_exec)
    got = [e.matches for e in executed[:n]]
    want = [e.matches for e in plain_exec]
    s_kernel = non_timing(workload_summary(executed[:n]))
    s_plain = non_timing(workload_summary(plain_exec))
    log(f"{tag}[plain]: first {n} of {len(queries)} queries in "
        f"{time.perf_counter() - t0:.3f} s wall, matches {want} "
        f"[{label}]")
    if got != want:
        raise AssertionError(f"{tag} per-query matches differ: {got} vs "
                             f"{want}")
    if s_kernel != s_plain:
        raise AssertionError(f"{tag} summaries differ: {s_kernel} vs "
                             f"{s_plain}")
    log(f"{tag}: kernel run == plain run on {n} queries (matches and "
        f"{len(s_kernel)} non-timing summary keys)")
    return launches, recorder.largest, evaluated_pairs


def replay(largest):
    """The main path's largest batch per kernel through kernel and plain
    version: exact comparison, times, and the bound."""
    rows = []
    for kind, name in (("dense", "simjoin_block_counts"),
                       ("block", "simjoin_pruned_block_counts")):
        work, arrays, eps, same = largest[kind]
        if kind == "dense":
            def kern():
                return simjoin.simjoin_block_counts(*arrays, eps, same)

            def plain():
                return simjoin.simjoin_block_counts_plain(*arrays, eps,
                                                          same)
        else:
            def kern():
                return simjoin.simjoin_pruned_block_counts(*arrays, eps,
                                                           same)

            def plain():
                return simjoin.simjoin_pruned_block_counts_plain(
                    *arrays, eps, same)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err or not torch.equal(got, want):
            raise AssertionError(f"{name} != plain at the main-path shape")
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain, reps=3)
        d = arrays[0].shape[1]
        ops_count = work * cell_pair_ops(d)
        bytes_moved = sum(x.nbytes for x in arrays) + got.nbytes
        ops_ms = ops_count / OPS_PER_S * 1e3
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        shapes = [tuple(x.shape) for x in arrays]
        log(f"replay[{name}]: shapes {shapes}, eps {eps}, same {same}, "
            f"{work} cell pairs, kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {max(ops_ms, bytes_ms):.6f} ms [{card_label()}]")
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "max_abs_err": err,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": ("operations" if ops_ms >= bytes_ms
                                  else "bytes")})
    return rows


def main(argv=None) -> int:
    """Run every phase; any failure raises and exits non-zero."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptf-cells", type=int, default=50_000,
                    help="mean cells per PTF file of the main path "
                         "(prune='auto')")
    ap.add_argument("--ptf-full-cells", type=int, default=100_000,
                    help="mean cells per PTF file of the full-size run "
                         "(prune='block')")
    ap.add_argument("--plain-budget-s", type=float, default=240.0,
                    help="wall-clock budget of the plain-version replay")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    label = card_label()
    log(f"device: {label}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    simjoin.build()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(built={simjoin.BUILD_INFO['built']}) -> "
        f"{simjoin.BUILD_INFO['path']}")
    for line in str(simjoin.BUILD_INFO["ptxas"]).splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"build: {line.strip()}")

    sweep_err = phase_kernels(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        phase_geo(root)
        launches, largest, _ = phase_ptf(
            root, "ptf", args.ptf_cells, "auto", args.plain_budget_s,
            main_path=True)
        phase_ptf(root, "ptf-full", args.ptf_full_cells, "block",
                  args.plain_budget_s, main_path=False)
    rows = replay(largest)
    record = []
    for row in rows:
        name = row["name"]
        record.append({
            "name": name, "route": "cuda", "source": KERNEL_SRC,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(row["max_abs_err"], sweep_err[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None})
    log(f"total: {time.perf_counter() - t_start:.2f} s")
    print(json.dumps({"kernels": record}))
    print(card_label())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
