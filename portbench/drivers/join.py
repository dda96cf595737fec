"""Join cells: one client in a closed loop sending the cell's similarity
join queries to the port's caching cluster
(``repro_torch.core.cluster.RawArrayCluster`` on ``backend=
"torch_device"``): the coordinator's R-tree chunking, eviction and
placement, the device cache, host prep and the simjoin kernels.

Set-up makes the raw arrays from the seed, writes them as the cell's
file format, builds the cluster and runs the first ``warmup_queries``
queries. Every query's match count, warm-up and traced tail included,
is compared with the plain reference's count for its box."""
from __future__ import annotations

import gc
import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import common
from portbench.reference import simjoin as reference
from portbench.traffic import arrays


def make_cluster(p: dict, files, dev, tmp: str):
    """The cluster of ``p`` (the configuration's deployment with the
    cell's parameters over it) over copies of ``files``: the program
    owns what it is handed."""
    from repro_torch.arrayio.catalog import FileReader, build_catalog
    from repro_torch.arrayio.generator import GeneratedFile
    from repro_torch.core.cluster import RawArrayCluster
    from repro_torch.core.geometry import Box
    gen = [GeneratedFile(c.copy(), a.copy(),
                         Box(tuple(int(x) for x in c.min(0)),
                             tuple(int(x) for x in c.max(0))))
           for c, a in files]
    catalog, data = build_catalog(gen, tmp, p["fmt"], n_nodes=p["nodes"])
    total = sum(f.n_cells * f.cell_bytes for f in catalog.files)
    return RawArrayCluster(
        catalog, FileReader(catalog, data), p["nodes"],
        total // p["budget_frac"] // p["nodes"], policy=p["policy"],
        min_cells=p["min_cells"], backend="torch_device", device=dev.type,
        prune=p["prune"])


def run(cell: dict, conf: dict, opts: common.Options) -> common.Outcome:
    """One run of a join cell."""
    from repro_torch.core.coordinator import SimilarityJoinQuery
    from repro_torch.core.geometry import Box
    p = {**conf, **cell["params"]}
    dev = opts.device
    files = arrays.ptf_files(p, opts.seed)
    tmp = tempfile.mkdtemp(prefix="portbench_")
    cluster = make_cluster(p, files, dev, tmp)

    def query(i: int) -> SimilarityJoinQuery:
        lo, hi = arrays.query_box(p, i)
        return SimilarityJoinQuery(Box(lo, hi), eps=p["eps"])

    answers = []                     # (query index, matches)
    for i in range(p["warmup_queries"]):
        answers.append((i, cluster.run_query(query(i)).matches))
    common.synchronize(dev)
    setup_s = time.perf_counter() - opts.t0

    stats0 = dict(cluster.backend.device_stats)
    executed = []
    i = p["warmup_queries"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < opts.seconds:
        e = cluster.run_query(query(i))
        executed.append(e)
        answers.append((i, e.matches))
        i += 1
    window_s = time.perf_counter() - t0
    stats1 = dict(cluster.backend.device_stats)
    record = {
        "queries": len(executed), "window_s": window_s,
        "opt_s": sum(e.time_opt_s for e in executed),
        "prep_s": sum(e.prep_s or 0.0 for e in executed),
        "dispatch_s": sum(e.dispatch_s or 0.0 for e in executed),
        "pinned_batch_hits": stats1["pinned_batch_hits"] -
        stats0["pinned_batch_hits"],
        "pinned_batch_misses": stats1["pinned_batch_misses"] -
        stats0["pinned_batch_misses"]}
    if opts.trace:
        record["trace"] = _traced_tail(cluster, query, i,
                                       p["trace_queries"], dev, answers)
    memory_peak = common.memory_peak(dev)
    del cluster, executed
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)

    want = counts(p, files, dev, sorted({arrays.query_box(p, q)
                                         for q, _ in answers}))
    wrong = sum(1 for q, m in answers
                if m != want[arrays.query_box(p, q)])
    checks = [common.Check("wrong_counts", wrong,
                           cell["limits"]["wrong_counts"])]
    e2e = {"setup_s": setup_s,
           "join_queries_per_s": record["queries"] / window_s}
    return common.Outcome(
        e2e=e2e, record=record, checks=checks, attempted=len(answers),
        failed=sum(1 for _, m in answers if m is None),
        memory_peak_bytes=memory_peak)


def counts(p: dict, files, dev, boxes, dtype=torch.int32) -> dict:
    """The reference's match count of every box, from the cells the
    benchmark made."""
    cells = torch.from_numpy(np.concatenate([c for c, _ in files])).to(dev)
    return {b: reference.count_pairs(reference.cells_in_box(cells, b),
                                     p["eps"], dtype) for b in boxes}


def _traced_tail(cluster, query, i0: int, n: int, dev, answers) -> dict:
    """``n`` more queries under the profiler, with the planner, the
    execution and the result's record as host spans; the simjoin
    kernels' evaluated cell pairs and the bytes their batches moved."""
    from repro_torch.kernels.simjoin.simjoin import BLOCK
    coord, backend, ex = cluster.coordinator, cluster.backend, \
        cluster.executor
    moved = [0]
    plain = (coord.process_query, backend.execute, coord.record_result,
             ex.dispatch)

    def dispatch(batch, eps, arrays=None):
        out = plain[3](batch, eps, arrays=arrays)
        src = arrays if arrays is not None else batch.arrays
        moved[0] += sum(int(x.nbytes) for x in src) + int(out.nbytes)
        return out

    evaluated = 0
    with common.Profiled(dev) as prof:
        def spanned(name, fn):
            def call(*a, **k):
                with prof.span(name):
                    return fn(*a, **k)
            return call
        coord.process_query = spanned("plan", plain[0])
        backend.execute = spanned("execute", plain[1])
        coord.record_result = spanned("record_result", plain[2])
        ex.dispatch = dispatch
        try:
            for i in range(i0, i0 + n):
                e = cluster.run_query(query(i))
                answers.append((i, e.matches))
                evaluated += e.block_pairs_evaluated or 0
        finally:
            (coord.process_query, backend.execute, coord.record_result,
             ex.dispatch) = plain
    ndim = cluster.catalog.ndim
    return dict(prof.result(), work={"simjoin": {
        "cell_pairs": evaluated * BLOCK * BLOCK, "ndim": ndim,
        "bytes": moved[0]}})
