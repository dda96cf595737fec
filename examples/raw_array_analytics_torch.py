"""Raw-array analytics through the PyTorch/CUDA port: the paper's own
workload end to end.

``examples/raw_array_analytics.py`` through ``repro_torch``: walks one
similarity-join query through the full pipeline — catalog pruning,
evolving R-tree refinement (Alg. 1), join planning, cost-based eviction
(Alg. 2), placement (Alg. 3) — printing each plan, and executes every
chunk pair's join with the port's ``count_similar_pairs_np`` as the
cluster's ``join_fn``: the hand-written CUDA simjoin kernel
(``simjoin_walk_kernel``) on ``--device``, or its plain PyTorch version
with ``--device cpu``. The closing line counts the kernel's launches.
The query is the reference example's own, and as there it finds no
cell in range at this seed, so its plans are empty and no join runs.

  PYTHONPATH=src python examples/raw_array_analytics_torch.py [--device cpu]
"""
import argparse
import functools
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.arrayio import FileReader, build_catalog, make_ptf_files  # noqa: E402
from repro_torch.core import Box, RawArrayCluster, SimilarityJoinQuery  # noqa: E402
from repro_torch.kernels.simjoin.ops import (count_similar_pairs_np,  # noqa: E402
                                             resolve_device)
from repro_torch.kernels.simjoin import simjoin  # noqa: E402

N_NODES = 3


def main(argv=None):
    """Run the query three times, printing each pass's plans; returns
    the executed passes."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the CUDA kernel) or cpu (its "
                         "plain version)")
    args = ap.parse_args(argv)
    # The device is resolved up front, so a missing card raises before
    # any work, whether or not a query reaches the join.
    kernel_join = functools.partial(count_similar_pairs_np,
                                    device=resolve_device(args.device))

    before = dict(simjoin.LAUNCHES)
    files = make_ptf_files(n_files=6, cells_per_file_mean=1200, seed=9)
    passes = []
    with tempfile.TemporaryDirectory(prefix="analytics_torch_") as root:
        catalog, data = build_catalog(files, root, "hdf5", n_nodes=N_NODES)
        reader = FileReader(catalog, data)
        cluster = RawArrayCluster(catalog, reader, N_NODES, 256_000,
                                  policy="cost", min_cells=96,
                                  backend="simulated", join_backend="numpy",
                                  join_fn=kernel_join)
        dom = catalog.domain
        qbox = Box((dom.lo[0], dom.lo[1], dom.lo[2]),
                   (dom.lo[0] + dom.side(0) // 4,
                    dom.lo[1] + dom.side(1) // 4, dom.hi[2]))
        query = SimilarityJoinQuery(qbox, eps=2)

        print("query:", qbox.lo, "..", qbox.hi,
              "eps=2 (L1 similarity self-join)")
        for i in range(3):
            ex = cluster.run_query(query)
            passes.append(ex)
            rep = ex.report
            print(f"\n--- query pass {i+1} ---")
            print(f"files considered {rep.files_considered}, pruned "
                  f"{rep.files_pruned}, scanned {len(rep.files_scanned)}")
            print(f"chunks queried {len(rep.queried_chunks)} "
                  f"({rep.queried_cells} cells in range), "
                  f"splits this query: {rep.refine_stats.splits}")
            if rep.join_plan:
                print(f"join plan: {len(rep.join_plan.pairs)} chunk pairs, "
                      f"{len(rep.join_plan.transfers)} chunk transfers")
            if rep.placement:
                print(f"placement: {len(rep.placement.locations)} chunks "
                      f"placed, co-location objective "
                      f"{rep.placement.colocated_pair_weight:.1f}")
            print(f"cache after: {rep.cached_chunks_after} chunks, "
                  f"{rep.cached_bytes_after/1e3:.0f} KB; "
                  f"matches={ex.matches}, modeled time "
                  f"{ex.time_total_s:.3f}s")
    launches = {k: v - before[k] for k, v in simjoin.LAUNCHES.items()}
    print(f"\npass 2+ scan zero raw bytes — the distributed cache serves "
          f"the query; the port's simjoin kernel (simjoin_walk_kernel, "
          f"CUDA) on {args.device} executed every chunk pair: launches "
          f"{launches}")
    return passes


if __name__ == "__main__":
    main()
