"""The port's executor and device backend against the JAX package's, on
the same inputs: ``TorchJoinExecutor`` (plain versions on the CPU) vs
``PallasJoinExecutor`` (interpret mode) in per-task counts, prepared
batches and every non-timing ``last_stats`` key; ``TorchDeviceBackend``
on the CPU vs ``JaxMeshBackend`` on one jax device in ``device_stats``,
committed buffers and measured bytes; and the invariant auditor."""
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

# The reference resolves its core <-> faults import cycle only when
# repro.core is imported first.
import repro.core  # noqa: E402,F401
from repro.backend.executors import PallasJoinExecutor  # noqa: E402
from repro.core.cluster import RawArrayCluster as JaxCluster  # noqa: E402
from repro_torch.backend import (TorchDeviceBackend,  # noqa: E402
                                 TorchJoinExecutor, make_backend,
                                 make_join_executor)
from repro_torch.backend.executors import (  # noqa: E402
    NumpyJoinExecutor, count_similar_pairs_np)
from repro_torch.core.cluster import RawArrayCluster  # noqa: E402
from repro_torch.core.geometry import Box  # noqa: E402

MODES = ("dense", "block", "bitmap", "auto")


def clustered_coords(rng, n, d=3, n_clusters=6, domain=50_000, spread=30):
    centers = rng.integers(0, domain, (n_clusters, d))
    pick = rng.integers(0, n_clusters, n)
    return (centers[pick] + rng.integers(-spread, spread + 1,
                                         (n, d))).astype(np.int32)


def uniform_coords(rng, n, d=3, hi=400):
    return rng.integers(0, hi, size=(n, d)).astype(np.int32)


def make_tasks(rng, maker, k=3):
    """The task mix of the reference's executor tests: cross and self
    joins of ragged sizes on three nodes, plus one empty side."""
    tasks = []
    for i in range(k):
        a = maker(rng, int(rng.integers(1, 520)))
        b = maker(rng, int(rng.integers(1, 520)))
        tasks.append((i % 3, a, b, False))
        tasks.append((i % 3, a, a, True))
    tasks.append((0, np.zeros((0, 3), np.int32), a, False))
    return tasks


def duplicate_tasks(rng):
    base = clustered_coords(rng, 400)
    dup = np.repeat(base[:30], 10, axis=0)
    return [(0, base, base, True), (1, dup, dup, True), (0, base, dup, False)]


FIXTURES = {
    "clustered": (lambda rng: make_tasks(rng, clustered_coords), 40),
    "uniform": (lambda rng: make_tasks(rng, uniform_coords), 40),
    "eps0_duplicates": (duplicate_tasks, 0),
    "duplicates_eps1": (duplicate_tasks, 1),
}


def non_timing(stats):
    return {k: v for k, v in stats.items() if not k.endswith("_s")}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fixture", sorted(FIXTURES))
def test_executor_matches_pallas(fixture, mode):
    """Per-task counts, the prepared batches (bucket keys, task order,
    stacked host arrays) and every non-timing ``last_stats`` key."""
    make, eps = FIXTURES[fixture]
    tasks = make(np.random.default_rng(11))
    port = TorchJoinExecutor(device="cpu", prune=mode)
    ref = PallasJoinExecutor(prune=mode)
    got = port.count_pairs(tasks, eps)
    want = ref.count_pairs(tasks, eps)
    assert got == want
    assert got == NumpyJoinExecutor(count_similar_pairs_np).count_pairs(
        tasks, eps)
    assert sum(got) > 0
    assert set(port.last_stats) == set(ref.last_stats)
    assert non_timing(port.last_stats) == non_timing(ref.last_stats)
    pb, ps = port.iter_batches(tasks, eps, by_node=True)
    rb, rs = ref.iter_batches(tasks, eps, by_node=True)
    assert non_timing(ps) == non_timing(rs)
    assert [(b.node, b.same, b.idxs, b.fn_key) for b in pb] == \
        [(b.node, b.same, b.idxs, b.fn_key) for b in rb]
    for x, y in zip(pb, rb):
        for u, v in zip(x.arrays, y.arrays):
            np.testing.assert_array_equal(u, v)


def test_executor_artifact_reuse_with_views():
    """Warm dispatch over ChunkViews answers from the artifact cache with
    counts equal to the cold pass and to the reference's."""
    rng = np.random.default_rng(9)
    a = clustered_coords(rng, 600)
    b = clustered_coords(rng, 300)
    q = Box((0, 0, 0), tuple([60_000] * 3))
    chunk = Box((0, 0, 0), (50_100, 50_100, 50_100))
    for mode in MODES:
        ex = TorchJoinExecutor(device="cpu", prune=mode)
        va = ex.artifacts.view(1, chunk, q, a)
        vb = ex.artifacts.view(2, chunk, q, b)
        tasks = [(0, va, vb, False), (1, va, va, True)]
        cold = ex.count_pairs(tasks, 35)
        assert ex.last_stats["artifact_misses"] > 0, mode
        warm = ex.count_pairs(tasks, 35)
        assert ex.last_stats["artifact_hits"] > 0, mode
        assert ex.last_stats["artifact_misses"] == 0, mode
        assert warm == cold == PallasJoinExecutor(prune=mode).count_pairs(
            [(0, a, b, False), (1, a, a, True)], 35), mode


def test_factories_validate():
    with pytest.raises(ValueError, match="prune"):
        make_join_executor("numpy", count_similar_pairs_np, prune="block")
    with pytest.raises(ValueError, match="unknown prune mode"):
        TorchJoinExecutor(device="cpu", prune="sparse")
    with pytest.raises(ValueError, match="unknown impl"):
        TorchJoinExecutor(device="cpu", impl="triton")
    with pytest.raises(ValueError, match="unknown join backend"):
        make_join_executor("pallas", count_similar_pairs_np)
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("jax_mesh", 4, device="cpu")
    with pytest.raises(ValueError, match="simjoin kernels"):
        make_backend("torch_device", 4, join_fn=lambda a, b, e, s: 0,
                     device="cpu")
    assert isinstance(make_join_executor("torch", count_similar_pairs_np,
                                         device="cpu"), TorchJoinExecutor)
    assert TorchJoinExecutor(device="cpu").prune == "auto"


# ------------------------------------------------- device backend parity

@pytest.fixture(scope="module")
def dataset():
    from repro.arrayio.catalog import build_catalog
    from repro.arrayio.generator import make_ptf_files
    files = make_ptf_files(n_files=10, cells_per_file_mean=900, seed=21)
    catalog, data = build_catalog(files, tempfile.mkdtemp(prefix="tback_"),
                                  "fits", n_nodes=4)
    return catalog, data


def fixed_workload(catalog):
    from repro.core.workload import ptf1_workload, ptf2_workload
    return (ptf1_workload(catalog.domain, n_queries=4, eps=300, seed=7)
            + ptf2_workload(catalog.domain, n_queries=4, eps=300))


SCENARIOS = {
    "seed": dict(),
    "reuse": dict(reuse="on", budget=60_000),
    "replicated_failover": dict(replication="hot", replica_k=2,
                                replication_threshold=2.0, budget=40_000,
                                fail=1),
}


def run_pair(dataset, scenario):
    """The same workload on the JAX mesh (one device) and the port's
    device backend (the CPU); returns both clusters and executions."""
    from repro.arrayio.catalog import FileReader as JaxReader
    from repro_torch.arrayio.catalog import FileReader
    catalog, data = dataset
    kw = dict(SCENARIOS[scenario])
    budget = kw.pop("budget", 6_000)
    fail = kw.pop("fail", None)
    queries = fixed_workload(catalog)
    common = dict(policy="cost", min_cells=64, prune="block", **kw)
    jc = JaxCluster(catalog, JaxReader(catalog, data), 4, budget,
                    backend="jax_mesh", join_backend="pallas",
                    devices=jax.devices()[:1], **common)
    pc = RawArrayCluster(catalog, FileReader(catalog, data), 4, budget,
                         backend="torch_device", device="cpu", **common)
    out = []
    for c in (jc, pc):
        executed = c.run_workload(queries[:5])
        if fail is not None:
            c.fail_node(fail)
        executed += c.run_workload(queries[5:])
        out.append((c, executed))
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_device_backend_matches_jax_mesh(dataset, scenario):
    (jc, jex), (pc, pex) = run_pair(dataset, scenario)
    backend = pc.backend
    assert isinstance(backend, TorchDeviceBackend)
    assert [e.matches for e in pex] == [e.matches for e in jex]
    assert sum(e.matches or 0 for e in pex) > 0
    assert backend.device_stats == jc.backend.device_stats
    assert set(backend.committed_chunks()) == pc.coordinator.cache.cached
    assert backend.committed_chunks() == jc.backend.committed_chunks()
    assert all(e.measured_ship_bytes == 0 for e in pex)
    assert all(e.backend == "torch_device" for e in pex)
    for cid in backend.committed_chunks():
        assert backend.buffer_device(cid) == torch.device("cpu")
        for node, buf in backend._buffers[cid].items():
            assert buf.dtype == torch.int32
            want = jc.backend._buffers[cid][node]
            np.testing.assert_array_equal(buf.numpy(), np.asarray(want))
    if scenario == "replicated_failover":
        assert backend.device_stats["failover_buffers_dropped"] > 0


def test_audit_runs_clean(dataset):
    """With the invariant auditor armed, the port's device buffers,
    pinned batches and artifacts track residency: zero violations."""
    from repro_torch.arrayio.catalog import FileReader
    catalog, data = dataset
    cluster = RawArrayCluster(catalog, FileReader(catalog, data), 4, 6_000,
                              policy="cost", min_cells=64, device="cpu",
                              audit="on")
    executed = cluster.run_workload(fixed_workload(catalog))
    auditor = cluster.coordinator.auditor
    assert auditor is not None and auditor.backend is cluster.backend
    assert auditor.audits_run > 0
    assert auditor.violations_total == 0, auditor.report()
    assert sum(e.audit_violations for e in executed) == 0
    assert auditor.audit() == []


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_numpy_pair_count_matches_reference(d):
    """The simulated backend's numpy join counts what the reference's
    does: cross and self joins over several blocks, eps from 0 to past
    every distance, coordinates of either sign up to 2^30."""
    from repro.backend.executors import count_similar_pairs_np as jcount
    rng = np.random.default_rng(40 + d)
    for n, m, same in ((300, 170, False), (257, 257, True), (1, 90, False),
                       (0, 5, False)):
        a = rng.integers(-2 ** 30, 2 ** 30, (n, d)).astype(np.int64)
        a[: n // 2] //= 2 ** 20                 # a dense cluster too
        b = a if same else rng.integers(-2 ** 12, 2 ** 12,
                                        (m, d)).astype(np.int32)
        for eps in (0, 5, 3000, 2 ** 33):
            got = count_similar_pairs_np(a, b, eps, same, block=64)
            assert got == jcount(a, b, eps, same, block=64), (n, m, eps)
