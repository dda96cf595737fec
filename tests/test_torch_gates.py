"""The port's smoke gates (``tools/smoke_torch.py``) against the JAX
package's tools, on the CPU: each gate of the port on ``device="cpu"``
(the kernels' plain versions) through ``torch_device`` and
``simulated``, and the reference's cluster on the same tool recipe
(written out here from the reference tool, independently of the port's
gate) through ``jax_mesh`` on one jax device or ``simulated``, with its
``"pallas"`` join backend where the tool names it. Held equal: every
run's per-query matches, every non-timing ``workload_summary`` key and
the coordinator's stats; each port gate reports no failure. The chaos
gate has a file of its own (``test_torch_gates_chaos.py``). Negative
cases show that each gate can fail."""
import importlib.util
import json
import sys
import tempfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (resolves the reference's import cycle)
from repro.arrayio.catalog import FileReader as JReader  # noqa: E402
from repro.arrayio.catalog import build_catalog as jbuild  # noqa: E402
from repro.arrayio import generator as jgen  # noqa: E402
from repro.core.cluster import RawArrayCluster as JCluster  # noqa: E402
from repro.core.cluster import workload_summary as jsummary  # noqa: E402
from repro.core.geometry import Box as JBox  # noqa: E402
from repro.core import workload as jwork  # noqa: E402
from repro.faults import FaultInjector as JInjector  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def load_smoke():
    """``tools/smoke_torch.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "smoke_torch", REPO / "tools" / "smoke_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


smoke = load_smoke()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The gates run many small tensor ops: on one intra-op thread a
    worker does not spin against the other test workers' threads (with
    a thread per core in each of several workers, these tests ran some
    40 times slower). The previous count is restored after the
    module."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

#: Port backend -> the reference's backend options.
REFERENCE_BACKEND = {
    "torch_device": lambda: dict(backend="jax_mesh",
                                 devices=jax.devices()[:1]),
    "simulated": lambda: dict(backend="simulated"),
}


def non_timing(d):
    """The keys of a summary or stats dict that are not timings."""
    return {k: v for k, v in d.items()
            if not k.endswith("_s") and not k.startswith("measured_")}


def jrun(cluster, queries, batch_size=None):
    """(matches, summary, stats) of a reference run."""
    executed = cluster.run_workload(queries, batch_size=batch_size)
    return jrecord(cluster, executed)


def jrecord(cluster, executed):
    """(matches, summary, stats) of executed reference queries."""
    return ([e.matches for e in executed], jsummary(executed),
            dict(cluster.coordinator.stats))


def jgeo(fmt="csv", **kw):
    """The reference's GEO files and reader (4 nodes)."""
    catalog, data = jbuild(jgen.make_geo_files(**kw),
                           tempfile.mkdtemp(prefix="tgates_"), fmt,
                           n_nodes=4)
    return catalog, JReader(catalog, data)


def jbytes(catalog):
    """Dataset bytes."""
    return sum(f.n_cells * f.cell_bytes for f in catalog.files)


# The reference tools' recipes, one function each, returning their runs
# under the names the port's gates give them.


def ref_artifact_counters(bk):
    """``tools/smoke_artifact_counters.py``."""
    catalog, reader = jgeo(n_files=3, n_seeds=120, clones_per_seed=20,
                           seed=5)
    cluster = JCluster(catalog, reader, 4, jbytes(catalog) // 4,
                       policy="cost", min_cells=512, join_backend="pallas",
                       **bk)
    queries = jwork.geo_workload(catalog.domain, eps=300, range_frac=0.4)
    return {"cold": jrun(cluster, queries), "warm": jrun(cluster, queries)}


def ref_bitmap_prune(bk):
    """``tools/smoke_bitmap_prune.py``."""
    catalog, reader = jgeo(n_files=3, n_seeds=150, clones_per_seed=25,
                           seed=13)
    runs = {}
    for prune in ("dense", "block", "bitmap"):
        cluster = JCluster(catalog, reader, 4, jbytes(catalog) // 8 // 4,
                           policy="cost", min_cells=2048,
                           join_backend="pallas", prune=prune, **bk)
        runs[prune] = jrun(cluster, jwork.geo_workload(
            catalog.domain, eps=400, range_frac=0.45))
    return runs


def zipf_geo():
    """``smoke_mqo.py``'s and ``smoke_trace.py``'s data and queries."""
    catalog, reader = jgeo(n_files=3, n_seeds=120, clones_per_seed=20,
                           seed=5)
    queries = jwork.zipf_workload(catalog.domain, n_queries=24,
                                  n_templates=6, s=1.1, eps=300,
                                  field_frac=0.4, seed=7)
    return catalog, reader, queries


def ref_mqo(bk):
    """``tools/smoke_mqo.py``."""
    catalog, reader, queries = zipf_geo()

    def build(mqo, rc):
        return JCluster(catalog, reader, 4, jbytes(catalog) // 4,
                        policy="cost", min_cells=512, join_backend="pallas",
                        mqo=mqo, result_cache=rc, **bk)

    return {"reference": jrun(build("off", "off"), queries, 8),
            "optimized": jrun(build("on", "on"), queries, 8)}


def ref_trace(bk):
    """``tools/smoke_trace.py``."""
    catalog, reader, queries = zipf_geo()
    cluster = JCluster(catalog, reader, 4, jbytes(catalog) // 4,
                       policy="cost", min_cells=512, join_backend="pallas",
                       reuse="on", mqo="on", result_cache="on",
                       replication="hot", telemetry="on", **bk)
    return {"traced": jrun(cluster, queries, 8)}


def victim_of(cluster):
    """The tools' victim: the node with the most cached bytes."""
    chunk_bytes, _ = cluster.coordinator.chunks.size_tables()
    by_node = cluster.coordinator.cache.bytes_by_node(chunk_bytes)
    return max(by_node, key=lambda n: (by_node[n], -n))


def ref_failover(bk):
    """``tools/smoke_failover.py``."""
    files = jgen.make_ptf_files(n_files=8, cells_per_file_mean=700, seed=11)
    catalog, data = jbuild(files, tempfile.mkdtemp(prefix="tgates_"),
                           "fits", n_nodes=4)
    reader = JReader(catalog, data)
    queries = jwork.zipf_workload(catalog.domain, n_queries=18,
                                  n_templates=3, s=1.5, eps=150,
                                  field_frac=0.25, seed=3)

    def build(replication):
        return JCluster(catalog, reader, 4, 400_000, policy="cost",
                        min_cells=64, replication=replication, replica_k=2,
                        replication_threshold=2.0, **bk)

    reference = jrun(build("off"), queries, 3)
    cluster = build("hot")
    executed = cluster.run_workload(queries[:9], batch_size=3)
    cluster.fail_node(victim_of(cluster))
    executed += cluster.run_workload(queries[9:], batch_size=3)
    return {"reference": reference, "failed": jrecord(cluster, executed)}


def ref_audit(bk):
    """``tools/audit_state.py`` at its defaults."""
    catalog, reader = jgeo("fits", n_files=12, n_seeds=120,
                           clones_per_seed=12,
                           domain=JBox((1, 1), (4000, 2000)), seed=11)
    queries = jwork.geo_workload(catalog.domain, eps=20, seed=9)
    cluster = JCluster(catalog, reader, 4, 300_000, policy="cost",
                       min_cells=64, replication="hot", replica_k=2,
                       replication_threshold=2.0,
                       faults=JInjector.storm(0.10, seed=0), audit="on",
                       **bk)
    half = len(queries) // 2
    executed = cluster.run_workload(queries[:half], batch_size=2)
    executed += cluster.run_workload(queries[half:], batch_size=2)
    cluster.coordinator.auditor.audit()
    assert cluster.coordinator.auditor.violations_total == 0
    return {"audited": jrecord(cluster, executed)}


REFERENCE = {
    "artifact_counters": ref_artifact_counters,
    "bitmap_prune": ref_bitmap_prune,
    "mqo": ref_mqo,
    "trace": ref_trace,
    "failover": ref_failover,
    "audit": ref_audit,
}


def assert_runs_equal(result, ref_runs):
    """Every run of a port gate equals the reference's run of the same
    name: matches, non-timing summary keys, coordinator stats."""
    assert list(result.runs) == list(ref_runs)
    for name, run in result.runs.items():
        matches, summary, stats = ref_runs[name]
        assert run.matches == matches, name
        assert non_timing(run.summary) == non_timing(summary), name
        assert non_timing(run.stats) == non_timing(stats), name


@pytest.mark.parametrize("backend", smoke.BACKENDS)
@pytest.mark.parametrize("gate", sorted(REFERENCE))
def test_gate_matches_reference(gate, backend, tmp_path):
    """The port's gate passes and equals the reference tool's run."""
    result = smoke.run_gate(gate, backend=backend, device="cpu",
                            root=str(tmp_path))
    assert result.ok, result.failures
    assert result.lines[-1].startswith("OK: ")
    assert_runs_equal(result, REFERENCE[gate](REFERENCE_BACKEND[backend]()))


def test_trace_gate_writes_chrome_trace(tmp_path):
    """The trace gate writes its Chrome trace under its directory, and
    its workload span's children cover it."""
    result = smoke.gate_trace(device="cpu", root=str(tmp_path))
    assert result.ok, result.failures
    path = tmp_path / "trace_out" / "workload.trace.json"
    doc = json.loads(path.read_text())
    assert any(e.get("name") == "workload" for e in doc["traceEvents"])
    assert result.extra["coverage"] > 0.9


# ---------------------------------------------------------- negatives


def fails(result, words):
    """The gate failed, with ``words`` in one of its failures, and
    printed no OK line."""
    assert not result.ok
    assert any(words in f for f in result.failures), result.failures
    assert not any(line.startswith("OK: ") for line in result.lines)


def test_artifact_gate_fails_when_the_cache_is_bypassed(monkeypatch,
                                                       tmp_path):
    from repro_torch.backend.artifacts import ChunkView, JoinArtifactCache
    real = JoinArtifactCache.view
    # Every side becomes a passthrough view: nothing is memoized.
    monkeypatch.setattr(JoinArtifactCache, "view",
                        lambda self, *a, **k: ChunkView(
                            None, real(self, *a, **k).coords))
    fails(smoke.gate_artifact_counters(device="cpu", root=str(tmp_path)),
          "no artifact hits")


def test_bitmap_gate_fails_when_nothing_is_killed(monkeypatch, tmp_path):
    from repro_torch.kernels.simjoin import prune
    monkeypatch.setattr(prune, "refine_block_pairs",
                        lambda pairs, *a, **k: (pairs, 0))
    fails(smoke.gate_bitmap_prune(device="cpu", root=str(tmp_path)),
          "block_pairs_bitmap_killed == 0")


def no_result_cache(monkeypatch):
    """Every cluster the gates build has its result tier off."""
    real = smoke.RawArrayCluster
    monkeypatch.setattr(smoke, "RawArrayCluster", lambda *a, **k: real(
        *a, **{**k, "result_cache": "off"}))


def test_mqo_gate_fails_without_the_result_cache(monkeypatch, tmp_path):
    no_result_cache(monkeypatch)
    fails(smoke.gate_mqo(device="cpu", root=str(tmp_path)),
          "no result-cache hits")


def test_trace_gate_fails_when_the_registry_drifts(monkeypatch, tmp_path):
    real = smoke.workload_summary
    # The fold of the executed queries loses its first counter.
    monkeypatch.setattr(smoke, "workload_summary",
                        lambda executed: dict(list(real(executed).items())
                                              [1:]))
    fails(smoke.gate_trace(device="cpu", root=str(tmp_path)),
          "registry/summary divergence")


def test_failover_gate_fails_without_readmits(monkeypatch, tmp_path):
    from repro_torch.core.coordinator import CacheCoordinator
    monkeypatch.setattr(CacheCoordinator, "_readmit_ok",
                        lambda self, cid, node: False)
    fails(smoke.gate_failover(device="cpu", root=str(tmp_path)),
          "failover_readmits == 0")


def test_audit_gate_fails_when_artifacts_outlive_residency(monkeypatch,
                                                           tmp_path):
    """Join artifacts that ignore residency events outlive their chunks
    (split parents, evictions): the auditor reports them."""
    from repro_torch.backend.artifacts import JoinArtifactCache
    for hook in ("on_drop", "on_split", "reconcile"):
        monkeypatch.setattr(JoinArtifactCache, hook,
                            lambda self, *a, **k: None)
    fails(smoke.gate_audit(device="cpu", root=str(tmp_path)),
          "invariant violation")


def test_cli_exits_nonzero_on_a_failed_gate(monkeypatch, capsys):
    no_result_cache(monkeypatch)
    assert smoke.main(["--gate", "mqo", "--device", "cpu"]) == 1
    err = capsys.readouterr().err
    assert "FAIL: no result-cache hits" in err
    assert "FAIL: gates ['mqo']" in err


# ------------------------------------------------ repair: failover coverage


@pytest.mark.parametrize("reuse", ["off", "on"])
def test_failover_keeps_coverage_to_residency(reuse, tmp_path):
    """After ``fail_node`` the coverage index holds exactly the resident
    chunks under semantic reuse, and stays empty without it (the policy
    rounds keep it only under reuse, so an index filled at a crash kept
    evicted chunks: the auditor's ``coverage⊆residency`` failed on the
    PTF deployment). The reference fills it either way."""
    dataset = smoke.FAILOVER.build(str(tmp_path / "d"))
    queries = smoke.zipf_workload(dataset.catalog.domain, n_queries=18,
                                  n_templates=3, s=1.5, eps=150,
                                  field_frac=0.25, seed=3)
    cluster = smoke._cluster(dataset, "simulated", "cpu", "kernel",
                             replication="hot", reuse=reuse, audit="on",
                             execute_joins=False)
    cache = cluster.coordinator.cache

    def indexed():
        return cache.cached if reuse == "on" else set()

    cluster.run_workload(queries[:9], batch_size=3)
    cluster.fail_node(smoke.fullest_node(cluster))
    assert cache.coverage.ids() == indexed()
    cluster.run_workload(queries[9:], batch_size=3)
    assert cache.coverage.ids() == indexed()
    assert cluster.coordinator.auditor.violations_total == 0
    jcat, jdata = jbuild(jgen.make_ptf_files(n_files=8,
                                             cells_per_file_mean=700,
                                             seed=11),
                         str(tmp_path / "j"), "fits", n_nodes=4)
    ref = JCluster(jcat, JReader(jcat, jdata), 4, 400_000, policy="cost",
                   min_cells=64, replication="hot", replica_k=2,
                   replication_threshold=2.0, reuse=reuse,
                   execute_joins=False)
    ref.run_workload(jwork.zipf_workload(jcat.domain, n_queries=18,
                                         n_templates=3, s=1.5, eps=150,
                                         field_frac=0.25, seed=3)[:9],
                     batch_size=3)
    ref.fail_node(victim_of(ref))
    assert ref.coordinator.cache.coverage.ids() == ref.coordinator.cache.cached
