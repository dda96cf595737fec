"""The port's chaos gate (``tools/smoke_torch.py``) against the JAX
package's ``tools/smoke_chaos.py``, on the CPU: the port's gate on
``device="cpu"`` through ``torch_device`` and ``simulated``, the
reference's fault-free run and one storm run on the tool's recipe
(``jax_mesh`` on one jax device, or ``simulated``). Held equal: both
runs' per-query matches, non-timing ``workload_summary`` keys and
coordinator stats, and the storm's injection schedule; the port's gate
reports no failure, and fails when its storm injects nothing."""
import importlib.util
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
from repro.core import workload as jwork  # noqa: E402
from repro.faults import FAULT_POINTS, FaultInjector, FaultSpec  # noqa: E402

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


def non_timing(d):
    """The keys of a summary or stats dict that are not timings."""
    return {k: v for k, v in d.items()
            if not k.endswith("_s") and not k.startswith("measured_")}


def reference_storm():
    """``smoke_chaos.py``'s storm (rates 0.10 and 0.45, seed 1234)."""
    specs = [FaultSpec("ship.transfer", 0.45, kinds=("error", "corrupt"))]
    specs += [FaultSpec(p, 0.10, kinds=("error", "latency", "corrupt"))
              for p in FAULT_POINTS if p != "ship.transfer"]
    return FaultInjector(specs, seed=1234)


def reference_chaos(bk):
    """The tool's fault-free run and its first storm run: (runs by name,
    the storm's schedule_log)."""
    files = jgen.make_ptf_files(n_files=12, cells_per_file_mean=700,
                                seed=11)
    catalog, data = jbuild(files, tempfile.mkdtemp(prefix="tchaos_"),
                           "fits", n_nodes=4)
    reader = JReader(catalog, data)
    queries = jwork.zipf_workload(catalog.domain, n_queries=24,
                                  n_templates=3, s=1.5, eps=150,
                                  field_frac=0.5, seed=3)
    runs, schedule = {}, None
    for name, faults in (("reference", "off"), ("storm", reference_storm())):
        cluster = JCluster(catalog, reader, 4, 400_000, policy="cost",
                           min_cells=64, replication="hot", replica_k=2,
                           replication_threshold=2.0, faults=faults, **bk)
        executed = cluster.run_workload(queries, batch_size=3)
        runs[name] = ([e.matches for e in executed], jsummary(executed),
                      dict(cluster.coordinator.stats))
        if faults != "off":
            schedule = list(cluster.coordinator.faults.schedule_log)
    return runs, schedule


@pytest.mark.parametrize("backend,reference", [
    ("torch_device", "jax_mesh"), ("simulated", "simulated")])
def test_chaos_gate_matches_reference(backend, reference, tmp_path):
    """The gate passes; its fault-free and storm runs, and the storm's
    schedule, equal the reference tool's."""
    result = smoke.run_gate("chaos", backend=backend, device="cpu",
                            root=str(tmp_path))
    assert result.ok, result.failures
    assert result.lines[-1].startswith("OK: storm injected")
    bk = dict(backend=reference)
    if reference == "jax_mesh":
        bk["devices"] = jax.devices()[:1]
    want, schedule = reference_chaos(bk)
    for name, (matches, summary, stats) in want.items():
        run = result.runs[name]
        assert run.matches == matches, name
        assert non_timing(run.summary) == non_timing(summary), name
        assert non_timing(run.stats) == non_timing(stats), name
    assert result.extra["schedule_log"] == schedule
    assert result.runs["storm_again"].matches == result.runs["storm"].matches
    assert result.summary["faults_injected"] > 0


def test_chaos_gate_fails_when_the_storm_is_dead(monkeypatch, tmp_path):
    """A storm that injects nothing fails the gate."""
    monkeypatch.setattr(smoke, "build_storm",
                        lambda: smoke.FaultInjector([], seed=1234))
    result = smoke.gate_chaos(device="cpu", root=str(tmp_path))
    assert not result.ok
    assert any("injected nothing" in f for f in result.failures)
    assert any("re-routed" in f for f in result.failures)
