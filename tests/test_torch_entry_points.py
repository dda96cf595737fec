"""The port's entry points beside the JAX package's, on the CPU: the
gate runner and the examples import neither ``jax`` nor any ``repro``
module; ``examples/serve_lm_torch.py`` on the reference example's own
weights (through ``models/convert.py``) saves what the reference example
saves in both traffic mixes; ``examples/quickstart_torch.py`` scans what
the reference quickstart scans under each policy; without a card every
default entry point raises; and ``python -m repro_torch.launch.serve
--device cpu`` at its defaults serves what the reference launcher
serves."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (resolves the reference's import cycle)

REPO = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}


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


def load(rel):
    """A script of the repo (``tools/`` or ``examples/``) as a module."""
    path = REPO / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod     # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def test_gate_runner_and_example_import_neither_jax_nor_repro():
    """``tools/smoke_torch.py --device cpu --gate artifact_counters`` and
    ``examples/raw_array_analytics_torch.py``'s ``main`` in a fresh
    interpreter pass and leave ``jax`` and every ``repro`` module out of
    ``sys.modules``."""
    code = (
        "import runpy, sys, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "sys.argv = ['smoke_torch.py', '--device', 'cpu', '--gate', "
        "'artifact_counters']\n"
        "try:\n"
        "    runpy.run_path('tools/smoke_torch.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "ex = runpy.run_path('examples/raw_array_analytics_torch.py')\n"
        "passes = ex['main'](['--device', 'cpu'])\n"
        "assert len(passes) == 3 and passes[0].matches is not None\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK: artifact cache hit" in out.stdout
    assert out.stdout.strip().endswith("clean")


def test_serve_example_saves_what_the_reference_saves():
    """The serving example's two traffic mixes, on the reference
    example's weights carried across by ``params_from_numpy``: the
    prompt tokens and the prefill the prefix cache saved equal the
    reference example's in each mix."""
    from repro.configs import get as jget, reduced as jreduced
    from repro.models.model import init_params as jinit
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServingEngine as JEngine
    from repro_torch.models.convert import params_from_numpy
    ex = load("examples/serve_lm_torch.py")
    cfg = ex.config()
    jcfg = jreduced(jget("qwen1.5-0.5b"), d_model=64, n_periods=2,
                    vocab=512)
    assert cfg.resolved_head_dim == jcfg.resolved_head_dim == 16
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    stats, done = ex.serve(cfg, params, "cpu")
    for name, reqs in ex.traffic(cfg).items():
        engine = JEngine(jcfg, jp, slots=3, max_len=96, page_size=8,
                         cache_budget_pages=32, policy="cost")
        engine.run([JRequest(r.request_id, list(r.prompt),
                             max_new_tokens=r.max_new_tokens)
                    for r in reqs])
        want = engine.stats
        assert stats[name].prompt_tokens == want.prompt_tokens, name
        assert stats[name].prefill_saved == want.prefill_saved, name
        assert stats[name].requests == want.requests == len(done[name])
    assert stats[ex.MIXES[0]].prefill_saved > 0


def test_quickstart_scans_what_the_reference_scans():
    """Files scanned and bytes scanned under each policy equal the
    reference quickstart's (its own recipe: 12 PTF files of about 2000
    cells, fits, 4 nodes, a quarter of the dataset cached, ptf2
    queries)."""
    from repro.arrayio import FileReader, build_catalog, make_ptf_files
    from repro.core import RawArrayCluster, workload_summary
    from repro.core.workload import ptf2_workload
    ex = load("examples/quickstart_torch.py")
    got = ex.main(["--device", "cpu"])
    files = make_ptf_files(n_files=12, cells_per_file_mean=2000, seed=5)
    catalog, data = build_catalog(files, tempfile.mkdtemp(prefix="tqs_"),
                                  "fits", n_nodes=4)
    reader = FileReader(catalog, data)
    budget = sum(f.n_cells * f.cell_bytes for f in catalog.files) // 4
    queries = ptf2_workload(catalog.domain, n_queries=10)
    for policy in ex.POLICIES:
        cluster = RawArrayCluster(catalog, reader, 4, budget // 4,
                                  policy=policy, min_cells=128)
        want = workload_summary(cluster.run_workload(queries))
        for key in ("files_scanned", "bytes_scanned"):
            assert got[policy][key] == want[key], (policy, key)
    assert got["cost"]["files_scanned"] < got["file_lru"]["files_scanned"]


ENTRY_POINTS = {
    "tools/smoke_torch.py": [],
    "tools/trace_report_torch.py": ["--out", "unused.trace.json"],
    "examples/quickstart_torch.py": [],
    "examples/raw_array_analytics_torch.py": [],
    "examples/serve_lm_torch.py": [],
    "examples/train_lm_torch.py": ["--steps", "1"],
}


@pytest.mark.parametrize("script", sorted(ENTRY_POINTS))
def test_default_entry_point_needs_a_card(script, tmp_path, monkeypatch):
    """At its defaults each new entry point asks for the card and raises
    without one: nothing runs on the CPU unless ``--device cpu`` says
    so."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    monkeypatch.chdir(tmp_path)
    mod = load(script)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(ENTRY_POINTS[script])
    assert not (tmp_path / "unused.trace.json").exists()


def test_serve_launcher_at_its_defaults_matches_reference():
    """``python -m repro_torch.launch.serve --device cpu`` (reduced
    qwen1.5-0.5b, head dim 16) in a subprocess serves the reference
    launcher's requests with its counters."""
    from repro.launch import serve as jlaunch
    code = ("import dataclasses, json, sys\n"
            "from repro_torch.launch import serve\n"
            "engine = serve.main(['--device', 'cpu'])\n"
            "print(json.dumps(dataclasses.asdict(engine.stats)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("served 8 requests")
    want = dataclasses.asdict(jlaunch.main([]).stats)
    assert json.loads(lines[-1]) == want


def test_new_tools_and_examples_docstring_coverage():
    """The port's gate runner, trace report and examples are documented
    to the package's bar (``tools/check_docstrings.py --fail-under
    100``)."""
    paths = ["tools/smoke_torch.py", "tools/trace_report_torch.py"] + \
        sorted(str(p.relative_to(REPO))
               for p in (REPO / "examples").glob("*_torch.py"))
    out = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_docstrings.py"),
         *paths, "--fail-under", "100"], cwd=REPO, capture_output=True,
        text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "PASSED" in out.stdout


def test_trace_report_runs_on_the_cpu(tmp_path, capsys):
    """``tools/trace_report_torch.py --device cpu`` prints the per-phase
    and per-node tables and the registry summary, and writes a Chrome
    trace whose root span is the workload."""
    path = tmp_path / "w.trace.json"
    mod = load("tools/trace_report_torch.py")
    assert mod.main(["--device", "cpu", "--out", str(path)]) == 0
    out = capsys.readouterr().out
    assert "== per-phase breakdown" in out and "device=cpu" in out
    assert "== per-node breakdown ==" in out
    assert "  queries = 24" in out
    doc = json.loads(path.read_text())
    assert any(e.get("name") == "workload" for e in doc["traceEvents"])
