"""The harness end to end on the CPU at the tiny size: every cell prints
one valid result line, cells and metrics are found by name, and nothing
of JAX or the JAX package is loaded."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import run
from portbench.tests import tiny

CELLS = ("deepseek-moe-16b.train", "ptf.join")


def harness(root: Path, cell: str, trace: int, capsys, seed=3000000001,
            seconds=2):
    """(exit code, the parsed last stdout line or None, stderr)."""
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  bench_file=root / "BENCHMARK.json", device="cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, err


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_one_valid_result(root, cell, trace, capsys):
    rc, res, err = harness(root, cell, trace, capsys)
    assert rc == 0, err
    assert list(res)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in res
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        assert "breakdown" in res
        assert res["device"]["window_s"] > 0
        names = {m["name"] for m in bench["per_layer"]
                 if cell in m.get("workloads", [cell])}
        # Host and counter metrics are there; device ones need a card.
        assert set(res["metrics"]) <= names and res["metrics"]
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
        assert set(res["metrics"]) == want
        assert all(m["value"] > 0 for m in res["metrics"].values())
    checks = [ln for ln in err.strip().splitlines()
              if ln.startswith("check ")]
    assert err.strip().splitlines()[-len(res["checks"]):] == checks


def test_new_cell_and_metric_need_only_new_files(root, capsys):
    """A throwaway cell (a copy of the join cell under another traffic
    name) and a throwaway per-layer metric: new files and entries in
    BENCHMARK.json, no edit of a file there."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = json.loads((root / "workloads" / "ptf.join.json").read_text())
    cell["traffic"] = "ptf2_short"
    cell["params"]["sequence"] = [1, 2]
    (root / "workloads" / "ptf.scratch.json").write_text(json.dumps(cell))
    (root / "metrics" / "queries_in_window.scratch.py").write_text(
        "def read(record):\n    return float(record['queries'])\n")
    bench["workloads"].append({"name": "ptf.scratch", "config": "ptf",
                               "traffic": "ptf2_short", "chips": 1,
                               "why": "throwaway"})
    bench["per_layer"].append({"name": "queries_in_window.scratch",
                               "unit": "queries", "better": "higher",
                               "source": "program_counter",
                               "layer": "planner",
                               "moves": "join_queries_per_s",
                               "workloads": ["ptf.scratch"]})
    for m in bench["end_to_end"]:
        if m["name"] == "join_queries_per_s":
            m["workloads"].append("ptf.scratch")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    try:
        rc, res, err = harness(root, "ptf.scratch", 1, capsys)
        assert rc == 0, err
        assert res["correct"] is True
        assert res["metrics"]["queries_in_window.scratch"]["value"] > 0
    finally:
        tiny.make(root)


def test_exits_without_a_cuda_device(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = run.main(["--workload", "deepseek-moe-16b.train", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_forbidden_module_refuses_the_result(root, capsys, monkeypatch):
    """A loaded module named ``repro`` (the JAX package) or ``jax``
    after the window: exit 1, no result line."""
    import types
    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    rc, res, err = harness(root, "ptf.join", 0, capsys, seconds=0.5)
    assert rc == 1 and res is None
    assert "repro" in err


def test_runs_load_neither_jax_nor_the_jax_package(tmp_path):
    """Both cells in a fresh interpreter: no module whose top-level name
    is jax, jaxlib, flax or repro (``repro_torch`` is the port)."""
    root = tiny.make(tmp_path / "tiny")
    code = (
        "import sys\n"
        "from pathlib import Path\n"
        "from portbench import run, common\n"
        f"root = Path({str(root)!r})\n"
        f"for cell in {CELLS!r}:\n"
        "    assert run.main(['--workload', cell, '--seed', '7', "
        "'--seconds', '1', '--trace', '1'], root=root, "
        "bench_file=root / 'BENCHMARK.json', device='cpu') == 0\n"
        "bad = common.forbidden_modules()\n"
        "assert not bad, bad\n"
        "assert 'repro_torch' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tiny.CHECKOUT / "src"), str(tiny.CHECKOUT)]))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=tmp_path, capture_output=True, timeout=600)


def test_fails_in_a_directory_with_only_the_benchmark(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program to run,
    so a non-zero exit and no result (the look for a CUDA device is
    skipped, so that the missing program is what stops it)."""
    shutil.copy(tiny.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\n"
            "sys.path.insert(0, '.')\n"
            "from portbench import run\n"
            "sys.exit(run.main(['--workload', 'deepseek-moe-16b.train', "
            "'--seed', '1', '--seconds', '1', '--trace', '0'], "
            "device='cpu'))\n")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert "repro_torch" in proc.stderr
    assert not proc.stdout.strip()
