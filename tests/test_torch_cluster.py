"""The port's cluster façade against the JAX package's: equal workload
summaries on small PTF and GEO workloads, the seed observables of
``test_policy_parity``, the GEO constants of ``BENCH_kernels.json``,
byte-identical data files and catalogs from the same seed, the
package-import rule (no ``jax``, no ``repro``), the no-card error, and
the port's docstring coverage."""
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
from repro.arrayio import catalog as jcatalog  # noqa: E402
from repro.arrayio import generator as jgenerator  # noqa: E402
from repro.core.cluster import RawArrayCluster as JaxCluster  # noqa: E402
from repro.core.cluster import workload_summary as jax_summary  # noqa: E402
from repro_torch.arrayio import catalog as tcatalog  # noqa: E402
from repro_torch.arrayio import generator as tgenerator  # noqa: E402
from repro_torch.core.cluster import (RawArrayCluster,  # noqa: E402
                                      workload_summary)
from repro_torch.core.workload import (geo_workload,  # noqa: E402
                                       ptf1_workload, ptf2_workload)

REPO = Path(__file__).resolve().parents[1]

# The seed observables of tests/test_policy_parity.py (dataset seed 21,
# ptf1 seed 7 + ptf2 seed 5, 4 nodes, 6 kB/node budget), per query:
# [bytes scanned, files scanned, queried cells, cached chunks after,
#  cached bytes after, evicted items, join matches].
EXPECTED = {
    "cost": [
        [86400, [1, 6, 7], 2, 2, 1856, 0, 0],
        [86400, [1, 6, 7], 31, 5, 4480, 0, 0],
        [149760, [0, 1, 5, 7], 0, 5, 4480, 0, 0],
        [0, [], 0, 5, 4480, 0, 0],
        [0, [], 0, 5, 4480, 0, 0],
        [149760, [0, 1, 5, 7], 31, 9, 5472, 0, 1],
        [149760, [0, 1, 5, 7], 1351, 20, 43232, 5, 101],
        [48960, [7], 714, 21, 23328, 15, 48],
    ],
    "chunk_lru": [
        [86400, [1, 6, 7], 2, 2, 1856, 0, 0],
        [86400, [1, 6, 7], 31, 5, 4480, 0, 0],
        [149760, [0, 1, 5, 7], 0, 5, 4480, 0, 0],
        [0, [], 0, 5, 4480, 0, 0],
        [0, [], 0, 5, 4480, 0, 0],
        [149760, [0, 1, 5, 7], 31, 9, 5472, 0, 1],
        [149760, [0, 1, 5, 7], 1351, 10, 23296, 17, 101],
        [149760, [0, 1, 5, 7], 714, 21, 23328, 14, 48],
    ],
    "file_lru": [
        [86400, [1, 6, 7], 2, 1, 18720, 1, 0],
        [86400, [1, 6, 7], 31, 1, 18720, 2, 0],
        [172800, [0, 1, 5, 6, 7], 0, 1, 18720, 2, 0],
        [172800, [0, 1, 5, 6, 7], 0, 1, 18720, 2, 0],
        [172800, [0, 1, 5, 6, 7], 0, 1, 18720, 2, 0],
        [172800, [0, 1, 5, 6, 7], 31, 1, 18720, 2, 1],
        [172800, [0, 1, 5, 6, 7], 1351, 1, 18720, 2, 101],
        [172800, [0, 1, 5, 6, 7], 714, 1, 18720, 2, 48],
    ],
}


@pytest.fixture(scope="module")
def ptf():
    files = tgenerator.make_ptf_files(n_files=10, cells_per_file_mean=900,
                                      seed=21)
    return tcatalog.build_catalog(files, tempfile.mkdtemp(prefix="tptf_"),
                                  "fits", n_nodes=4)


@pytest.fixture(scope="module")
def geo():
    files = tgenerator.make_geo_files(n_files=3, n_seeds=150,
                                      clones_per_seed=25, seed=13)
    return tcatalog.build_catalog(files, tempfile.mkdtemp(prefix="tgeo_"),
                                  "csv", n_nodes=4)


def ptf_queries(catalog):
    return (ptf1_workload(catalog.domain, n_queries=4, eps=300, seed=7)
            + ptf2_workload(catalog.domain, n_queries=4, eps=300))


def untimed(summary):
    """Every summary key except measured timings."""
    return {k: v for k, v in summary.items()
            if not k.endswith("_s") and not k.startswith("measured_")}


@pytest.mark.parametrize("workload", ["ptf", "geo"])
def test_summary_matches_jax_cluster(workload, ptf, geo):
    """The port on the CPU and the JAX mesh on one device run the same
    plans: equal per-query matches and equal summaries but for timings."""
    catalog, data = ptf if workload == "ptf" else geo
    if workload == "ptf":
        queries, budget, min_cells = ptf_queries(catalog), 6_000, 64
    else:
        queries = geo_workload(catalog.domain, eps=400, range_frac=0.45)[:6]
        total = sum(f.n_cells * f.cell_bytes for f in catalog.files)
        budget, min_cells = total // 8 // 4, 512
    common = dict(policy="cost", min_cells=min_cells, prune="auto")
    port = RawArrayCluster(catalog, tcatalog.FileReader(catalog, data), 4,
                           budget, device="cpu", **common).run_workload(
                               queries)
    ref = JaxCluster(catalog, jcatalog.FileReader(catalog, data), 4, budget,
                     backend="jax_mesh", join_backend="pallas",
                     devices=jax.devices()[:1], **common).run_workload(
                         queries)
    assert [e.matches for e in port] == [e.matches for e in ref]
    assert sum(e.matches or 0 for e in port) > 0
    got, want = workload_summary(port), jax_summary(ref)
    assert list(got) == list(want)
    assert untimed(got) == untimed(want)


@pytest.mark.parametrize("join_backend", ["numpy", "torch"])
@pytest.mark.parametrize("policy", sorted(EXPECTED))
def test_seed_observables(ptf, policy, join_backend):
    catalog, data = ptf
    cluster = RawArrayCluster(catalog, tcatalog.FileReader(catalog, data), 4,
                              6_000, policy=policy, min_cells=64,
                              backend="simulated", join_backend=join_backend,
                              device="cpu")
    rows = []
    for e in cluster.run_workload(ptf_queries(catalog)):
        r = e.report
        rows.append([sum(r.scan_bytes_by_node.values()),
                     sorted(r.files_scanned), r.queried_cells,
                     r.cached_chunks_after, r.cached_bytes_after,
                     r.evicted_items, e.matches])
    assert rows == EXPECTED[policy]


@pytest.fixture(scope="module")
def geo_bench():
    """The clustered GEO dataset of the reference's kernel bench."""
    files = tgenerator.make_geo_files(n_files=4, n_seeds=300,
                                      clones_per_seed=40, seed=11)
    catalog, data = tcatalog.build_catalog(
        files, tempfile.mkdtemp(prefix="tgeob_"), "csv", n_nodes=8)
    return catalog, data, geo_workload(catalog.domain, eps=500,
                                       range_frac=0.5)


@pytest.mark.parametrize("prune,evaluated,killed", [
    ("dense", 3548, None), ("block", 1122, None), ("bitmap", 1084, 38),
    ("auto", 1084, 38)])
def test_geo_constants(geo_bench, prune, evaluated, killed):
    """100126 matches, 3548 block pairs in all, and the per-mode
    evaluated / bitmap-killed counts (``BENCH_kernels.json``)."""
    catalog, data, queries = geo_bench
    total = sum(f.n_cells * f.cell_bytes for f in catalog.files)
    executed = RawArrayCluster(
        catalog, tcatalog.FileReader(catalog, data), 8, total // 8 // 8,
        policy="cost", min_cells=8192, device="cpu",
        prune=prune).run_workload(queries)
    s = workload_summary(executed)
    assert sum(e.matches for e in executed) == 100126
    assert s["block_pairs_total"] == 3548
    assert s["block_pairs_evaluated"] == evaluated
    assert s.get("block_pairs_bitmap_killed") == killed


@pytest.mark.parametrize("fmt", ["csv", "fits", "hdf5"])
def test_same_seed_same_bytes(fmt, tmp_path):
    """Both packages write byte-identical files and equal catalogs from
    one seed, and the port's reader decodes the reference's files."""
    jfiles = jgenerator.make_geo_files(n_files=3, n_seeds=20,
                                       clones_per_seed=5, seed=4) \
        if fmt == "csv" else jgenerator.make_ptf_files(
            n_files=4, cells_per_file_mean=300, seed=4)
    tfiles = tgenerator.make_geo_files(n_files=3, n_seeds=20,
                                       clones_per_seed=5, seed=4) \
        if fmt == "csv" else tgenerator.make_ptf_files(
            n_files=4, cells_per_file_mean=300, seed=4)
    jcat, _ = jcatalog.build_catalog(jfiles, str(tmp_path / "j"), fmt,
                                     n_nodes=4)
    tcat, _ = tcatalog.build_catalog(tfiles, str(tmp_path / "t"), fmt,
                                     n_nodes=4)
    assert (jcat.ndim, jcat.nattr) == (tcat.ndim, tcat.nattr)
    # Box is a class of each package: compare corners.
    assert (tcat.domain.lo, tcat.domain.hi) == (jcat.domain.lo,
                                                jcat.domain.hi)
    for jm, tm in zip(jcat.files, tcat.files):
        assert Path(jm.path).read_bytes() == Path(tm.path).read_bytes()
        assert (tm.file_id, tm.node, tm.fmt, tm.box.lo, tm.box.hi,
                tm.n_cells, tm.file_bytes, tm.cell_bytes) == \
            (jm.file_id, jm.node, jm.fmt, jm.box.lo, jm.box.hi, jm.n_cells,
             jm.file_bytes, jm.cell_bytes)
    # The port reads (from disk, through its decoder) what the reference
    # wrote, cell for cell.
    reader = tcatalog.FileReader(jcat)
    for i, g in enumerate(jfiles):
        coords, attrs = reader.read(i)
        np.testing.assert_array_equal(coords, g.coords)
        np.testing.assert_allclose(attrs, g.attrs, rtol=1e-5)


def test_port_imports_neither_jax_nor_repro():
    """A small port workload, a reduced-size serving run (Jamba: Mamba,
    attention and MoE blocks) and a few steps of the training entry point
    in a fresh interpreter leave ``jax`` and every ``repro`` module out of
    ``sys.modules``. It imports
    ``repro_torch.faults`` first: unlike the reference's, the port's
    packages import in any order."""
    code = (
        "import sys, tempfile, warnings\n"
        "warnings.simplefilter('ignore')\n"
        "from repro_torch.faults import FaultInjector\n"
        "import repro_torch\n"
        "from repro_torch.arrayio import build_catalog, FileReader, "
        "make_ptf_files\n"
        "from repro_torch.core.workload import ptf2_workload\n"
        "files = make_ptf_files(n_files=6, cells_per_file_mean=300, "
        "seed=3)\n"
        "cat, data = build_catalog(files, tempfile.mkdtemp(), 'hdf5', "
        "n_nodes=4)\n"
        "c = repro_torch.RawArrayCluster(cat, FileReader(cat, data), 4, "
        "20_000, min_cells=64, device='cpu')\n"
        "ex = c.run_workload(ptf2_workload(cat.domain, n_queries=3, "
        "eps=300))\n"
        "assert all(e.matches is not None for e in ex)\n"
        "from repro_torch.configs import get, reduced\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models import moe, ssm\n"
        "from repro_torch.models.model import init_params\n"
        "from repro_torch.serve.engine import Request, ServingEngine\n"
        "cfg = reduced(get('jamba-1.5-large-398b'), n_periods=1)\n"
        "eng = ServingEngine(cfg, init_params(cfg, device='cpu'), slots=2, "
        "max_len=32, device='cpu')\n"
        "done = eng.run([Request(i, [1, 2, 3, 4 + i], max_new_tokens=2) "
        "for i in range(3)])\n"
        "assert len(done) == 3 and eng.stats.decode_steps > 0\n"
        "from repro_torch.launch import train\n"
        "out = train.main(['--device', 'cpu', '--steps', '3', '--batch', "
        "'2', '--seq', '8', '--d-model', '32', '--periods', '1', "
        "'--vocab', '64', '--data-dir', tempfile.mkdtemp(), "
        "'--ckpt-dir', tempfile.mkdtemp(), '--ckpt-every', '2'])\n"
        "assert len(out['losses']) == 3\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'repro' or k.startswith('repro.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "BAD []" in proc.stdout


def test_cuda_default_without_card_raises(ptf):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    catalog, data = ptf
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RawArrayCluster(catalog, tcatalog.FileReader(catalog, data), 4,
                        6_000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RawArrayCluster(catalog, tcatalog.FileReader(catalog, data), 4,
                        6_000, backend="simulated")


def test_port_docstring_coverage():
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "check_docstrings.py"),
         str(REPO / "src" / "repro_torch"), "--fail-under", "100"],
        capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PASSED" in proc.stdout
