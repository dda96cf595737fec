"""The port's raw-array cached token pipeline against the reference's:
the same corpus files from the same seed, batches and labels equal bit
for bit across two epochs, equal ``PipelineStats`` after every step,
a deterministic resume, and the reference tests' own checks (batches
against the dense source, warm second epoch, cost policy against
file_lru) on the port."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (resolves the reference's import cycle)
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402

SMALL = dict(n_samples=64, seq=32, vocab=256, n_files=6, n_hosts=4,
             batch=8, host_budget_bytes=4 << 20, seed=1)


def test_corpus_matches_reference():
    """``make_token_corpus`` gives the reference's files and lengths."""
    jf, jl = jpipe.make_token_corpus(64, 32, 256, 6, seed=1)
    tf, tl = tpipe.make_token_corpus(64, 32, 256, 6, seed=1)
    np.testing.assert_array_equal(jl, tl)
    assert len(jf) == len(tf)
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.attrs, b.attrs)
        assert a.coords.dtype == b.coords.dtype
        assert a.attrs.dtype == b.attrs.dtype
        assert tuple(a.box.lo) == tuple(b.box.lo)
        assert tuple(a.box.hi) == tuple(b.box.hi)


@pytest.mark.parametrize("policy,budget", [("cost", 4 << 20),
                                           ("file_lru", 96 << 10),
                                           ("chunk_lru", 96 << 10)])
def test_two_epochs_match_reference(tmp_path, policy, budget):
    """Every batch of two epochs equal bit for bit, and the stats equal
    after every step."""
    kw = dict(SMALL, policy=policy, host_budget_bytes=budget)
    j = jpipe.build_pipeline(str(tmp_path / "j"), **kw)
    t = tpipe.build_pipeline(str(tmp_path / "t"), **kw)
    assert t.steps_per_epoch == j.steps_per_epoch
    for _ in range(2 * t.steps_per_epoch):
        a, b = j.next_batch(), t.next_batch()
        assert sorted(a) == sorted(b)
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
        assert dataclasses.asdict(j.stats) == dataclasses.asdict(t.stats)
        assert j.state() == t.state()
    assert t.stats.cache_hit_steps > 0


def test_resume_matches_reference(tmp_path):
    """A pipeline resumed from another's state continues as the
    reference's does."""
    kw = dict(n_samples=48, seq=16, vocab=128, n_files=4, n_hosts=2,
              batch=8, seed=3)
    j = jpipe.build_pipeline(str(tmp_path / "j"), **kw)
    a = tpipe.build_pipeline(str(tmp_path / "a"), **kw)
    b = tpipe.build_pipeline(str(tmp_path / "b"), **kw)
    for _ in range(4):
        j.next_batch()
        a.next_batch()
    b.set_state(a.state())
    for _ in range(4):
        x, y, z = j.next_batch(), a.next_batch(), b.next_batch()
        for key in x:
            np.testing.assert_array_equal(x[key], y[key])
            np.testing.assert_array_equal(x[key], z[key])


def test_batches_match_source(tmp_path):
    """The reference test's check on the port: tokens and labels against
    the dense source array (-1 where there is no next token)."""
    p = tpipe.build_pipeline(str(tmp_path), **SMALL)
    files, _ = tpipe.make_token_corpus(64, 32, 256, 6, seed=1)
    dense = np.zeros((65, 34), np.int64)
    have = np.zeros((65, 34), bool)
    for f in files:
        for (s, pos), tok in zip(f.coords, f.attrs[:, 0]):
            dense[s, pos] = int(tok)
            have[s, pos] = True
    batch = p.next_batch()
    assert batch["tokens"].shape == (8, 32) == batch["labels"].shape
    for r in range(8):
        for c in range(32):
            s, pos = 1 + r, c + 1
            if have[s, pos]:
                assert batch["tokens"][r, c] == dense[s, pos]
            want = dense[s, pos + 1] if have[s, pos + 1] else -1
            assert batch["labels"][r, c] == want


def test_second_epoch_hits_cache_and_cost_scans_less(tmp_path):
    """The warm second epoch scans no raw bytes, and the cost policy
    scans no more than file_lru over two shifted epochs."""
    p = tpipe.build_pipeline(str(tmp_path / "warm"), **SMALL)
    for _ in range(p.steps_per_epoch * 2):
        p.next_batch()
    assert p.stats.cache_hit_steps > 0
    before = p.stats.bytes_scanned
    p.next_batch()
    assert p.stats.bytes_scanned == before
    scanned = {}
    for policy in ("cost", "file_lru"):
        q = tpipe.build_pipeline(str(tmp_path / policy),
                                 **dict(SMALL, host_budget_bytes=96 << 10,
                                        policy=policy, seed=5))
        for _ in range(q.steps_per_epoch * 2):
            q.next_batch()
        scanned[policy] = q.stats.bytes_scanned
    assert scanned["cost"] <= scanned["file_lru"]


def test_pipeline_runs_on_the_host():
    """The cluster under the pipeline plans and reads on the host, as the
    reference's does (simulated backend, numpy joins, none executed):
    it needs no card."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        p = tpipe.build_pipeline(tmp, n_samples=16, seq=8, vocab=32,
                                 n_files=2, n_hosts=2, batch=4)
        assert type(p.cluster.backend).__name__ == "SimulatedBackend"
        assert not p.cluster.execute_joins
        assert p.next_batch()["tokens"].shape == (4, 8)
