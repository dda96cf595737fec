"""The simjoin kernels' Hopper design, what of it runs here and what runs
only on the card.

On the CPU: the pair lists' range check on the host (through ``ops`` on
numpy lists and through the executor's prepared batch; the kernel path
reads nothing back from the card), a numpy model of the kernels' exact
float32 rule, and the plain pair-list version against the Pallas kernel
in interpret mode on lists out of ``block_i`` order with pad rows
mid-list. On the card (``cuda`` marker, no JAX): both kernels against
their plain versions on ``chip_smoke.py``'s edge cases, each wrapper
captured in a CUDA graph, and an out-of-grid live row trapping a child
process::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_simjoin_redesign.py
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.backend import TorchJoinExecutor  # noqa: E402
from repro_torch.kernels.simjoin import ops, prune, simjoin  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
LIM = simjoin.FP32_EXACT_LIMIT


def clustered_coords(rng, n, d=3, n_clusters=4, domain=20_000, spread=40):
    centers = rng.integers(0, domain, (n_clusters, d))
    pick = rng.integers(0, n_clusters, n)
    return (centers[pick] + rng.integers(-spread, spread + 1,
                                         (n, d))).astype(np.int32)


def sorted_padded(rng, n, same):
    """Spatially sorted, sentinel-padded (d, N) sides of one task."""
    a = prune.spatial_sort(clustered_coords(rng, n))
    b = a if same else prune.spatial_sort(
        a + rng.integers(-30, 31, a.shape).astype(np.int32))
    return (ops.pad_cm_np(a, simjoin.SENTINEL),
            ops.pad_cm_np(b, -simjoin.SENTINEL), a, b)


def unordered_list(rng, pairs, nab, nbb, same):
    """A live pair list shuffled out of block_i order, with pad rows
    (garbage indices, valid 0) inserted mid-list and, in self-joins, one
    row below the diagonal."""
    rows = pairs[rng.permutation(len(pairs))]
    if same and nab > 1:
        rows = np.concatenate([rows, [[nab - 1, 0, 1]]])
    pads = np.array([[9999, -3, 0], [-1, 77, 0], [0, 0, 0]])
    at = np.sort(rng.choice(len(rows) + 1, len(pads)))
    return np.insert(rows, at, pads, axis=0).astype(np.int32)


# -------------------------------------------- the range check on the host

OUT_OF_GRID = {"block_i high": [2, 0, 1], "block_j high": [0, 2, 1],
               "block_i negative": [-1, 0, 1],
               "block_j negative": [0, -1, 1]}


@pytest.mark.parametrize("bad", sorted(OUT_OF_GRID))
def test_range_check_through_ops_on_numpy_lists(bad, monkeypatch):
    """A live row outside the 2 x 2 grid raises ValueError on the host,
    before any kernel wrapper is reached; pad rows may hold anything."""
    rng = np.random.default_rng(1)
    at, bt, _, _ = sorted_padded(rng, 200, False)
    assert at.shape[1] == bt.shape[1] == 2 * simjoin.BLOCK
    good = np.array([[0, 0, 1], [1, 1, 1], [55, -7, 0]], np.int32)
    simjoin.check_pairs_in_grid(good, 2, 2)
    want = int(ops.count_similar_pairs_pruned(at, bt, good, 30, False,
                                              device=CPU))
    listed = np.concatenate([good, [OUT_OF_GRID[bad]]]).astype(np.int32)

    def unreachable(*args, **kwargs):
        raise AssertionError("the wrapper was reached")
    monkeypatch.setattr(ops, "simjoin_pruned_block_counts", unreachable)
    with pytest.raises(ValueError, match="outside the grid"):
        ops.count_similar_pairs_pruned(at, bt, listed, 30, False,
                                       device=CPU)
    with pytest.raises(ValueError, match="outside the grid"):
        ops.count_similar_pairs_pruned_batch(at[None], bt[None],
                                             listed[None], 30, False,
                                             device=CPU)
    monkeypatch.undo()
    assert want == int(ops.count_similar_pairs_pruned(
        at, bt, good, 30, False, device=CPU))


def test_range_check_in_executor_prepared_batch():
    """The executor checks each stacked pair list once, where it builds
    the prepared batch."""
    rng = np.random.default_rng(2)
    a = clustered_coords(rng, 300)
    tasks = [(0, a, a, True), (0, a, a + 5, False)]
    ex = TorchJoinExecutor(device=CPU, prune="block")
    batches, _ = ex.iter_batches(tasks, 40)
    assert any(b.fn_key[0] == "block" for b in batches)

    def out_of_grid(a_s, b_s, block, eps, same):
        pairs, total = prune.build_block_pairs(a_s, b_s, block, eps, same)
        return np.concatenate([pairs, [[0, 3, 1]]]).astype(np.int32), total
    fields = {k: v for k, v in vars(prune).items() if not k.startswith("__")}
    ex._prune = SimpleNamespace(**dict(fields,
                                       build_block_pairs=out_of_grid))
    with pytest.raises(ValueError, match="outside the grid"):
        ex.iter_batches(tasks, 40)


# ------------------------------------------------- the exact fp32 rule

def fits_model(v):
    """The kernels' per-coordinate test of the fp32 branch, in numpy:
    (uint32(v) + 2^21) mod 2^32 <= 2^22."""
    u = (np.asarray(v, np.int64).astype(np.uint32).astype(np.uint64)
         + LIM) % 2 ** 32
    return u <= 2 * LIM


def test_fp32_fits_test_is_the_range():
    v = np.array([-2 ** 31, -LIM - 1, -LIM, -LIM + 1, -1, 0, 1, LIM - 1,
                  LIM, LIM + 1, 2 ** 24 + 1, 2 ** 31 - 1])
    assert fits_model(v).tolist() == ((v >= -LIM) & (v <= LIM)).tolist()
    assert fits_model([simjoin.SENTINEL, -simjoin.SENTINEL]).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_fp32_distances_are_exact_within_the_limit(seed):
    """d = 4, coordinates at and near +-2^21 (sentinels included): the
    float32 sum of |a - b| equals the int64 distance for every pair, so
    every threshold, min(eps, 2^24) as a float, gives the int count."""
    rng = np.random.default_rng(seed)
    edge = np.array([-LIM, -LIM + 1, -1, 0, 1, LIM - 1, LIM,
                     simjoin.SENTINEL, -simjoin.SENTINEL])
    a = np.where(rng.random((200, 4)) < 0.6, rng.choice(edge, (200, 4)),
                 rng.integers(-LIM, LIM + 1, (200, 4)))
    b = np.where(rng.random((150, 4)) < 0.6, rng.choice(edge, (150, 4)),
                 rng.integers(-LIM, LIM + 1, (150, 4)))
    exact = np.abs(a[:, None, :] - b[None, :, :]).sum(-1)
    af, bf = a.astype(np.float32), b.astype(np.float32)
    assert np.array_equal(af.astype(np.int64), a)
    dist = np.abs(af[:, None, 0] - bf[None, :, 0])
    for k in range(1, 4):
        dist = dist + np.abs(af[:, None, k] - bf[None, :, k])
    assert dist.dtype == np.float32
    assert np.array_equal(dist.astype(np.int64), exact)
    assert exact.max() <= 2 ** 24
    for eps in (0, 1, 300, LIM, 2 ** 23, 2 ** 24 - 1, 2 ** 24, 2 ** 31 - 1):
        epsf = np.float32(min(eps, 2 ** 24))
        assert int((dist <= epsf).sum()) == int((exact <= eps).sum())


def test_fp32_is_not_exact_beyond_the_limit():
    """The pinned counterexample that keeps the int32 branch: 2^24 + 1
    against 0 is 2^24 in float32, a match at eps = 2^24 that int32
    arithmetic (and the plain version) rejects."""
    a = np.array([[2 ** 24 + 1]], np.int32)
    b = np.array([[0]], np.int32)
    assert not fits_model(a).all()
    dist_f = np.abs(a.astype(np.float32) - b.astype(np.float32))[0, 0]
    assert dist_f == np.float32(2 ** 24)
    assert dist_f <= np.float32(2 ** 24)                 # fp32 says match
    assert not abs(int(a[0, 0]) - int(b[0, 0])) <= 2 ** 24   # it is not
    # The plain version counts the pair from eps = 2^24 + 1 on, not at
    # 2^24 (at such eps the pad cells match each other too, alike at both).
    at = torch.from_numpy(ops.pad_cm_np(a, simjoin.SENTINEL))[None]
    bt = torch.from_numpy(ops.pad_cm_np(b, -simjoin.SENTINEL))[None]
    at_limit, past = (int(simjoin.simjoin_block_counts_plain(
        at, bt, eps, False).sum()) for eps in (2 ** 24, 2 ** 24 + 1))
    assert past - at_limit == 1


# ------------------------------- the pair list against the reference

@pytest.mark.parametrize("same", [False, True])
def test_unordered_lists_with_pads_match_pallas(same):
    """Rows out of block_i order, pad rows mid-list and (self-join) a row
    below the diagonal: the port's plain version, the wrapper on CPU
    tensors and ``ops`` equal the Pallas kernel in interpret mode."""
    pytest.importorskip("jax")
    import repro.core  # noqa: F401  (resolves the reference's imports)
    import jax.numpy as jnp
    from repro.kernels.simjoin import ops as jops
    from repro.kernels.simjoin.simjoin import \
        simjoin_pruned_block_counts as pallas_pruned
    rng = np.random.default_rng(4 + same)
    at, bt, a_s, b_s = sorted_padded(rng, 600, same)
    eps = 40
    live, _ = prune.build_block_pairs(a_s, b_s, simjoin.BLOCK, eps, same)
    nab, nbb = at.shape[1] // simjoin.BLOCK, bt.shape[1] // simjoin.BLOCK
    pairs = unordered_list(rng, live, nab, nbb, same)
    assert not np.all(np.diff(pairs[pairs[:, 2] != 0, 0]) >= 0)
    assert (pairs[1:-1, 2] == 0).any()
    want = np.asarray(pallas_pruned(jnp.asarray(at), jnp.asarray(bt),
                                    jnp.asarray(pairs), eps, same,
                                    interpret=True))[:, 0]
    a_t, b_t = torch.from_numpy(at)[None], torch.from_numpy(bt)[None]
    p_t = torch.from_numpy(pairs)[None]
    got = simjoin.simjoin_pruned_block_counts_plain(a_t, b_t, p_t, eps, same)
    np.testing.assert_array_equal(got[0].numpy(), want)
    np.testing.assert_array_equal(simjoin.simjoin_pruned_block_counts(
        a_t, b_t, p_t, eps, same)[0].numpy(), want)
    total = int(ops.count_similar_pairs_pruned(at, bt, pairs, eps, same,
                                               device=CPU))
    assert total == int(want.sum()) == int(jops.count_similar_pairs_pruned(
        jnp.asarray(at), jnp.asarray(bt), jnp.asarray(pairs), eps, same))
    assert total > 0
    if same:
        assert want[(pairs[:, 0] > pairs[:, 1]) & (pairs[:, 2] != 0)].sum() \
            == 0


# --------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.cuda
def test_edge_cases_on_card():
    """chip_smoke.py's phase 3 edge sweep: both kernels equal their plain
    versions bit for bit."""
    dev = _card()
    n_cases, max_err = _chip_smoke().phase_edges(dev)
    assert n_cases > 0 and max_err == 0


@pytest.mark.cuda
def test_wrappers_capture_in_cuda_graph():
    """Neither wrapper reads the card on its kernel path: both capture in
    one CUDA graph, and the replay equals the plain versions."""
    dev = _card()
    rng = np.random.default_rng(6)
    at, bt, a_s, b_s = sorted_padded(rng, 900, True)
    live, _ = prune.build_block_pairs(a_s, b_s, simjoin.BLOCK, 40, True)
    pairs = unordered_list(rng, live, at.shape[1] // simjoin.BLOCK,
                           bt.shape[1] // simjoin.BLOCK, True)
    a, b, p = (torch.from_numpy(x)[None].to(dev) for x in (at, bt, pairs))
    simjoin.simjoin_block_counts(a, b, 40, True)          # build, warm up
    simjoin.simjoin_pruned_block_counts(a, b, p, 40, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dense = simjoin.simjoin_block_counts(a, b, 40, True)
        listed = simjoin.simjoin_pruned_block_counts(a, b, p, 40, True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(dense, simjoin.simjoin_block_counts_plain(a, b, 40,
                                                                 True))
    assert torch.equal(listed, simjoin.simjoin_pruned_block_counts_plain(
        a, b, p, 40, True))


@pytest.mark.cuda
def test_out_of_grid_row_traps_in_a_child_process():
    """A live row outside the grid that reaches the kernel traps it; run
    in a child process, whose CUDA context the trap ends."""
    _card()
    code = (
        "import torch\n"
        "from repro_torch.kernels.simjoin import simjoin\n"
        "a = torch.zeros((1, 3, 256), dtype=torch.int32, device='cuda')\n"
        "p = torch.tensor([[[0, 0, 1], [0, 5, 1]]], dtype=torch.int32,\n"
        "                 device='cuda')\n"
        "out = simjoin.simjoin_pruned_block_counts(a, a, p, 1, False)\n"
        "torch.cuda.synchronize()\n"
        "print('no trap', out.tolist())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert done.returncode != 0, done.stdout
    assert "no trap" not in done.stdout
