"""The port's simjoin entry points against the JAX package's, on the same
numpy inputs: every ``ops`` entry point, the per-block-pair grids of the
plain versions against the Pallas kernels in interpret mode, and the
wrappers' checks. The CUDA kernels themselves run only on the card
(``chip_smoke.py`` phase 3, and the ``cuda``-marked test below)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.simjoin import ops as jops  # noqa: E402
from repro.kernels.simjoin import prune as jprune  # noqa: E402
from repro.kernels.simjoin.ref import count_pairs_ref as jref  # noqa: E402
from repro.kernels.simjoin.simjoin import (  # noqa: E402
    simjoin_block_counts as pallas_dense,
    simjoin_pruned_block_counts as pallas_pruned)
from repro_torch.kernels.simjoin import ops, prune, simjoin  # noqa: E402
from repro_torch.kernels.simjoin.ref import count_pairs_ref  # noqa: E402

CPU = "cpu"


def rand_coords(rng, n, d, hi=200):
    return rng.integers(0, hi, size=(n, d)).astype(np.int32)


def clustered_coords(rng, n, d, n_clusters=6, domain=50_000, spread=30):
    centers = rng.integers(0, domain, (n_clusters, d))
    pick = rng.integers(0, n_clusters, n)
    return (centers[pick] + rng.integers(-spread, spread + 1,
                                         (n, d))).astype(np.int32)


# ---------------------------------------------------- dense entry points

@pytest.mark.parametrize("n,m", [(1, 1), (7, 13), (128, 128), (130, 255),
                                 (300, 41), (1024, 77)])
@pytest.mark.parametrize("d", [2, 3])
def test_cross_join_matches_jax(n, m, d):
    rng = np.random.default_rng(n * 1000 + m + d)
    a = rand_coords(rng, n, d, hi=60)
    b = rand_coords(rng, m, d, hi=60)
    for eps in (0, 1, 3):
        got = ops.count_similar_pairs(a, b, eps, False, device=CPU)
        want = jops.count_similar_pairs(jnp.asarray(a), jnp.asarray(b), eps,
                                        False)
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == int(want) == int(count_pairs_ref(
            torch.from_numpy(a), torch.from_numpy(b), eps, False)), \
            (n, m, d, eps)


@pytest.mark.parametrize("n", [1, 5, 129, 384, 1000])
def test_self_join_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rand_coords(rng, n, 3, hi=40)
    for eps in (1, 2):
        got = int(ops.count_similar_pairs(a, a, eps, True, device=CPU))
        assert got == int(jops.count_similar_pairs(
            jnp.asarray(a), jnp.asarray(a), eps, True))
        assert got == int(jref(jnp.asarray(a), jnp.asarray(a), eps, True))


@pytest.mark.parametrize("same", [False, True])
def test_np_entry_point_and_large_coords(same):
    """``count_similar_pairs_np`` on int64 file coordinates up to the PTF
    time axis (153064), cast to int32 where the reference casts them."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 153_065, size=(200, 3)).astype(np.int64)
    b = a if same else rng.integers(0, 153_065, size=(150, 3))
    for eps in (1000, 30_000):
        got = ops.count_similar_pairs_np(a, b, eps, same, device=CPU)
        assert isinstance(got, int)
        assert got == jops.count_similar_pairs_np(a, b, eps, same)
    empty = np.zeros((0, 3), np.int64)
    assert ops.count_similar_pairs_np(empty, b, 5, False, device=CPU) == 0
    assert jops.count_similar_pairs_np(empty, b, 5, False) == 0


@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 300])
def test_pad_cm_np_matches_jax(n):
    rng = np.random.default_rng(n)
    x = rng.integers(-500, 500, size=(n, 3)).astype(np.int64)
    for sentinel in (simjoin.SENTINEL, -simjoin.SENTINEL):
        got = ops.pad_cm_np(x, sentinel)
        want = jops.pad_cm_np(x, sentinel)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        # The on-device padding helper agrees with the host one.
        np.testing.assert_array_equal(
            ops._pad_cm(torch.from_numpy(x), sentinel).numpy(), got)


def test_batch_matches_jax():
    rng = np.random.default_rng(5)
    # One shape bucket: every side pads to 384 cells.
    sides = [clustered_coords(rng, int(rng.integers(257, 385)), 3)
             for _ in range(6)]
    for same in (False, True):
        bs = sides if same else sides[::-1]
        a = np.stack([ops.pad_cm_np(x, simjoin.SENTINEL) for x in sides])
        b = np.stack([ops.pad_cm_np(x, -simjoin.SENTINEL) for x in bs])
        for eps in (0, 40):
            got = ops.count_similar_pairs_batch(a, b, eps, same, device=CPU)
            want = jops.count_similar_pairs_batch(jnp.asarray(a),
                                                  jnp.asarray(b), eps, same)
            assert got.dtype == torch.int32 and got.shape == (6,)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -------------------------------------------------- pruned entry points

@pytest.mark.parametrize("n,m", [(1, 1), (130, 255), (300, 41), (1024, 77)])
@pytest.mark.parametrize("maker", [rand_coords, clustered_coords])
def test_pruned_np_matches_jax(n, m, maker):
    rng = np.random.default_rng(n * 1000 + m)
    a = maker(rng, n, 3)
    b = maker(rng, m, 3)
    for eps in (0, 50):
        got = ops.count_similar_pairs_pruned_np(a, b, eps, False, device=CPU)
        want = jops.count_similar_pairs_pruned_np(a, b, eps, False)
        assert got == want, (n, m, eps, maker.__name__)
    got = ops.count_similar_pairs_pruned_np(a, a, 2, True, device=CPU)
    assert got == jops.count_similar_pairs_pruned_np(a, a, 2, True)


def test_duplicate_coords_self_join_eps0():
    base = np.array([[10, 10], [10, 10], [10, 10], [99, 1]], np.int32)
    a = np.repeat(base, 80, axis=0)          # 320 cells, 3 blocks
    got = ops.count_similar_pairs_pruned_np(a, a, 0, True, device=CPU)
    assert got == jops.count_similar_pairs_pruned_np(a, a, 0, True)
    assert got[0] == int(count_pairs_ref(torch.from_numpy(a),
                                         torch.from_numpy(a), 0, True))


def _pruned_inputs(rng, same, eps, refine):
    """Sorted, padded sides and a padded pair list built the way the
    executor builds them (bbox prune, optional bitmap refinement, pad)."""
    a = prune.spatial_sort(clustered_coords(rng, 700, 3))
    b = a if same else prune.spatial_sort(clustered_coords(rng, 500, 3))
    pairs, _ = jprune.build_block_pairs(a, b, simjoin.BLOCK, eps, same)
    if refine:
        scale = jprune.bitmap_scale(eps)
        bm_a = jprune.build_bitmaps(a, simjoin.BLOCK, scale)
        bm_b = bm_a if same else jprune.build_bitmaps(b, simjoin.BLOCK,
                                                       scale)
        pairs, _ = jprune.refine_block_pairs(pairs, bm_a, bm_b, eps, scale)
    pairs = jprune.pad_pairs(pairs, jprune.padded_pair_len(pairs.shape[0]))
    return (ops.pad_cm_np(a, simjoin.SENTINEL),
            ops.pad_cm_np(b, -simjoin.SENTINEL), pairs)


@pytest.mark.parametrize("refine", [False, True])
@pytest.mark.parametrize("same", [False, True])
def test_pruned_and_batch_match_jax(same, refine):
    rng = np.random.default_rng(11 + same + 2 * refine)
    at, bt, pairs = _pruned_inputs(rng, same, 40, refine)
    assert (pairs[:, 2] == 0).any()           # pad rows present
    got = ops.count_similar_pairs_pruned(at, bt, pairs, 40, same,
                                         device=CPU)
    want = jops.count_similar_pairs_pruned(
        jnp.asarray(at), jnp.asarray(bt), jnp.asarray(pairs), 40, same)
    assert got.dtype == torch.int32 and int(got) == int(want)
    k = 3
    got_b = ops.count_similar_pairs_pruned_batch(
        np.stack([at] * k), np.stack([bt] * k), np.stack([pairs] * k), 40,
        same, device=CPU)
    want_b = jops.count_similar_pairs_pruned_batch(
        jnp.asarray(np.stack([at] * k)), jnp.asarray(np.stack([bt] * k)),
        jnp.asarray(np.stack([pairs] * k)), 40, same)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


# ------------------------------------- per-block-pair grids vs Pallas

@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("eps", [0, 1, 300])
def test_plain_grids_match_pallas_grids(eps, same):
    rng = np.random.default_rng(eps + 7 * same)
    a = rng.integers(0, 2000, size=(300, 2))
    b = a if same else rng.integers(0, 2000, size=(200, 2))
    at = ops.pad_cm_np(a, simjoin.SENTINEL)
    bt = ops.pad_cm_np(b, -simjoin.SENTINEL)
    got = simjoin.simjoin_block_counts_plain(
        torch.from_numpy(at)[None], torch.from_numpy(bt)[None], eps, same)
    want = pallas_dense(jnp.asarray(at), jnp.asarray(bt), eps, same,
                        interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    pairs = jprune.pad_pairs(
        jprune.build_block_pairs(prune.spatial_sort(a),
                                 prune.spatial_sort(b), simjoin.BLOCK,
                                 eps, same)[0], 8)
    got_p = simjoin.simjoin_pruned_block_counts_plain(
        torch.from_numpy(at)[None], torch.from_numpy(bt)[None],
        torch.from_numpy(pairs)[None], eps, same)
    want_p = pallas_pruned(jnp.asarray(at), jnp.asarray(bt),
                           jnp.asarray(pairs), eps, same, interpret=True)
    np.testing.assert_array_equal(got_p[0].numpy(), np.asarray(want_p)[:, 0])


def test_plain_slicing_is_invisible(monkeypatch):
    """The plain versions' memory-bounding slices (over tasks, block
    rows and pair rows) do not change a single count."""
    rng = np.random.default_rng(2)
    sides = [rng.integers(0, 300, size=(int(rng.integers(200, 384)), 3))
             for _ in range(3)]
    a = torch.from_numpy(np.stack([ops.pad_cm_np(x, simjoin.SENTINEL)
                                   for x in sides]))
    b = torch.from_numpy(np.stack([ops.pad_cm_np(x, -simjoin.SENTINEL)
                                   for x in sides]))
    pairs = torch.tensor([[[0, 0, 1], [1, 2, 1], [2, 1, 1], [0, 0, 0]]] * 3,
                         dtype=torch.int32)
    whole = simjoin.simjoin_block_counts_plain(a, b, 25, True)
    whole_p = simjoin.simjoin_pruned_block_counts_plain(a, b, pairs, 25,
                                                        True)
    monkeypatch.setattr(simjoin, "_PLAIN_STEP_ELEMS", 128 * 128)
    assert torch.equal(simjoin.simjoin_block_counts_plain(a, b, 25, True),
                       whole)
    assert torch.equal(simjoin.simjoin_pruned_block_counts_plain(
        a, b, pairs, 25, True), whole_p)
    assert int(whole_p[:, 3].abs().sum()) == 0      # pad rows count 0


# ------------------------------------------------------ wrapper checks

def test_wrapper_checks():
    launches = dict(simjoin.LAUNCHES)
    a = torch.zeros((1, 3, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown impl"):
        simjoin.simjoin_block_counts(a, a, 1, False, impl="triton")
    with pytest.raises(TypeError, match="int32"):
        simjoin.simjoin_block_counts(a.long(), a.long(), 1, False)
    with pytest.raises(ValueError, match="multiple of 128"):
        simjoin.simjoin_block_counts(a[..., :100], a, 1, False)
    with pytest.raises(ValueError, match="outside the grid"):
        simjoin.simjoin_pruned_block_counts(
            a, a, torch.tensor([[[0, 1, 1]]], dtype=torch.int32), 1, False)
    with pytest.raises(ValueError, match="empty pair list"):
        simjoin.simjoin_pruned_block_counts(
            a, a, torch.zeros((1, 0, 3), dtype=torch.int32), 1, False)
    # An out-of-range pad row is never read.
    got = simjoin.simjoin_pruned_block_counts(
        a, a, torch.tensor([[[0, 0, 1], [9, 9, 0]]], dtype=torch.int32), 0,
        False)
    assert got.tolist() == [[128 * 128, 0]]
    # The plain version ran: no kernel launch was counted.
    assert simjoin.LAUNCHES == launches


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.count_similar_pairs_np(np.ones((2, 2)), np.ones((2, 2)), 1,
                                   False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ops.resolve_device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both CUDA kernels against their plain versions on the card, bit
    for bit (runs only where ``torch.cuda.is_available()``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for same in (False, True):
        at, bt, pairs = _pruned_inputs(rng, same, 40, refine=True)
        a = torch.from_numpy(at)[None].to(dev)
        b = torch.from_numpy(bt)[None].to(dev)
        p = torch.from_numpy(pairs)[None].to(dev)
        before = dict(simjoin.LAUNCHES)
        assert torch.equal(simjoin.simjoin_block_counts(a, b, 40, same),
                           simjoin.simjoin_block_counts_plain(a, b, 40, same))
        assert torch.equal(
            simjoin.simjoin_pruned_block_counts(a, b, p, 40, same),
            simjoin.simjoin_pruned_block_counts_plain(a, b, p, 40, same))
        assert all(simjoin.LAUNCHES[k] == before[k] + 1 for k in before)
