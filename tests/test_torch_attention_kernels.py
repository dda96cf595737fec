"""The port's flash and paged attention (plain versions on the CPU)
against the reference's Pallas kernels in interpret mode and its jnp
oracles, on the sweeps of tests/test_kernels_{flash,paged}.py, from the
same numpy-seeded inputs. Tolerances are the reference tests' own: fp32
2e-5; bf16 2e-2 (flash) and 3e-2 (paged). The CUDA kernels themselves
are checked on the card by the ``cuda``-marked tests (and chip_smoke.py),
which import nothing of JAX: ``python -m pytest -m cuda
tests/test_torch_attention_kernels.py`` runs them where only the port is
installed.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import flash_attention as tflash  # noqa: E402
from repro_torch.kernels.flash_attention import ops as tflash_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref as tattention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import paged_attention as tpaged  # noqa: E402
from repro_torch.kernels.paged_attention.ops import \
    paged_decode_attention as tpaged_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import \
    paged_attention_ref as tpaged_ref  # noqa: E402
from repro_torch.models.attention import (_blockwise_attention,  # noqa: E402
                                          _naive_attention)

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def J():
    """The reference's kernels and oracles (JAX on the CPU), and a
    numpy -> jnp converter."""
    jax = pytest.importorskip("jax")
    from repro.kernels.flash_attention import ops
    from repro.kernels.flash_attention.flash_attention import \
        flash_attention_fwd
    from repro.kernels.flash_attention.ref import attention_ref
    from repro.kernels.paged_attention.ops import paged_decode_attention
    from repro.kernels.paged_attention.ref import paged_attention_ref

    def arr(x, dtype="float32"):
        a = jax.numpy.asarray(x)
        return a.astype(getattr(jax.numpy, dtype)) if a.dtype.kind == "f" \
            else a
    return SimpleNamespace(arr=arr, flash=ops.flash_attention,
                           flash_fwd=flash_attention_fwd,
                           attention_ref=attention_ref,
                           paged=paged_decode_attention,
                           paged_ref=paged_attention_ref)


def tt(x, dtype="float32"):
    """numpy -> torch tensor, floats cast to the named dtype."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(TORCH_DTYPES[dtype]) if t.is_floating_point() else t


def f32(x):
    """Any jnp / torch array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def heads_first(x):
    """(B, S, H, D) -> (B, H, S, D) for numpy arrays."""
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3))


def make_qkv(seed, b, sq, sk, h, hk, d):
    """(B, S, H, D) model-layout q, k, v as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, sk, hk, d), np.float32),
            rng.standard_normal((b, sk, hk, d), np.float32))


# ------------------------------------------------------------------ flash


@pytest.mark.parametrize("sq,causal", [(128, True), (256, True),
                                       (130, True), (256, False),
                                       (384, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference(J, sq, causal, dtype):
    qkv = make_qkv(0, 2, sq, sq if causal else 256, 4, 4, 64)
    got = tflash_ops.flash_attention(*(tt(x, dtype) for x in qkv),
                                     causal=causal)
    pallas = J.flash(*(J.arr(x, dtype) for x in qkv), causal=causal)
    oracle = J.attention_ref(*(J.arr(heads_first(x), dtype) for x in qkv),
                             causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert got.dtype == TORCH_DTYPES[dtype]
    assert tuple(got.shape) == qkv[0].shape
    np.testing.assert_allclose(f32(got), f32(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(got), f32(oracle).transpose(0, 2, 1, 3),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("h,hk", [(8, 8), (8, 2), (4, 1), (24, 8)])
def test_flash_gqa_ratios(J, h, hk):
    qkv = make_qkv(1, 1, 128, 128, h, hk, 32)
    got = tflash_ops.flash_attention(*(tt(x) for x in qkv), causal=True)
    want = J.flash(*(J.arr(x) for x in qkv), causal=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_flash_block_size_invariance(J):
    qkv = make_qkv(2, 1, 256, 256, 2, 2, 64)
    t = [tt(x) for x in qkv]
    a = tflash_ops.flash_attention(*t, causal=True, bq=128, bk=128)
    b = tflash_ops.flash_attention(*t, causal=True, bq=64, bk=32)
    jb = J.flash(*(J.arr(x) for x in qkv), causal=True, bq=64, bk=32)
    np.testing.assert_allclose(f32(a), f32(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f32(b), f32(jb), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_q_offset_decode_append(J, dtype):
    """Rectangular causal: 64 new queries after 192 cached keys."""
    qkv = [heads_first(x) for x in make_qkv(3, 1, 64, 256, 2, 2, 32)]
    t = [tt(x, dtype) for x in qkv]
    j = [J.arr(x, dtype) for x in qkv]
    got = tflash.flash_attention_fwd(*t, causal=True, bq=64, bk=64,
                                     q_offset=192)
    pallas = J.flash_fwd(*j, causal=True, bq=64, bk=64, q_offset=192)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(f32(got), f32(pallas), rtol=tol, atol=tol)
    np.testing.assert_allclose(
        f32(tattention_ref(*t, causal=True, q_offset=192)),
        f32(J.attention_ref(*j, causal=True, q_offset=192)),
        rtol=tol, atol=tol)


def test_flash_matches_model_attention_path():
    """The flash entry point agrees with the port's naive attention."""
    t = [tt(x) for x in make_qkv(4, 2, 128, 128, 4, 4, 64)]
    got = tflash_ops.flash_attention(*t, causal=True)
    want = _naive_attention(*t, causal=True)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_flash_contract():
    """The reference's contract, kept: non-causal needs Sk % bk == 0,
    the forward needs block multiples; unknown impl and negative
    q_offset raise."""
    qkv = make_qkv(5, 1, 96, 96, 2, 2, 32)
    with pytest.raises(ValueError, match="non-causal"):
        tflash_ops.flash_attention(*(tt(x) for x in qkv), causal=False)
    q4, k4, v4 = (tt(heads_first(x)) for x in qkv)
    with pytest.raises(ValueError, match="Sq % bq"):
        tflash.flash_attention_fwd(q4, k4, v4, bq=128, bk=32)
    with pytest.raises(ValueError, match="q_offset"):
        tflash.flash_attention_fwd(q4, k4, v4, bq=32, bk=32, q_offset=-1)
    with pytest.raises(ValueError, match="unknown impl"):
        tflash.flash_attention_fwd(q4, k4, v4, bq=32, bk=32, impl="pallas")


# ------------------------------------------------------------------ paged


def make_paged(seed, b, h, hk, d, n_pages, page_size, maxp, lens=None):
    """q, pages, a disjoint permuted page table and lengths (numpy)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    kp = rng.standard_normal((n_pages, page_size, hk, d), np.float32)
    vp = rng.standard_normal((n_pages, page_size, hk, d), np.float32)
    table = rng.permutation(n_pages)[:b * maxp].reshape(b, maxp).astype(
        np.int32)
    lens = np.full(b, maxp * page_size, np.int32) if lens is None else \
        np.asarray(lens, np.int32)
    return q, kp, vp, table, lens


def check_paged(J, inputs, tol, dtype="float32"):
    """Port wrapper vs Pallas interpret mode, and the two oracles."""
    t = [tt(x, dtype) for x in inputs]
    j = [J.arr(x, dtype) for x in inputs]
    got = tpaged_ops(*t)
    assert got.dtype == TORCH_DTYPES[dtype]
    assert tuple(got.shape) == inputs[0].shape
    np.testing.assert_allclose(f32(got), f32(J.paged(*j)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(f32(tpaged_ref(*t)), f32(J.paged_ref(*j)),
                               rtol=tol, atol=tol)
    return got


@pytest.mark.parametrize("page_size,maxp", [(16, 4), (32, 2), (8, 8)])
@pytest.mark.parametrize("h,hk", [(4, 4), (8, 2)])
def test_paged_matches_reference(J, page_size, maxp, h, hk):
    check_paged(J, make_paged(0, 3, h, hk, 32, 64, page_size, maxp), 2e-5)


@pytest.mark.parametrize("lens", [[1, 17, 40, 64], [0, 5, 0, 64],
                                  [64, 63, 33, 16]])
def test_paged_ragged_lengths(J, lens):
    """Ragged lengths, seq_len = 0 included (the reference then attends
    uniformly over every position of the row's pages)."""
    check_paged(J, make_paged(1, 4, 4, 4, 32, 64, 16, 4, lens=lens), 2e-5)


def test_paged_shared_prefix_pages(J):
    """Two requests sharing prefix pages: equal queries give equal
    attention."""
    rng = np.random.default_rng(2)
    qrow = rng.standard_normal((1, 4, 32), np.float32)
    q = np.concatenate([qrow, qrow])
    kp = rng.standard_normal((32, 16, 4, 32), np.float32)
    vp = rng.standard_normal((32, 16, 4, 32), np.float32)
    table = np.asarray([[5, 9, 11], [5, 9, 11]], np.int32)
    lens = np.full(2, 48, np.int32)
    out = check_paged(J, (q, kp, vp, table, lens), 2e-5)
    np.testing.assert_allclose(f32(out[0]), f32(out[1]), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("h,hk,d", [(4, 4, 64), (24, 8, 128)])
def test_paged_bfloat16(J, h, hk, d):
    check_paged(J, make_paged(3, 2, h, hk, d, 32, 16, 2), 3e-2, "bfloat16")


def test_paged_contract():
    """Malformed inputs raise before any computation."""
    q, kp, vp, table, lens = (tt(x) for x in make_paged(4, 2, 4, 2, 32, 8,
                                                        8, 2))
    with pytest.raises(ValueError, match="int32 page table"):
        tpaged.paged_attention(q, kp, vp, table.long(), lens)
    with pytest.raises(ValueError, match="seq_lens"):
        tpaged.paged_attention(q, kp, vp, table, lens.float())
    with pytest.raises(ValueError, match="unknown impl"):
        tpaged.paged_attention(q, kp, vp, table, lens, impl="pallas")


def test_paged_table_check_rereads_written_tables(monkeypatch):
    """The launch-side range check reads a table back once, and again
    whenever it was written, replaced, or the pool shrank."""
    reads = []
    real_any = torch.Tensor.any
    monkeypatch.setattr(torch.Tensor, "any",
                        lambda self, *a: reads.append(1) or real_any(self))
    monkeypatch.setattr(tpaged, "_checked", None)
    table = torch.arange(8, dtype=torch.int32).view(2, 4)
    tpaged._check_table(table, 8)
    tpaged._check_table(table, 8)
    tpaged._check_table(table, 16)
    assert len(reads) == 1
    table[1, 3] = 8                      # written: read again, and refused
    with pytest.raises(ValueError, match="outside"):
        tpaged._check_table(table, 8)
    tpaged._check_table(table, 9)
    with pytest.raises(ValueError, match="outside"):
        tpaged._check_table(table, 8)    # a smaller pool than checked
    tpaged._check_table(table.clone(), 9)   # another tensor
    assert len(reads) == 5


# ------------------------------------------------------------ on the card


def _need_card():
    """Skip where there is no card (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc there)")


@pytest.mark.cuda
def test_flash_kernel_on_card():
    """The CUDA flash kernel equals its plain version on the card; a
    gradient through it raises (the backward is the training slice's)."""
    _need_card()
    before = tflash.LAUNCHES["flash_attention_fwd"]
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 2e-2)):
        for causal, sq in ((True, 130), (False, 256)):
            t = [tt(x, dtype).cuda()
                 for x in make_qkv(6, 2, sq, 256, 8, 2, 128)]
            got = tflash_ops.flash_attention(*t, causal=causal)
            want = tflash_ops.flash_attention(*t, causal=causal,
                                              impl="plain")
            torch.cuda.synchronize()
            np.testing.assert_allclose(f32(got), f32(want), rtol=tol,
                                       atol=tol)
    assert tflash.LAUNCHES["flash_attention_fwd"] == before + 4
    # No backward through the kernel yet: asking for one raises.
    q = t[0].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        _blockwise_attention(q, t[1], t[2], True, "kernel")


@pytest.mark.cuda
def test_paged_kernel_on_card():
    """The CUDA paged kernel equals its plain version on the card,
    seq_len = 0 included; an out-of-pool table entry raises."""
    _need_card()
    for dtype, tol in (("float32", 2e-5), ("bfloat16", 3e-2)):
        t = [tt(x, dtype).cuda()
             for x in make_paged(7, 4, 24, 8, 128, 64, 16, 4,
                                 lens=[0, 1, 33, 64])]
        got = tpaged.paged_attention(*t)
        want = tpaged.paged_attention(*t, impl="plain")
        torch.cuda.synchronize()
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    t[3][0, 0] = 64
    with pytest.raises(ValueError, match="outside"):
        tpaged.paged_attention(*t)
