"""The port's flash and paged attention (plain versions on the CPU)
against the reference's Pallas kernels in interpret mode and its jnp
oracles, on the sweeps of tests/test_kernels_{flash,paged}.py, from the
same numpy-seeded inputs. Tolerances are the reference tests' own: fp32
2e-5; bf16 2e-2 (flash) and 3e-2 (paged). The CUDA kernels themselves
(forward and backward) are checked on the card by the ``cuda``-marked
tests (and chip_smoke.py), which import nothing of JAX: ``python -m pytest -m cuda
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
from repro_torch.models import layers as tlayers  # noqa: E402
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


# The head dims of hubert-xlarge (1280 / 16 = 80) and nemotron-4-340b
# (18432 / 96 = 192), which the CUDA kernels take beside 32, 64 and 128.
NEW_HEAD_DIMS = (80, 192)


@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
@pytest.mark.parametrize("h,hk", [(4, 4), (24, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_new_head_dims_match_pallas(J, d, h, hk, causal):
    """The plain version against the reference's Pallas
    ``flash_attention_fwd`` (interpret mode) at head dims 80 and 192:
    MHA and a GQA group of 12, causal and not."""
    qkv = [heads_first(x) for x in make_qkv(50 + d, 1, 128, 128, h, hk, d)]
    got = tflash.flash_attention_fwd(*(tt(x) for x in qkv), causal=causal,
                                     bq=64, bk=64)
    want = J.flash_fwd(*(J.arr(x) for x in qkv), causal=causal, bq=64,
                       bk=64)
    np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5, atol=2e-5)


def test_every_attention_head_dim_has_a_kernel():
    """Every architecture with an attention mixer has a head dim that both
    CUDA wrappers take, so none of them falls outside the kernels on the
    card."""
    from repro_torch.configs import get, list_archs
    dims = {a: get(a).resolved_head_dim for a in list_archs()
            if get(a).uses_attention}
    assert dims, "no attention architecture"
    missing = {a: d for a, d in dims.items()
               if d not in tflash.HEAD_DIMS or d not in tpaged.HEAD_DIMS}
    assert not missing, f"head dims without a kernel: {missing}"


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


# --------------------------------------------------------- flash backward
#
# Tolerances of the gradients, relative to each gradient's largest
# magnitude: fp32 1e-4 (sums in other orders), bf16 5e-2, the bf16 slack
# of tests/test_torch_models.py (the reference's bf16 logits product
# rounds its scores to bf16 before the fp32 softmax; the port's plain
# versions and kernels keep them fp32).
GRAD_TOLS = {"float32": 1e-4, "bfloat16": 5e-2}


def assert_grads_close(got, want, tol, what=""):
    """Each pair within ``tol`` x the reference gradient's max |g|."""
    for name, g, w in zip("qkv", got, want):
        g, w = f32(g), f32(w)
        scale = max(float(np.abs(w).max()), 1e-6)
        err = float(np.abs(g - w).max())
        assert err <= tol * scale, (f"{what} d{name}: max err {err} > "
                                    f"{tol} x {scale}")


def jax_blockwise_vjp(qkv, dout, causal, dtype):
    """(dq, dk, dv) of the reference's ``_blockwise_attention`` (its
    custom VJP ``_blockwise_bwd``) over expanded KV heads, by
    ``jax.vjp``, in the model's (B, S, H, D) layout."""
    jax = pytest.importorskip("jax")
    import repro.core  # noqa: F401  (the reference's import order)
    from repro.models import attention as jattn
    h = qkv[0].shape[2]
    jd = getattr(jax.numpy, dtype)
    q, k, v = (jax.numpy.asarray(x).astype(jd) for x in qkv)

    def fn(q, k, v):
        return jattn._blockwise_attention(
            q, jattn._expand_kv(k, h), jattn._expand_kv(v, h), causal)

    _, vjp = jax.vjp(fn, q, k, v)
    return vjp(jax.numpy.asarray(dout).astype(jd))


BWD_CASES = [  # (b, s, h, hk, d, causal): GQA rep 1 and 3, padded S
    (2, 128, 4, 4, 32, True), (1, 130, 6, 2, 32, True),
    (2, 256, 3, 1, 64, False), (1, 200, 4, 4, 16, False),
    (1, 300, 6, 2, 32, True),
    # head dims 80 (non-causal MHA, as hubert-xlarge) and 192 (causal GQA
    # 12, as nemotron-4-340b), and each the other way
    (1, 128, 4, 4, 80, False), (1, 130, 24, 2, 80, True),
    (1, 130, 24, 2, 192, True), (1, 128, 4, 4, 192, False)]


@pytest.mark.parametrize("b,s,h,hk,d,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_matches_reference(b, s, h, hk, d, causal, dtype):
    """Autograd through the port's blockwise attention (the flash entry
    point's gradient, plain versions on the CPU) against ``jax.vjp`` of
    the reference's custom-VJP blockwise attention."""
    qkv = make_qkv(20 + s, b, s, s, h, hk, d)
    dout = np.random.default_rng(s).standard_normal((b, s, h, d),
                                                    np.float32)
    want = jax_blockwise_vjp(qkv, dout, causal, dtype)
    t = [tt(x, dtype).requires_grad_(True) for x in qkv]
    out = _blockwise_attention(*t, causal, "kernel")
    got = torch.autograd.grad(out, t, tt(dout, dtype))
    for g, x in zip(got, t):
        assert g.dtype == x.dtype and g.shape == x.shape
    assert_grads_close(got, want, GRAD_TOLS[dtype], f"{dtype} {s}")


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (False, 0),
                                             (True, 64)])
@pytest.mark.parametrize("rep", [1, 3])
def test_attention_bwd_ref_matches_autograd(causal, q_offset, rep):
    """``attention_bwd_ref`` from the forward's ``(out, lse)`` equals
    autograd through ``attention_ref`` (heads-first, fp32), and the
    forward's lse is the logsumexp of the masked scores."""
    b, sq, sk, hk, d = 1, 96, 160, 2, 32
    rng = np.random.default_rng(rep)
    q, k, v = (tt(heads_first(x)).requires_grad_(True)
               for x in make_qkv(30 + rep, b, sq, sk, hk * rep, hk, d))
    dout = tt(rng.standard_normal((b, hk * rep, sq, d), np.float32))
    out, lse = tflash.flash_attention_fwd(q, k, v, causal=causal, bq=32,
                                          bk=32, q_offset=q_offset,
                                          return_lse=True)
    assert lse.shape == (b, hk * rep, sq) and lse.dtype == torch.float32
    want = torch.autograd.grad(
        tattention_ref(q, k, v, causal=causal, q_offset=q_offset),
        (q, k, v), dout)
    got = tflash.flash_attention_bwd(q, k, v, out, lse, dout,
                                     causal=causal, q_offset=q_offset)
    assert_grads_close(got, want, 1e-4, f"causal={causal}")
    s = torch.einsum("bhqd,bhkd->bhqk", q.detach(),
                     torch.repeat_interleave(k.detach(), rep, 1)) \
        / np.sqrt(d)
    if causal:
        keep = torch.arange(sk)[None, :] <= torch.arange(sq)[:, None] + \
            q_offset
        s = s.masked_fill(~keep, -1e30)
    np.testing.assert_allclose(f32(lse), f32(torch.logsumexp(s, -1)),
                               rtol=1e-5, atol=1e-5)


def test_flash_backward_contract():
    """The backward's shape checks, and the forward skips the lse (and
    the autograd Function) when no gradient is asked for."""
    q, k, v = (tt(heads_first(x)) for x in make_qkv(40, 1, 64, 64, 2, 1,
                                                      32))
    out, lse = tflash.flash_attention_fwd(q, k, v, bq=32, bk=32,
                                          return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        tflash.flash_attention_bwd(q, k, v, out, lse[:, :1], out)
    with pytest.raises(ValueError, match="dout"):
        tflash.flash_attention_bwd(q, k, v, out, lse, out[:, :, :32])
    qm, km, vm = (x.transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    with torch.no_grad():
        assert tflash_ops.flash_attention(qm, km, vm).grad_fn is None
    assert tflash_ops.flash_attention(qm, km, vm).grad_fn is not None


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


@pytest.mark.parametrize("lens", [[1, 17, 40, 64], [0, 5, 0, 64],
                                  [-3, 63, 33, 16]])
@pytest.mark.parametrize("splits", [1, 2, 3, tpaged.MAX_SPLITS])
def test_paged_split_combine_matches_reference(J, splits, lens):
    """The kernel's split-and-combine arithmetic (plain version) against
    the reference's oracle: ragged lengths, seq_len = 0 and < 0, with
    every split one position at least and with the automatic minimum."""
    inputs = make_paged(8, 4, 8, 2, 32, 64, 16, 4, lens=lens)
    t = [tt(x) for x in inputs]
    want = f32(J.paged_ref(*(J.arr(x) for x in inputs)))
    for min_len in (1, tpaged.MIN_SPLIT_LEN // 4):
        got = tpaged.paged_attention_split_plain(*t, splits, min_len)
        np.testing.assert_allclose(f32(got), want, rtol=2e-5, atol=2e-5)


def test_paged_split_count(monkeypatch):
    """The automatic split fills the card's SMs with clusters of at most
    MAX_SPLITS CTAs and gives each split MIN_SPLIT_LEN positions of the
    table's capacity."""
    monkeypatch.setitem(tpaged._sm_count, 0, 132)
    dev = torch.device("cuda", 0)
    assert tpaged.split_count(1, 8, 512, dev) == tpaged.MAX_SPLITS
    assert tpaged.split_count(4, 8, 512, dev) == 5
    assert tpaged.split_count(4, 8, 2 * tpaged.MIN_SPLIT_LEN, dev) == 2
    assert tpaged.split_count(64, 8, 512, dev) == 1
    n_eff, length = tpaged.split_bounds(torch.tensor([1, 145, 512]), 8, 64)
    assert n_eff.tolist() == [1, 3, 8] and length.tolist() == [1, 49, 64]


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


@pytest.mark.parametrize("d", NEW_HEAD_DIMS)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 3e-2)])
def test_paged_new_head_dims_match_pallas(J, d, dtype, tol):
    """The paged wrapper (plain version) and its split arithmetic against
    the reference's Pallas ``paged_attention`` at head dims 80 and 192,
    a GQA group of 12, ragged lengths."""
    inputs = make_paged(60 + d, 3, 24, 2, d, 32, 16, 4, lens=[1, 40, 64])
    got = check_paged(J, inputs, tol, dtype)
    split = tpaged.paged_attention_split_plain(
        *(tt(x, dtype) for x in inputs), tpaged.MAX_SPLITS, 1)
    np.testing.assert_allclose(f32(split), f32(got), rtol=tol, atol=tol)


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
    """The CUDA flash kernel equals its plain version on the card, and a
    gradient through the blockwise path runs the backward kernel and
    equals the plain version's."""
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
    # The gradient through the kernel: one forward and one backward launch.
    t = [x.clone().requires_grad_(True) for x in t]
    dout = torch.randn_like(t[0])
    before_bwd = tflash.LAUNCHES["flash_attention_bwd"]
    got = torch.autograd.grad(_blockwise_attention(*t, True, "kernel"), t,
                              dout)
    want = torch.autograd.grad(_blockwise_attention(*t, True, "plain"), t,
                               dout)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention_bwd"] == before_bwd + 1
    assert_grads_close(got, want, GRAD_TOLS["bfloat16"])


@pytest.mark.cuda
def test_paged_kernel_on_card():
    """The CUDA paged kernel equals its plain version on the card,
    seq_len = 0 included, at head dim 128 and at 80 and 192 with a GQA
    group of 12 (two CTAs of query heads a KV head), at every split
    count; an out-of-pool table entry raises."""
    _need_card()
    for h, hk, d in ((24, 8, 128), (24, 2, 80), (24, 2, 192)):
        for dtype, tol in (("float32", 2e-5), ("bfloat16", 3e-2)):
            t = [tt(x, dtype).cuda()
                 for x in make_paged(7, 4, h, hk, d, 64, 16, 4,
                                     lens=[0, 1, 33, 64])]
            want = tpaged.paged_attention(*t, impl="plain")
            for got in [tpaged.paged_attention(*t)] + [
                    _launch_split(t, n)
                    for n in range(1, tpaged.MAX_SPLITS + 1)]:
                torch.cuda.synchronize()
                np.testing.assert_allclose(f32(got), f32(want), rtol=tol,
                                           atol=tol, err_msg=f"D{d}")
    t[3][0, 0] = 64
    with pytest.raises(ValueError, match="outside"):
        tpaged.paged_attention(*t)


@pytest.mark.cuda
@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
def test_flash_bf16_kernel_on_card(d):
    """The wgmma/TMA bf16 kernel against its plain version at every head
    dim: causal GQA, ragged Sk (non-causal, Sq and Sk off the tile
    sizes), q_offset = 192, and bq / bk that do not change the result."""
    _need_card()
    tol = 2e-2
    cases = [(2, 256, 256, 8, 2, True, 0), (1, 130, 200, 3, 1, False, 0),
             (1, 64, 256, 2, 2, True, 192), (2, 384, 384, 4, 4, True, 0)]
    for b, sq, sk, h, hk, causal, off in cases:
        t = [tt(heads_first(x), "bfloat16").cuda()
             for x in make_qkv(9, b, sq, sk, h, hk, d)]
        got = tflash.flash_attention_fwd(*t, causal=causal, bq=1, bk=1,
                                         q_offset=off)
        want = tattention_ref(*t, causal=causal, q_offset=off)
        torch.cuda.synchronize()
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
        other = tflash.flash_attention_fwd(*t, causal=causal, bq=sq,
                                           bk=sk, q_offset=off)
        assert torch.equal(got, other)
    t = [tt(x, "bfloat16").cuda() for x in make_qkv(10, 1, 256, 256, 2, 2,
                                                      d)]
    a = tflash_ops.flash_attention(*t, causal=True, bq=128, bk=128)
    b = tflash_ops.flash_attention(*t, causal=True, bq=64, bk=32)
    np.testing.assert_allclose(f32(a), f32(b), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("d", tflash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_kernel_on_card(d, dtype):
    """The backward kernels against ``attention_bwd_ref`` on the same
    (out, lse), the forward kernels' lse against the plain one, and the
    backward's bits equal from run to run: causal GQA, rep 1 and 3,
    Sq and Sk off the tile size, non-causal, q_offset; and cases across
    the bf16 kernels' tiles (64 keys a dK/dV CTA, 128 query rows a dQ
    CTA, 64-row ring stages): partial key and query tiles on the
    diagonal, several query stages and head switches in one ring, a key
    tile that straddles q_offset."""
    _need_card()
    tol = GRAD_TOLS[dtype]
    for b, sq, sk, h, hk, causal, off in (
            (2, 256, 256, 6, 2, True, 0), (1, 130, 130, 4, 4, True, 0),
            (1, 200, 136, 3, 1, False, 0), (1, 64, 256, 2, 2, True, 192),
            (1, 200, 200, 2, 2, True, 0), (1, 384, 384, 6, 2, True, 0),
            (1, 64, 320, 2, 1, True, 192)):
        rng = np.random.default_rng(sq + d)
        t = [tt(heads_first(x), dtype).cuda()
             for x in make_qkv(sq + d, b, sq, sk, h, hk, d)]
        dout = tt(rng.standard_normal((b, h, sq, d), np.float32),
                  dtype).cuda()
        out, lse = tflash.flash_attention_fwd(*t, causal=causal, bq=1,
                                              bk=1, q_offset=off,
                                              return_lse=True)
        _, lse_plain = tattention_ref(*t, causal=causal, q_offset=off,
                                      return_lse=True)
        np.testing.assert_allclose(f32(lse), f32(lse_plain), rtol=1e-4,
                                   atol=1e-4)
        got = tflash.flash_attention_bwd(*t, out, lse, dout, causal=causal,
                                         q_offset=off)
        again = tflash.flash_attention_bwd(*t, out, lse, dout,
                                           causal=causal, q_offset=off)
        want = tflash.flash_attention_bwd(*t, out, lse, dout, causal=causal,
                                          q_offset=off, impl="plain")
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert_grads_close(got, want, tol, f"D{d} Sq{sq} Sk{sk}")


def _serving_paged(seed, b, lens, dtype="bfloat16"):
    """Inputs of a decode call at the serving slice's shape (24 query /
    8 KV heads of 128, 16-token pages, 32 pages per request) on the
    card."""
    return [tt(x, dtype).cuda()
            for x in make_paged(seed, b, 24, 8, 128, 32 * b, 16, 32,
                                lens=lens)]


def _launch_split(t, n_split):
    """The kernel on contiguous inputs whose table the wrapper has
    checked, with exactly ``n_split`` splits per request (fewer when a
    request has fewer positions than splits)."""
    q, kp, vp, table, lens = t
    return tpaged._launch(tpaged.LIBRARY.load(), q, kp, vp, table,
                          lens.to(torch.int32).contiguous(),
                          torch.empty_like(q), n_split, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,lens", [(1, [145]), (4, [271, 271, 271, 271]),
                                    (4, [0, 1, 200, 512])])
def test_paged_kernel_splits_on_card(b, lens):
    """The split kernel at the serving shapes (B = 1 prompt replay, B = 4
    batched decode, ragged with seq_len = 0): every split count and the
    automatic one agree with the plain version and with the plain
    split-and-combine of the same count."""
    _need_card()
    t = _serving_paged(11, b, lens)
    want = tpaged.paged_attention(*t, impl="plain")
    for splits in (None, 1, 2, 3, tpaged.MAX_SPLITS):
        got = tpaged.paged_attention(*t) if splits is None \
            else _launch_split(t, splits)
        torch.cuda.synchronize()
        np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2,
                                   atol=3e-2)
        if splits is not None:
            split_plain = tpaged.paged_attention_split_plain(*t, splits)
            np.testing.assert_allclose(f32(got), f32(split_plain),
                                       rtol=3e-2, atol=3e-2)
    f = [tt(x).cuda() for x in make_paged(12, b, 24, 8, 128, 32 * b, 16,
                                          32, lens=lens)]
    want = tpaged.paged_attention(*f, impl="plain")
    for splits in (None, 1, 3):
        got = tpaged.paged_attention(*f) if splits is None \
            else _launch_split(f, splits)
        np.testing.assert_allclose(f32(got), f32(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.cuda
def test_paged_kernel_shared_prefix_on_card():
    """Two requests whose tables name the same pages, with equal queries,
    get bit-equal outputs (the combine order is fixed), and repeating a
    call repeats its bits."""
    _need_card()
    q, kp, vp, table, lens = _serving_paged(13, 2, [300, 300])
    q[1] = q[0]
    table[1] = table[0]
    out = tpaged.paged_attention(q, kp, vp, table, lens)
    again = tpaged.paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    assert torch.equal(out[0], out[1]) and torch.equal(out, again)



@pytest.mark.cuda
def test_unembed_gradient_on_card():
    """The card's fp32-logit unembedding (``mm`` with an fp32 output,
    differentiated by ``_Unembed``) against the CPU path's autograd, bf16
    table and activations: logits, dx and dtable within the bf16 slack
    (5e-2 of each one's largest magnitude)."""
    _need_card()
    rng = np.random.default_rng(9)
    table = torch.from_numpy(rng.standard_normal((300, 64), np.float32) /
                             8).to(torch.bfloat16)
    x = torch.from_numpy(rng.standard_normal((2, 5, 64), np.float32)).to(
        torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((2, 5, 300), np.float32))
    res = []
    for dev in ("cpu", "cuda"):
        t = table.to(dev).requires_grad_(True)
        xx = x.to(dev).requires_grad_(True)
        out = tlayers.unembed(t, xx)
        assert out.dtype == torch.float32
        dx, dt = torch.autograd.grad(out, (xx, t), g.to(dev))
        assert dx.dtype == torch.bfloat16 and dt.dtype == torch.bfloat16
        res.append([f32(out), f32(dx), f32(dt)])
    for a, b in zip(*res):
        assert np.abs(a - b).max() <= 5e-2 * np.abs(a).max()
