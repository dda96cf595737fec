"""The port's SSM blocks (``repro_torch.models.ssm``) against the
reference's ``repro.models.ssm`` on the CPU, from the same parameters
(the reference's ``init_params`` at ``reduced`` size, converted with
``params_from_numpy``) and numpy-seeded inputs: Mamba (forward at S not
a multiple of the 128-position chunk, so the padding runs, and decode
steps from the forward's state), mLSTM (sequential and chunkwise, each
against the reference and against each other, and decode), sLSTM
(forward and decode), and whole-model decode from a mid-sequence state
carried over from the reference.

Tolerances: fp32 1e-4 and bf16 5e-2, as tests/test_torch_models.py.
The Mamba scan sums in another tree order than the reference's
``associative_scan`` (see ``ssm._doubling_scan``); fp32 1e-4 holds. A
whole Mamba model's fp32 decode gets 1e-2, as in
tests/test_torch_models.py: both sides keep the conv window in bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (resolves the reference's import cycle)
from repro.configs import get as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import (decode_state_from_numpy,  # noqa: E402
                                        params_from_numpy)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
MAMBA_FP32_DECODE_TOL = 1e-2
JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-125m"
B = 2


def f32(x):
    """A jnp / torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def close(got, want, tol, what=""):
    """Every leaf of two matching tuples / dicts within ``tol``."""
    if isinstance(want, dict):
        got, want = [got[k] for k in sorted(want)], [want[k] for k in
                                                     sorted(want)]
    if not isinstance(want, (list, tuple)):
        got, want = [got], [want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.isfinite(f32(g)).all(), (what, i)
        np.testing.assert_allclose(f32(g), f32(w), rtol=tol, atol=tol,
                                   err_msg=f"{what} {i}")


def block(arch, dtype, index):
    """(reference cfg, port cfg, reference mixer params, port mixer
    params) of layer ``index`` (period 0) of the reduced arch."""
    jcfg, tcfg = jreduced(jget(arch)), reduced(get(arch))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0),
                            dtype=DTYPES[dtype][0])
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    jmix = jax.tree.map(lambda a: a[0], jp["blocks"][f"b{index}"]["mixer"])
    return jcfg, tcfg, jmix, tp["layers"][index]["mixer"]


def x_input(s, d, dtype, seed=1):
    """(jnp, torch) (B, s, d) activations of one numpy draw."""
    x = np.random.default_rng(seed).standard_normal((B, s, d), np.float32)
    return (jnp.asarray(x).astype(DTYPES[dtype][0]),
            torch.from_numpy(x).to(DTYPES[dtype][1]))


def as_port(tree):
    """A reference state (dict or tuple of arrays) as tensors in their
    own dtype."""
    conv = lambda a: torch.from_numpy(f32(a).copy()).to(  # noqa: E731
        torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32)
    if isinstance(tree, dict):
        return {k: conv(v) for k, v in tree.items()}
    return tuple(conv(v) for v in tree)


# ------------------------------------------------------------------ Mamba


@pytest.mark.parametrize("seq", [16, 128, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_forward_matches(dtype, seq):
    """Output, final h and conv window; S = 16 and 200 pad the last
    chunk."""
    jcfg, tcfg, jmix, tmix = block(JAMBA, dtype, 0)
    xj, xt = x_input(seq, tcfg.d_model, dtype)
    want, jst = jssm.mamba_forward(jmix, xj, jcfg)
    got, tst = tssm.mamba_forward(tmix, xt, tcfg)
    assert got.dtype == DTYPES[dtype][1] and tst["h"].dtype == torch.float32
    tol = DTYPES[dtype][2]
    close(got, want, tol, "y")
    close(tst, jst, 1e-4 if dtype == "float32" else tol, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_step_matches(dtype):
    """Decode steps from the state a 40-position forward leaves, each
    against the reference's step from the same state."""
    jcfg, tcfg, jmix, tmix = block(JAMBA, dtype, 2)
    xj, xt = x_input(46, tcfg.d_model, dtype, seed=2)
    _, jst = jssm.mamba_forward(jmix, xj[:, :40], jcfg)
    tst = as_port(jst)
    for t in range(40, 46):
        want, jst = jssm.mamba_step(jmix, xj[:, t:t + 1], jst, jcfg)
        got, tst = tssm.mamba_step(tmix, xt[:, t:t + 1], tst, tcfg)
        close(got, want, DTYPES[dtype][2], f"y {t}")
        close(tst, jst, 1e-4 if dtype == "float32" else 5e-2, f"state {t}")


def test_doubling_scan_is_the_recurrence():
    """The chunk scan equals the step-by-step h_t = a_t h_{t-1} + b_t from
    a zero state, and the decay products, for decays from 1 down to
    underflow (dt |A| from 0 to 100)."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(np.exp(-rng.uniform(0, 100, (2, 128, 3, 4))
                                ).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 128, 3, 4), np.float32))
    a_cum, b_cum = tssm._doubling_scan(a, b)
    h, prod = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(128):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        np.testing.assert_allclose(b_cum[:, t].numpy(), h.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(a_cum[:, t].numpy(), prod.numpy(),
                                   rtol=1e-5, atol=1e-30)


# ------------------------------------------------------------------ mLSTM


@pytest.mark.parametrize("seq", [50, 130])
@pytest.mark.parametrize("impl", ["sequential", "chunkwise"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_forward_matches(dtype, impl, seq):
    """Each form against the reference's same form, and the final (C, n,
    m); S = 50 and 130 pad the 64-position chunk."""
    jcfg, tcfg, jmix, tmix = block(XLSTM, dtype, 0)
    xj, xt = x_input(seq, tcfg.d_model, dtype)
    want, jst = jssm.mlstm_forward(jmix, xj, jcfg, impl=impl)
    got, tst = tssm.mlstm_forward(tmix, xt, tcfg, impl=impl)
    close(got, want, DTYPES[dtype][2], "y")
    close(tst, jst, 1e-4 if dtype == "float32" else 5e-2, "state")


@pytest.mark.parametrize("seq", [50, 130, 256])
def test_mlstm_forms_agree(seq):
    """The port's chunkwise form against its sequential recurrence (fp32),
    outputs and final state, with the stabilizer starting at -1e30."""
    _, tcfg, _, tmix = block(XLSTM, "float32", 1)
    _, xt = x_input(seq, tcfg.d_model, "float32", seed=4)
    seq_y, seq_st = tssm.mlstm_forward(tmix, xt, tcfg, impl="sequential")
    chk_y, chk_st = tssm.mlstm_forward(tmix, xt, tcfg, impl="chunkwise")
    auto_y, _ = tssm.mlstm_forward(tmix, xt, tcfg)
    close(chk_y, seq_y, 1e-4, "y")
    close(chk_st, seq_st, 1e-4, "state")
    assert torch.equal(auto_y, chk_y if seq >= 128 else seq_y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_step_matches(dtype):
    """Decode steps from the state a chunkwise forward leaves, and from
    the fresh state (m = -1e30), against the reference's."""
    jcfg, tcfg, jmix, tmix = block(XLSTM, dtype, 2)
    xj, xt = x_input(134, tcfg.d_model, dtype, seed=5)
    _, jst = jssm.mlstm_forward(jmix, xj[:, :130], jcfg)
    for jstate in (jst, jssm.init_mlstm_state(jcfg, B)):
        tst = as_port(jstate)
        for t in range(130, 134):
            want, jstate = jssm.mlstm_step(jmix, xj[:, t:t + 1], jstate,
                                           jcfg)
            got, tst = tssm.mlstm_step(tmix, xt[:, t:t + 1], tst, tcfg)
            close(got, want, DTYPES[dtype][2], f"y {t}")
            close(tst, jstate, 1e-4 if dtype == "float32" else 5e-2,
                  f"state {t}")


# ------------------------------------------------------------------ sLSTM


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_and_step_match(dtype):
    """The forward (output and final (c, n, m, h)), then decode steps
    from that state."""
    jcfg, tcfg, jmix, tmix = block(XLSTM, dtype, 3)
    xj, xt = x_input(36, tcfg.d_model, dtype, seed=6)
    tol = DTYPES[dtype][2]
    want, jst = jssm.slstm_forward(jmix, xj[:, :32], jcfg)
    got, tst = tssm.slstm_forward(tmix, xt[:, :32], tcfg)
    close(got, want, tol, "y")
    close(tst, jst, 1e-4 if dtype == "float32" else tol, "state")
    for t in range(32, 36):
        want, jst = jssm.slstm_step(jmix, xj[:, t:t + 1], jst, jcfg)
        got, tst = tssm.slstm_step(tmix, xt[:, t:t + 1], tst, tcfg)
        close(got, want, tol, f"y {t}")
        close(tst, jst, 1e-4 if dtype == "float32" else tol, f"state {t}")


# ------------------------------------------------------------ whole model


@pytest.mark.parametrize("arch", [XLSTM, JAMBA])
def test_decode_from_carried_state(arch):
    """The reference decodes 5 tokens; its decode state, carried across
    with ``decode_state_from_numpy``, lets the port decode the next 3 as
    the reference does (fp32 logits and every state tensor)."""
    jcfg, tcfg = jreduced(jget(arch)), reduced(get(arch))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(9).integers(0, tcfg.vocab_size, (B, 8))
    jstep = jax.jit(lambda p, t, st, pos: jmodel.decode_step(p, jcfg, t, st,
                                                             pos))
    jstate = jmodel.init_decode_state(jcfg, B, 8)
    for t in range(5):
        _, jstate = jstep(jp, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                          jstate, jnp.full((B,), t, jnp.int32))
    tstate = decode_state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    assert [sorted(st) for st in tstate] == \
        [sorted(st) for st in tmodel.init_decode_state(tcfg, B, 8,
                                                       device="cpu")]
    tol = MAMBA_FP32_DECODE_TOL if tcfg.mamba else 1e-4
    for t in range(5, 8):
        want, jstate = jstep(jp, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                             jstate, jnp.full((B,), t, jnp.int32))
        got, tstate = tmodel.decode_step(
            tp, tcfg, torch.from_numpy(toks[:, t:t + 1]), tstate,
            torch.full((B,), t, dtype=torch.int32))
        close(got, want, tol, f"logits {t}")
    want = decode_state_from_numpy(tcfg, jax.tree.map(np.asarray, jstate),
                                   device="cpu")
    for layer, (g, w) in enumerate(zip(tstate, want)):
        for k in w:
            assert g[k].dtype == w[k].dtype, (layer, k)
            # bf16 caches and conv windows: one bf16 ulp at a rounding
            # boundary (see the module docstring).
            rtol = 2 ** -7 if w[k].dtype == torch.bfloat16 else tol
            np.testing.assert_allclose(f32(g[k]), f32(w[k]), rtol=rtol,
                                       atol=tol, err_msg=f"{layer} {k}")
