"""The port's model layers, attention and model against the reference's,
on the CPU, from the same parameters: the reference's ``init_params``
pytree converted with ``repro_torch.models.convert.params_from_numpy``
and numpy-seeded inputs, for every attention + dense-MLP architecture at
``reduced`` size.

Tolerances. fp32 parameters test the algorithm: 1e-4 on logits (the two
frameworks sum in different orders; the port's attention cores are fp32
throughout where the reference's decode path rounds its logits to the
parameter dtype). bf16 parameters test the model as served: 5e-2, the
bf16 slack the reference's own decode-vs-forward test uses
(tests/test_archs_smoke.py::test_decode_matches_forward). bf16 decode
gets 1e-1 (``DECODE_BF16_TOL``): the reference's decode core rounds its
logits and probabilities to bf16 (``attention.py:236-244``) while the
port's is the paged kernel's fp32 arithmetic, so the two round at other
places.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import serve_step as jserve  # noqa: E402
from repro_torch.configs import get, list_archs, reduced  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import serve_step as tserve  # noqa: E402

ATTN_DENSE = ["qwen1.5-0.5b", "llama3.2-3b", "olmo-1b", "nemotron-4-340b",
              "internvl2-2b", "hubert-xlarge"]
DECODERS = [a for a in ATTN_DENSE if a != "hubert-xlarge"]
NOT_PORTED = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "xlstm-125m",
              "jamba-1.5-large-398b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
DECODE_BF16_TOL = 1e-1
B, S, N_PATCH = 2, 16, 4


def f32(x):
    """A jnp / torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def both_params(arch, dtype, seed=0):
    """(cfg, reference params, port params) from one JAX init."""
    jd, td, _ = DTYPES[dtype]
    jcfg = jreduced(jget(arch))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jd)
    tree = jax.tree.map(np.asarray, jp)
    tcfg = reduced(get(arch))
    return jcfg, tcfg, jp, params_from_numpy(tcfg, tree, device="cpu")


def inputs(cfg, seed=0):
    """(tokens, embeds) numpy inputs of the reference's arch smoke test."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return None, rng.standard_normal((B, S, cfg.d_model), np.float32)
    if cfg.frontend == "vision_patches":
        return (rng.integers(0, cfg.vocab_size, (B, S - N_PATCH)),
                rng.standard_normal((B, N_PATCH, cfg.d_model), np.float32))
    return rng.integers(0, cfg.vocab_size, (B, S)), None


def as_j(x):
    """numpy input -> jnp (int32 tokens), None stays None."""
    if x is None:
        return None
    return jnp.asarray(x.astype(np.int32) if x.dtype.kind == "i" else x)


def as_t(x):
    """numpy input -> torch, None stays None."""
    return None if x is None else torch.from_numpy(x)


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparam_ln"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match(kind, dtype):
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64), np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jp = {"rmsnorm": {"scale": scale}, "layernorm": {"scale": scale,
                                                     "bias": bias},
          "nonparam_ln": {}}[kind]
    tp = {k: torch.from_numpy(v) for k, v in jp.items()}
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in jp.items()},
                              jnp.asarray(x).astype(jd), kind)
    got = tlayers.apply_norm(tp, torch.from_numpy(x).to(td), kind)
    assert got.dtype == td
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 3, 16), np.float32)
    pos = rng.integers(0, 4096, (2, 40))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mlp_type", ["swiglu", "relu2", "gelu"])
def test_mlp_matches(mlp_type):
    rng = np.random.default_rng(3)
    p = {"w_in": rng.standard_normal((32, 64), np.float32) / 6,
         "w_out": rng.standard_normal((64, 32), np.float32) / 8,
         "w_gate": rng.standard_normal((32, 64), np.float32) / 6}
    x = rng.standard_normal((2, 7, 32), np.float32)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), mlp_type)
    got = tlayers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                            torch.from_numpy(x), mlp_type)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unembed_is_fp32(dtype):
    jd, td, _ = DTYPES[dtype]
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 32), np.float32)
    x = rng.standard_normal((2, 3, 32), np.float32)
    want = jlayers.unembed(jnp.asarray(table).astype(jd),
                           jnp.asarray(x).astype(jd))
    got = tlayers.unembed(torch.from_numpy(table).to(td),
                          torch.from_numpy(x).to(td))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, 50)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-4)


def test_lm_loss_matches():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((2, 6, 11), np.float32) * 2
    labels = rng.integers(-1, 11, (2, 6))
    want = jmodel.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    got = tmodel.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------- params


def test_params_from_numpy_layout():
    """Periods split into layers in order; bf16 values carried exactly;
    a requested dtype reaches every weight but not the norms."""
    jcfg, tcfg, jp, tp = both_params("llama3.2-3b", "bfloat16")
    assert len(tp["layers"]) == tcfg.n_layers
    for layer_idx, layer in enumerate(tp["layers"]):
        want = np.asarray(jp["blocks"]["b0"]["mixer"]["wq"][layer_idx],
                          np.float32)
        assert layer["mixer"]["wq"].dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(layer["mixer"]["wq"]), want)
        assert layer["norm1"]["scale"].dtype == torch.float32
    tree = jax.tree.map(np.asarray, jp)
    cast = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.float32)
    assert cast["embed"]["table"].dtype == torch.float32
    np.testing.assert_array_equal(f32(cast["embed"]["table"]),
                                  np.asarray(jp["embed"]["table"],
                                             np.float32))


@pytest.mark.parametrize("arch", ATTN_DENSE)
def test_init_params_shapes_and_scales(arch):
    """The port's own init has the reference's tree of shapes and dtypes
    (layer by layer) and its init scales."""
    jcfg, tcfg, jp, conv = both_params(arch, "bfloat16")
    own = tmodel.init_params(tcfg, seed=3, device="cpu")
    flat_conv = jax.tree_util.tree_leaves_with_path(conv)
    flat_own = dict(jax.tree_util.tree_leaves_with_path(own))
    assert len(flat_conv) == len(flat_own)
    for path, leaf in flat_conv:
        mine = flat_own[path]
        assert mine.shape == leaf.shape and mine.dtype == leaf.dtype, path
    wq = own["layers"][0]["mixer"]["wq"].float()
    assert abs(float(wq.std()) * np.sqrt(tcfg.d_model) - 1) < 0.15


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_unported_blocks_raise(arch):
    """MoE and SSM blocks are later slices: every entry point says so."""
    cfg = reduced(get(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmodel.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmodel.forward({}, cfg, tokens=torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmodel.init_decode_state(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        params_from_numpy(cfg, {"blocks": {}}, device="cpu")


def test_seq_parallel_raises():
    cfg = dataclasses.replace(reduced(get("llama3.2-3b")), seq_parallel=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tmodel.init_params(cfg, device="cpu")


def test_default_device_is_the_card():
    """Without a card the default device raises; device='cpu' works."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = reduced(get("qwen1.5-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_decode_state(cfg, 1, 8)


# ------------------------------------------------------------- attention


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen1.5-0.5b",
                                  "hubert-xlarge"])
@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_forward_matches(arch, impl, dtype):
    """Both prefill implementations against the reference's (causal, and
    bidirectional for the encoder), GQA and QKV bias included."""
    jcfg, tcfg, jp, tp = both_params(arch, dtype)
    jd, td, tol = DTYPES[dtype]
    x = np.random.default_rng(6).standard_normal((B, 37, tcfg.d_model),
                                                 np.float32)
    causal = not tcfg.encoder_only
    jpos = jnp.arange(37)[None, :]
    want = jattn.attention_forward(
        jax.tree.map(lambda a: a[0], jp["blocks"]["b0"]["mixer"]),
        jnp.asarray(x).astype(jd), jcfg, jpos, causal, impl)
    got = tattn.attention_forward(tp["layers"][0]["mixer"],
                                  torch.from_numpy(x).to(td), tcfg,
                                  torch.arange(37)[None, :], causal, impl)
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def test_auto_goes_blockwise_beyond_2048():
    """impl='auto' is naive up to 2048 positions and the flash kernel's
    path beyond; both agree with the reference's auto choice."""
    jcfg, tcfg, jp, tp = both_params("llama3.2-3b", "float32")
    x = np.random.default_rng(7).standard_normal((1, 2056, tcfg.d_model),
                                                 np.float32) * 0.5
    want = jattn.attention_forward(
        jax.tree.map(lambda a: a[0], jp["blocks"]["b0"]["mixer"]),
        jnp.asarray(x), jcfg, jnp.arange(2056)[None, :], True, "auto")
    got = tattn.attention_forward(tp["layers"][0]["mixer"],
                                  torch.from_numpy(x), tcfg,
                                  torch.arange(2056)[None, :], True, "auto")
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_update", ["scatter", "onehot"])
@pytest.mark.parametrize("page_size", [4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches(kv_update, page_size, dtype):
    """Several decode steps at ragged positions through the paged core,
    against the reference's dense decode; the page size changes
    nothing."""
    jcfg, tcfg, jp, tp = both_params("llama3.2-3b", dtype)
    jcfg = dataclasses.replace(jcfg, kv_update=kv_update)
    tcfg = dataclasses.replace(tcfg, kv_update=kv_update)
    jd, td, tol = DTYPES[dtype]
    if dtype == "float32" and kv_update == "onehot":
        # With fp32 weights the reference's one-hot blend promotes its
        # bf16 cache to fp32 after the first step, the scatter keeps it
        # bf16: the two modes then hold different cache values.
        tol = 1e-2
    jparams = jax.tree.map(lambda a: a[1], jp["blocks"]["b0"]["mixer"])
    tparams = tp["layers"][1]["mixer"]
    jcache = jattn.init_kv_cache(jcfg, 3, 32)
    tcache = tattn.init_kv_cache(tcfg, 3, 32, device="cpu")
    rng = np.random.default_rng(8)
    pos = np.asarray([0, 5, 17], np.int32)
    outs = []
    for step in range(6):
        x = rng.standard_normal((3, 1, tcfg.d_model), np.float32)
        want, jcache = jattn.decode_attention(
            jparams, jnp.asarray(x).astype(jd), jcfg, jcache,
            jnp.asarray(pos))
        got, tcache = tattn.decode_attention(
            tparams, torch.from_numpy(x).to(td), tcfg, tcache,
            torch.from_numpy(pos), page_size=page_size)
        np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
        np.testing.assert_allclose(f32(tcache["k"]), f32(jcache["k"]),
                                   rtol=tol, atol=tol)
        outs.append(got)
        pos = pos + 1
    assert tattn.page_size_for(32) == 32 and tattn.page_size_for(24) == 8


def test_decode_result_independent_of_page_size():
    """The paged core gives bit-identical outputs at every page size."""
    _, tcfg, _, tp = both_params("llama3.2-3b", "bfloat16")
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 1, tcfg.d_model), np.float32)).bfloat16()
    pos = torch.tensor([3, 30])
    outs = []
    for ps in (1, 2, 8, 32, 64):
        cache = tattn.init_kv_cache(tcfg, 2, 64, device="cpu")
        cache["k"].normal_(generator=torch.Generator().manual_seed(1))
        cache["v"].normal_(generator=torch.Generator().manual_seed(2))
        out, _ = tattn.decode_attention(tp["layers"][0]["mixer"], x, tcfg,
                                        cache, pos, page_size=ps)
        outs.append(out)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


# ----------------------------------------------------------------- model


# The reference's forward casts frontend embeddings to bf16 and cannot
# scan a bf16 stream through fp32 weights (its carry changes dtype), so the
# two embedding-fed architectures compare in bf16 only.
FORWARD_CASES = [(a, d) for a in ATTN_DENSE for d in DTYPES
                 if d == "bfloat16" or get(a).frontend is None]


@pytest.mark.parametrize("arch,dtype", FORWARD_CASES)
@pytest.mark.parametrize("attention_impl", ["auto", "blockwise"])
def test_forward_matches(arch, dtype, attention_impl):
    jcfg, tcfg, jp, tp = both_params(arch, dtype)
    tol = DTYPES[dtype][2]
    tokens, embeds = inputs(tcfg)
    want, _ = jmodel.forward(jp, jcfg, tokens=as_j(tokens),
                             embeds=as_j(embeds),
                             attention_impl=attention_impl)
    got, aux = tmodel.forward(tp, tcfg, tokens=as_t(tokens),
                              embeds=as_t(embeds),
                              attention_impl=attention_impl)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (B, S, tcfg.vocab_size) and float(aux) == 0
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


def run_decode(jp, jcfg, tp, tcfg, tokens):
    """Teacher-forced decode of ``tokens`` (B, T) through both; returns
    the per-step logits of each as float32 numpy (B, T, V)."""
    b, steps = tokens.shape
    jstep = jax.jit(lambda p, t, st, pos: jmodel.decode_step(p, jcfg, t, st,
                                                             pos))
    jstate = jmodel.init_decode_state(jcfg, b, steps)
    tstate = tmodel.init_decode_state(tcfg, b, steps, device="cpu")
    jout, tout = [], []
    for t in range(steps):
        want, jstate = jstep(
            jp, jnp.asarray(tokens[:, t:t + 1].astype(np.int32)), jstate,
            jnp.full((b,), t, jnp.int32))
        got, tstate = tmodel.decode_step(
            tp, tcfg, torch.from_numpy(tokens[:, t:t + 1]), tstate,
            torch.full((b,), t, dtype=torch.int32))
        assert tuple(got.shape) == (b, 1, tcfg.vocab_size)
        jout.append(f32(want)[:, 0])
        tout.append(f32(got)[:, 0])
    return np.stack(jout, 1), np.stack(tout, 1)


@pytest.mark.parametrize("arch", DECODERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches(arch, dtype):
    """Teacher-forced decode, step by step, against the reference."""
    jcfg, tcfg, jp, tp = both_params(arch, dtype)
    tol = DECODE_BF16_TOL if dtype == "bfloat16" else DTYPES[dtype][2]
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab_size, (B, 8))
    want, got = run_decode(jp, jcfg, tp, tcfg, tokens)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-2b",
                                  "hubert-xlarge"])
def test_prefill_and_serve_steps_match(arch):
    jcfg, tcfg, jp, tp = both_params(arch, "bfloat16")
    tol = DTYPES["bfloat16"][2]
    tokens, embeds = inputs(tcfg, seed=11)
    want = jserve.make_prefill_step(jcfg)(jp, tokens=as_j(tokens),
                                          embeds=as_j(embeds))
    got = tserve.make_prefill_step(tcfg)(tp, tokens=as_t(tokens),
                                         embeds=as_t(embeds))
    assert got.shape == want.shape
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    if tcfg.encoder_only or tcfg.frontend:
        return
    jstate = jmodel.init_decode_state(jcfg, B, 8)
    tstate = tmodel.init_decode_state(tcfg, B, 8, device="cpu")
    tok = np.ones((B, 1), np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for t in range(4):
        jtok, jstate = jserve.make_serve_step(jcfg)(
            jp, jtok, jstate, jnp.full((B,), t, jnp.int32))
        ttok, tstate = tserve.make_serve_step(tcfg)(
            tp, ttok, tstate, torch.full((B,), t, dtype=torch.int32))
        assert ttok.dtype == torch.int32 and tuple(ttok.shape) == (B, 1)
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
