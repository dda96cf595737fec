"""The port's model layers, attention and model against the reference's,
on the CPU, from the same parameters: the reference's ``init_params``
pytree converted with ``repro_torch.models.convert.params_from_numpy``
and numpy-seeded inputs, for every architecture at ``reduced`` size.

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

Routed models (MoE MLPs) compare whole-model logits in fp32 only: in
bf16 the two frameworks round the residual stream at other places (XLA
fuses elementwise chains and rounds once), and the router's top-k turns
a last-bit difference of its input into another expert, so a whole-model
bf16 comparison of a routed model tests how noise breaks near-ties, not
the port. Their bf16 arithmetic is held to the reference block by block
(tests/test_torch_moe.py, identical inputs). Mamba keeps its conv window
in bf16 on both sides, so an fp32 decode input that lands on the other
side of a bf16 rounding boundary moves by one bf16 ulp (2^-8 of it):
fp32 decode of a Mamba model gets 1e-2 (``MAMBA_FP32_DECODE_TOL``).
xLSTM in bf16 is held to the reference's own bf16 rounding: the port's
logits may be no farther from the reference's than the reference's bf16
logits are from its fp32 ones on the same input (each block alone
matches to a bf16 ulp, tests/test_torch_ssm.py; with no MLP between its
recurrent blocks the residual stream carries every rounding).
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
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.serve import serve_step as tserve  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.tree import named_leaves  # noqa: E402

ATTN_DENSE = ["qwen1.5-0.5b", "llama3.2-3b", "olmo-1b", "nemotron-4-340b",
              "internvl2-2b", "hubert-xlarge"]
DECODERS = [a for a in ATTN_DENSE if a != "hubert-xlarge"]
ROUTED = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b", "jamba-1.5-large-398b"]
MOE_SSM = ROUTED[:2] + ["xlstm-125m", ROUTED[2]]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
DECODE_BF16_TOL = 1e-1
MAMBA_FP32_DECODE_TOL = 1e-2
# decode-vs-forward in the port: the least share of (position, MoE
# layer) routings the two paths must agree on (see the test).
ROUTING_AGREEMENT_FLOOR = 0.9
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


@pytest.mark.parametrize("tok", [-1, -64, -69, 64, 104, 99])
def test_embed_maps_ids_as_the_reference(tok):
    """Out-of-range ids (V = 64): the reference's gather counts a negative
    id from the end and clamps the rest to [0, V - 1]; the port's embed
    gives the same rows."""
    table = np.random.default_rng(5).standard_normal((64, 8), np.float32)
    ids = np.asarray([[tok, 0, 63]], np.int32)
    want = jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(ids))
    got = tlayers.embed({"table": torch.from_numpy(table)},
                        torch.from_numpy(ids))
    np.testing.assert_array_equal(f32(got), np.asarray(want))


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


# Each layer's first input projection, whose init std is 1 / sqrt(d).
FIRST_WEIGHT = {"attn": "wq", "mamba": "w_in", "mlstm": "w_up",
                "slstm": "w_up"}


@pytest.mark.parametrize("arch", ATTN_DENSE + MOE_SSM)
def test_init_params_shapes_and_scales(arch):
    """The port's own init has the reference's tree of shapes and dtypes
    (layer by layer, fp32 routers and SSM biases included) and its init
    scales."""
    jcfg, tcfg, jp, conv = both_params(arch, "bfloat16")
    own = tmodel.init_params(tcfg, seed=3, device="cpu")
    flat_conv = jax.tree_util.tree_leaves_with_path(conv)
    flat_own = dict(jax.tree_util.tree_leaves_with_path(own))
    assert len(flat_conv) == len(flat_own)
    for path, leaf in flat_conv:
        mine = flat_own[path]
        assert mine.shape == leaf.shape and mine.dtype == leaf.dtype, path
    for layer, (mixer, mlp) in zip(own["layers"], tmodel.layer_kinds(tcfg)):
        w = layer["mixer"][FIRST_WEIGHT[mixer]].float()
        assert abs(float(w.std()) * np.sqrt(tcfg.d_model) - 1) < 0.15
        if mlp == "moe":
            r = layer["mlp"]["router"]
            assert r.dtype == torch.float32
            assert abs(float(r.std()) * np.sqrt(tcfg.d_model) - 1) < 0.15
    if tcfg.mamba is not None:
        # The S4D-lin init log(1..d_state): two libraries' log, 1 ulp.
        mamba = own["layers"][0]["mixer"]
        np.testing.assert_allclose(
            f32(mamba["A_log"]), np.asarray(jp["blocks"]["b0"]["mixer"]
                                            ["A_log"][0], np.float32),
            rtol=2e-7)


@pytest.mark.parametrize("arch", MOE_SSM)
def test_params_from_numpy_moe_ssm_leaves(arch):
    """Expert stacks keep their expert axis under the period axis; the
    fp32 leaves (router, dt_bias, A_log, D, if_bias, g_bias) keep fp32
    when a dtype is requested, every other weight takes it."""
    jcfg, tcfg, jp, tp = both_params(arch, "float32")
    tree = jax.tree.map(np.asarray, jp)
    cast = params_from_numpy(tcfg, tree, device="cpu", dtype=torch.bfloat16)
    fp32_leaves = {"router", "dt_bias", "A_log", "D", "if_bias", "g_bias"}
    for idx, layer in enumerate(cast["layers"]):
        period, i = divmod(idx, tcfg.period)
        block = tree["blocks"][f"b{i}"]
        for part in ("mixer", "mlp"):
            for name, t in layer.get(part, {}).items():
                want = block[part][name][period]
                assert tuple(t.shape) == want.shape, (idx, part, name)
                assert t.dtype == (torch.float32 if name in fp32_leaves
                                   else torch.bfloat16), (idx, name)
                if name in fp32_leaves:
                    np.testing.assert_array_equal(f32(t), want)
    if tcfg.moe is not None:
        moe_layer = next(l for l, (_, m) in zip(tp["layers"],
                                                 tmodel.layer_kinds(tcfg))
                         if m == "moe")
        assert moe_layer["mlp"]["w_in"].shape[0] == tcfg.moe.n_experts


def test_seq_parallel_raises():
    """seq_parallel raised until the sharding slice landed; now nothing
    raises and, with no mesh, the constraint changes no logit."""
    base = reduced(get("llama3.2-3b"))
    cfg = dataclasses.replace(base, seq_parallel=True)
    params = tmodel.init_params(cfg, device="cpu")
    tokens = torch.from_numpy(inputs(base)[0])
    got, _ = tmodel.forward(params, cfg, tokens=tokens)
    want, _ = tmodel.forward(params, base, tokens=tokens)
    assert torch.equal(got, want)


def test_default_device_is_the_card():
    """Without a card the default device raises; device='cpu' works."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    for arch in ("qwen1.5-0.5b", "deepseek-moe-16b", "xlstm-125m",
                 "jamba-1.5-large-398b"):
        cfg = reduced(get(arch))
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
FORWARD_CASES = [(a, d) for a in ATTN_DENSE + MOE_SSM for d in DTYPES
                 if (d == "bfloat16" or get(a).frontend is None)
                 and (d == "float32" or a not in ROUTED)]
# Decode: every decoder in both dtypes, routed models in fp32 (see the
# module docstring).
DECODE_CASES = [(d, a) for d in ("float32", "bfloat16")
                for a in DECODERS + MOE_SSM
                if d == "float32" or a not in ROUTED]


def by_position(calls, lanes, steps):
    """Recorded routings as (lanes, steps, MoE layers, K): a forward
    routes lanes x steps tokens (lane-major) once per layer, a decode
    step routes the lanes once per layer, step after step."""
    x = np.stack(calls)
    if x.shape[1] == lanes * steps:
        return x.reshape(len(calls), lanes, steps, -1).transpose(1, 2, 0, 3)
    return x.reshape(steps, -1, lanes, x.shape[-1]).transpose(2, 0, 1, 3)


def hold_where_routed_alike(got, want, calls_a, calls_b, tol):
    """The routing rule for a routed model in bf16: the share of (position,
    layer) routings equal on the two sides is at least
    ROUTING_AGREEMENT_FLOOR, and the (lanes, steps, V) logits are held to
    ``tol`` at the positions whose routing agreed in every layer, as did
    every earlier position's in the lane (attention and the recurrences
    carry an earlier position into every later one); the first position
    of every lane must be among them. Returns the share."""
    lanes, steps = got.shape[:2]
    same = np.all(by_position(calls_a, lanes, steps)
                  == by_position(calls_b, lanes, steps), -1)
    share = float(same.mean())
    mask = np.cumprod(same.all(-1), axis=1) > 0
    assert share >= ROUTING_AGREEMENT_FLOOR, share
    assert mask[:, 0].all(), "a first position routed differently"
    np.testing.assert_allclose(got[mask], want[mask], rtol=tol, atol=tol)
    return share


def bf16_floor(jp, jcfg, **kw):
    """max |bf16 - fp32| of the reference's own forward logits on the
    same input: the bf16 rounding of the model itself."""
    j32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    lo, _ = jmodel.forward(jp, jcfg, **kw)
    hi, _ = jmodel.forward(j32, jcfg, **kw)
    return float(np.abs(f32(lo) - f32(hi)).max())


@pytest.mark.parametrize("arch,dtype", FORWARD_CASES)
@pytest.mark.parametrize("attention_impl", ["auto", "blockwise"])
def test_forward_matches(arch, dtype, attention_impl):
    """Logits and the aux loss against the reference's forward (see the
    module docstring for routed models and xLSTM in bf16)."""
    jcfg, tcfg, jp, tp = both_params(arch, dtype)
    tol = DTYPES[dtype][2]
    tokens, embeds = inputs(tcfg)
    want, jaux = jmodel.forward(jp, jcfg, tokens=as_j(tokens),
                                embeds=as_j(embeds),
                                attention_impl=attention_impl)
    got, aux = tmodel.forward(tp, tcfg, tokens=as_t(tokens),
                              embeds=as_t(embeds),
                              attention_impl=attention_impl)
    assert got.dtype == torch.float32 and aux.dtype == torch.float32
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    if tcfg.moe is None:
        assert float(aux) == float(jaux) == 0
    else:
        assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    if dtype == "bfloat16" and arch == "xlstm-125m":
        tol = max(tol, bf16_floor(jp, jcfg, tokens=as_j(tokens)))
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


@pytest.mark.parametrize("dtype,arch", DECODE_CASES)
def test_decode_step_matches(dtype, arch):
    """Teacher-forced decode, step by step, against the reference (see
    the module docstring for Mamba in fp32 and xLSTM in bf16)."""
    jcfg, tcfg, jp, tp = both_params(arch, dtype)
    tol = DECODE_BF16_TOL if dtype == "bfloat16" else DTYPES[dtype][2]
    if dtype == "float32" and tcfg.mamba is not None:
        tol = MAMBA_FP32_DECODE_TOL
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab_size, (B, 8))
    want, got = run_decode(jp, jcfg, tp, tcfg, tokens)
    if dtype == "bfloat16" and arch == "xlstm-125m":
        tol = max(tol, bf16_floor(jp, jcfg, tokens=as_j(tokens)))
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


JAX_TOP_K = jax.lax.top_k
TORCH_ROUTE = tmoe.route


def recording_top_k(calls):
    """A ``jax.lax.top_k`` that appends each call's sorted indices to
    ``calls`` through an ordered debug callback (it records inside
    ``jit`` and ``scan``)."""

    def top_k(x, k):
        vals, idx = JAX_TOP_K(x, k)
        jax.debug.callback(
            lambda i: calls.append(np.sort(np.asarray(i), -1)), idx,
            ordered=True)
        return vals, idx
    return top_k


def reference_decode(jp, jcfg, tokens):
    """The reference's teacher-forced decode logits (B, T, V) alone, as
    ``run_decode`` runs it."""
    b, steps = tokens.shape
    jstep = jax.jit(lambda p, t, st, pos: jmodel.decode_step(p, jcfg, t, st,
                                                             pos))
    jstate = jmodel.init_decode_state(jcfg, b, steps)
    out = []
    for t in range(steps):
        lg, jstate = jstep(jp, jnp.asarray(tokens[:, t:t + 1].astype(
            np.int32)), jstate, jnp.full((b,), t, jnp.int32))
        out.append(f32(lg)[:, 0])
    return np.stack(out, 1)


def recording_route(calls):
    """``tmoe.route`` appending each call's sorted experts to ``calls``."""

    def route(router, xt, cfg):
        r = TORCH_ROUTE(router, xt, cfg)
        calls.append(np.sort(r.experts.numpy(), -1))
        return r
    return route


def rounding_floor(runs, lanes, steps):
    """max |bf16 - fp32| of two (logits, routing calls) runs over the
    positions routed alike in every layer, as was every earlier position
    of the lane."""
    (lo, calls_lo), (hi, calls_hi) = runs
    same = np.all(by_position(calls_lo, lanes, steps)
                  == by_position(calls_hi, lanes, steps), -1)
    mask = np.cumprod(same.all(-1), axis=1) > 0
    return float(np.abs(lo[mask] - hi[mask]).max())


def reference_decode_floor(arch, tokens, monkeypatch):
    """The reference's own bf16 rounding of a routed decode: max |bf16 -
    fp32| of its two decodes of ``tokens`` (two plain formulations of
    the same model), over the positions the two routed alike. The port's
    rounding is not part of it."""
    runs = []
    for dtype in ("bfloat16", "float32"):
        jcfg, _, jp, _ = both_params(arch, dtype)
        calls = []
        monkeypatch.setattr(jax.lax, "top_k", recording_top_k(calls))
        logits = reference_decode(jp, jcfg, tokens)
        jax.effects_barrier()
        runs.append((logits, calls))
    monkeypatch.undo()
    return rounding_floor(runs, *tokens.shape)


@pytest.mark.parametrize("arch", ROUTED)
def test_routed_decode_bf16_matches(arch, monkeypatch):
    """The routed architectures' bf16 decode, step by step, against the
    reference's ``decode_step`` (``DECODE_CASES`` holds them in fp32
    only). Both sides' routings are recorded (the reference's through a
    debug callback on its ``jax.lax.top_k``) and the logits are held
    where the two routed alike (``hold_where_routed_alike``, the routing
    rule of PERF.md §2) to ``DECODE_BF16_TOL``, or, where that is larger,
    to 1.5 x the reference's own bf16 rounding of the same decode
    (``reference_decode_floor``; Jamba's 16 reduced layers carry it
    farthest, ROADMAP.md queue 3)."""
    jcfg, tcfg, jp, tp = both_params(arch, "bfloat16")
    tokens = np.random.default_rng(10).integers(0, tcfg.vocab_size, (B, 8))
    tol = max(DECODE_BF16_TOL,
              1.5 * reference_decode_floor(arch, tokens, monkeypatch))
    tcalls, jcalls = [], []
    monkeypatch.setattr(tmoe, "route", recording_route(tcalls))
    monkeypatch.setattr(jax.lax, "top_k", recording_top_k(jcalls))
    want, got = run_decode(jp, jcfg, tp, tcfg, tokens)
    jax.effects_barrier()
    assert len(jcalls) == len(tcalls) > 0
    hold_where_routed_alike(got, want, tcalls, jcalls, tol)


@pytest.mark.parametrize("arch", MOE_SSM)
def test_decode_matches_forward(arch, monkeypatch):
    """tests/test_archs_smoke.py::test_decode_matches_forward in the port,
    on that test's own parameters and tokens (bf16, PRNGKey(2)), xLSTM
    included. The port's decode core is the paged kernel's fp32
    arithmetic where its forward rounds attention probabilities to bf16,
    so the two paths differ at bf16 noise, which a router's near-tie can
    turn into another expert: the two paths' routings are recorded and
    held to the routing rule (``hold_where_routed_alike``, the port
    against itself)."""
    jcfg = jreduced(jget(arch))
    key = jax.random.PRNGKey(2)
    jp = jmodel.init_params(jcfg, key)
    tokens = np.array(jax.random.randint(key, (B, 8), 0, jcfg.vocab_size))
    tcfg = reduced(get(arch))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    calls = []
    troute = tmoe.route

    def record(router, xt, cfg):
        r = troute(router, xt, cfg)
        calls.append(np.sort(r.experts.numpy(), -1))
        return r

    monkeypatch.setattr(tmoe, "route", record)
    fwd, _ = tmodel.forward(tp, tcfg, tokens=torch.from_numpy(tokens))
    n_fwd = len(calls)
    state = tmodel.init_decode_state(tcfg, B, 8, device="cpu")
    outs = []
    for t in range(8):
        lg, state = tmodel.decode_step(
            tp, tcfg, torch.from_numpy(tokens[:, t:t + 1]), state,
            torch.full((B,), t, dtype=torch.int32))
        outs.append(lg[:, 0])
    dec = f32(torch.stack(outs, 1))
    if tcfg.moe is None:
        np.testing.assert_allclose(dec, f32(fwd), rtol=5e-2, atol=5e-2)
        return
    hold_where_routed_alike(dec, f32(fwd), calls[n_fwd:], calls[:n_fwd],
                            5e-2)


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


# ------------------------------------------------- the kernels' head dims
#
# ``reduced`` gives every attention architecture head dim 16. These keep
# the two head dims the CUDA kernels added for the full-size configs, at
# reduced depth: hubert-xlarge's 80 (d_model 320: 4 heads of 80,
# encoder-only, so non-causal) and nemotron-4-340b's 192 (d_model 768: 4
# heads of 192 over 1 KV head). Tolerances as above.
HEAD_DIM_MODELS = {"hubert-xlarge": 320, "nemotron-4-340b": 768}


def head_dim_params(arch, dtype, seed=0):
    """``both_params`` at the d_model of ``HEAD_DIM_MODELS``."""
    jd, _, _ = DTYPES[dtype]
    jcfg = jreduced(jget(arch), d_model=HEAD_DIM_MODELS[arch])
    tcfg = reduced(get(arch), d_model=HEAD_DIM_MODELS[arch])
    assert tcfg.resolved_head_dim == jcfg.resolved_head_dim == \
        HEAD_DIM_MODELS[arch] // 4
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed), dtype=jd)
    return jcfg, tcfg, jp, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


# hubert is embedding-fed: bf16 only (see FORWARD_CASES).
@pytest.mark.parametrize("arch,dtype", [("hubert-xlarge", "bfloat16"),
                                        ("nemotron-4-340b", "float32"),
                                        ("nemotron-4-340b", "bfloat16")])
def test_forward_matches_at_kernel_head_dims(arch, dtype):
    """The blockwise (flash) path's logits against the reference's at
    head dims 80 (non-causal) and 192 (causal, GQA 4)."""
    jcfg, tcfg, jp, tp = head_dim_params(arch, dtype)
    tokens, embeds = inputs(tcfg)
    want, _ = jmodel.forward(jp, jcfg, tokens=as_j(tokens),
                             embeds=as_j(embeds), attention_impl="blockwise")
    got, _ = tmodel.forward(tp, tcfg, tokens=as_t(tokens),
                            embeds=as_t(embeds), attention_impl="blockwise")
    assert tuple(got.shape) == (B, S, tcfg.vocab_size)
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_at_head_dim_192(dtype):
    """Four teacher-forced decode steps of nemotron-4-340b at head dim 192
    through the paged path, against the reference's."""
    jcfg, tcfg, jp, tp = head_dim_params("nemotron-4-340b", dtype)
    tokens = np.random.default_rng(11).integers(0, tcfg.vocab_size, (B, 4))
    want, got = run_decode(jp, jcfg, tp, tcfg, tokens)
    tol = DECODE_BF16_TOL if dtype == "bfloat16" else DTYPES[dtype][2]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_train_step_matches_at_head_dim_80():
    """One hubert-xlarge train step at head dim 80 (bf16, masked-unit
    labels): the loss and every gradient leaf, through the non-causal
    flash forward and backward, against the reference's
    ``jax.value_and_grad`` of its loss (bf16 slack: 5e-2 of each leaf's
    largest magnitude)."""
    import repro.core  # noqa: F401  (the reference's import order)
    from repro.train import train_step as jstep
    jcfg, tcfg, jp, tp = head_dim_params("hubert-xlarge", "bfloat16")
    _, embeds = inputs(tcfg, seed=3)
    labels = np.random.default_rng(4).integers(0, tcfg.vocab_size, (B, S))
    labels[:, ::5] = -1
    labels = labels.astype(np.int32)
    (_, jmet), jgrads = jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jcfg, {"embeds": as_j(embeds),
                                          "labels": jnp.asarray(labels)},
                                attention_impl="blockwise"),
        has_aux=True)(jp)
    tmet, tgrads = tstep.value_and_grad(
        tp, lambda p, batch: tstep.loss_fn(p, tcfg, batch,
                                           attention_impl="blockwise"),
        {"embeds": as_t(embeds), "labels": torch.from_numpy(labels)})
    tol = DTYPES["bfloat16"][2]
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-2)
    want = params_from_numpy(tcfg, jax.tree.map(np.asarray, jgrads),
                             device="cpu", dtype=torch.float32)
    assert [n for n, _ in named_leaves(want)] == \
        [n for n, _ in named_leaves(tp)]
    for (name, w), g in zip(named_leaves(want), tgrads):
        assert tuple(g.shape) == tuple(w.shape), name
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g.float() - w).abs().max()) <= tol * scale, name
