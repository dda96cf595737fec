"""The port's MoE MLP (``repro_torch.models.moe``) against the reference's
``repro.models.moe`` on the CPU: the same parameters (the reference's
``init_moe``) and numpy-seeded inputs, for deepseek-moe-16b (shared
experts, swiglu) and phi3.5-moe (no shared experts) at ``reduced`` size,
under both dispatches.

Tolerances: fp32 1e-4 and bf16 5e-2, as tests/test_torch_models.py. The
routing (top-k order, queue positions, the keep mask) must be equal: it
is read off the reference's own computation, its jaxpr evaluated one
top-level equation at a time.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.extend import core as jcore  # noqa: E402

import repro.core  # noqa: E402,F401  (resolves the reference's import cycle)
from repro.configs import get as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCHS = ["deepseek-moe-16b", "phi3.5-moe-42b-a6.6b"]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
B, S = 2, 16


def f32(x):
    """A jnp / torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def configs(arch, dispatch="sort", capacity_factor=None):
    """(reference cfg, port cfg) at ``reduced`` size."""
    out = []
    for cfg in (jreduced(jget(arch)), reduced(get(arch))):
        cfg = dataclasses.replace(cfg, moe_dispatch=dispatch)
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def both_moe(jcfg, dtype, seed=0):
    """(reference params, port params) from one ``init_moe``."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, DTYPES[dtype][0])
    tp = {k: torch.tensor(f32(v)).to(
        torch.float32 if v.dtype == jnp.float32 else DTYPES[dtype][1])
        for k, v in jp.items()}
    return jp, tp


def x_input(d, dtype, seed=1):
    """(jnp, torch) (B, S, d) activations of one numpy draw."""
    x = np.random.default_rng(seed).standard_normal((B, S, d), np.float32)
    return (jnp.asarray(x).astype(DTYPES[dtype][0]),
            torch.from_numpy(x).to(DTYPES[dtype][1]))


def reference_routing(jp, x, jcfg):
    """(expert ids (T, K), keep mask (T, K)) as the reference's
    ``moe_forward`` computes them: its jaxpr evaluated equation by
    equation, keeping the outputs of ``top_k`` and of the first (T, K)
    boolean ``lt`` (``pos < capacity``)."""
    closed = jax.make_jaxpr(lambda p, x: jmoe.moe_forward(p, x, jcfg))(
        jp, x)
    env = dict(zip(closed.jaxpr.invars, jax.tree.leaves((jp, x))))
    env.update(zip(closed.jaxpr.constvars, closed.consts))
    T, K = B * S, jcfg.moe.top_k
    experts = keep = None
    for eqn in closed.jaxpr.eqns:
        args = [v.val if isinstance(v, jcore.Literal) else env[v]
                for v in eqn.invars]
        outs = eqn.primitive.bind(*args, **eqn.params)
        outs = outs if eqn.primitive.multiple_results else [outs]
        env.update(zip(eqn.outvars, outs))
        if eqn.primitive.name == "top_k" and experts is None:
            experts = np.asarray(outs[1])
        if (eqn.primitive.name == "lt" and keep is None
                and outs[0].shape == (T, K) and outs[0].dtype == jnp.bool_):
            keep = np.asarray(outs[0])
    return experts, keep


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches(arch, dtype, dispatch):
    """Output and aux loss of ``moe_forward`` against the reference's."""
    jcfg, tcfg = configs(arch, dispatch)
    jp, tp = both_moe(jcfg, dtype)
    xj, xt = x_input(tcfg.d_model, dtype)
    want, jaux = jmoe.moe_forward(jp, xj, jcfg)
    got, aux = tmoe.moe_forward(tp, xt, tcfg)
    tol = DTYPES[dtype][2]
    assert got.dtype == DTYPES[dtype][1] and aux.dtype == torch.float32
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dropped_tokens_match(arch, dispatch):
    """At capacity_factor 0.25 tokens are dropped: the port routes to the
    reference's experts in its top-k order, keeps the reference's
    (token, k) pairs and drops as many, and gives its output; the input
    gradient matches too (a dropped pair's gradient is zero on both
    sides: the sort dispatch's overflow row is thrown away)."""
    jcfg, tcfg = configs(arch, dispatch, capacity_factor=0.25)
    jp, tp = both_moe(jcfg, "float32", seed=2)
    xj, xt = x_input(tcfg.d_model, "float32", seed=3)
    experts, keep = reference_routing(jp, xj, jcfg)
    r = tmoe.route(tp["router"], xt.reshape(B * S, -1), tcfg)
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    overflow = int((~keep).sum())
    assert int((~r.keep).sum()) == overflow > 0
    assert r.capacity == max(1, int(0.25 * tcfg.moe.top_k * B * S /
                                    tcfg.moe.n_experts))
    want, _ = jmoe.moe_forward(jp, xj, jcfg)
    got, _ = tmoe.moe_forward(tp, xt, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)

    jgrad = jax.grad(lambda x: jnp.sum(jmoe.moe_forward(jp, x, jcfg)[0]
                                       ** 2))(xj)
    xg = xt.clone().requires_grad_(True)
    (tmoe.moe_forward(tp, xg, tcfg)[0] ** 2).sum().backward()
    np.testing.assert_allclose(f32(xg.grad), f32(jgrad), rtol=1e-4,
                               atol=1e-4)


def test_sort_dispatch_slots():
    """Kept (token, k) pairs land in distinct rows ``expert * C + pos``
    below ``E * C``; every dropped pair in the overflow row ``E * C``,
    whose contents never reach the output."""
    jcfg, tcfg = configs("deepseek-moe-16b", capacity_factor=0.25)
    _, tp = both_moe(jcfg, "float32", seed=4)
    _, xt = x_input(tcfg.d_model, "float32", seed=5)
    xt2 = xt.reshape(B * S, -1)
    r = tmoe.route(tp["router"], xt2, tcfg)
    E, C = tcfg.moe.n_experts, r.capacity
    xe, slot = tmoe._dispatch_sort(xt2, r, E)
    kept = slot[r.keep]
    assert kept.unique().numel() == kept.numel() and bool((kept < E * C).all())
    assert bool((slot[~r.keep] == E * C).all()) and bool((~r.keep).any())
    np.testing.assert_array_equal(kept.numpy(),
                                  (r.experts * C + r.pos)[r.keep].numpy())
    tok = torch.arange(B * S)[:, None].expand_as(slot)[r.keep]
    assert torch.equal(xe.reshape(E * C, -1)[kept], xt2[tok])
    ye =torch.randn(E, C, tcfg.d_model, generator=torch.Generator()
                     .manual_seed(0))
    y = tmoe._combine_sort(ye, slot, r.gates, torch.float32)
    want = sum(ye.reshape(E * C, -1)[torch.where(r.keep[:, k], slot[:, k], 0)]
               * r.gates[:, k, None] for k in range(slot.shape[1]))
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("router", ["zeros", "twin_columns"])
def test_topk_ties_follow_reference(router):
    """Exactly tied probabilities (a zero router: all equal; a router with
    duplicated columns: equal pairs) are ordered as ``jax.lax.top_k``
    orders them, lower expert id first, and so are the aux loss's top-1
    and the queue priority."""
    jcfg, tcfg = configs("deepseek-moe-16b", capacity_factor=0.25)
    jp, tp = both_moe(jcfg, "float32", seed=6)
    w = np.zeros_like(f32(jp["router"]))
    if router == "twin_columns":
        base = np.random.default_rng(7).standard_normal(
            (w.shape[0], w.shape[1] // 2), np.float32)
        w = np.repeat(base, 2, axis=1)
    jp = dict(jp, router=jnp.asarray(w))
    tp = dict(tp, router=torch.from_numpy(w))
    xj, xt = x_input(tcfg.d_model, "float32", seed=8)
    experts, keep = reference_routing(jp, xj, jcfg)
    r = tmoe.route(tp["router"], xt.reshape(B * S, -1), tcfg)
    np.testing.assert_array_equal(r.experts.numpy(), experts)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    want, jaux = jmoe.moe_forward(jp, xj, jcfg)
    got, aux = tmoe.moe_forward(tp, xt, tcfg)
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-4, atol=1e-4)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_held_combine_gradient_matches_autograd(dtype):
    """The dispatch and combine of a layer that holds part of the experts
    (``_DispatchHeld``, ``_CombineHeld``, all gathers) give the outputs
    and gradients that autograd gives through the sort dispatch's
    arithmetic with a zero overflow row (``_combine_sort``, and a gather
    of the tokens), while most pairs have no slot (their experts are
    absent)."""
    gen = torch.Generator().manual_seed(3)
    H, C, d, T, K = 2, 5, 8, 12, 4
    slot = torch.full((T, K), H * C)
    live = torch.randperm(T * K, generator=gen)[:H * C - 2]  # 2 slots empty
    slot.view(-1)[live] = torch.randperm(H * C, generator=gen)[:H * C - 2]
    src = torch.full((H * C,), T * K)
    src[slot.view(-1)[live]] = live
    how = torch.cat([slot.view(-1), src])
    gates = torch.rand((T, K), generator=gen)
    xt = torch.randn((T, d), generator=gen).to(dtype)
    ye = torch.randn((H, C, d), generator=gen).to(dtype)
    dy = torch.randn((T, d), generator=gen).to(dtype)
    dxe = torch.randn((H * C, d), generator=gen).to(dtype)
    tok = torch.where(src < T * K, src // K, T)
    outs = []
    for held in (True, False):
        a, g, x = (t.clone().requires_grad_(True) for t in (ye, gates, xt))
        how_ = how if held else slot
        y = tmoe._combine(a, how_, g, False, dtype, held)
        xe = tmoe._DispatchHeld.apply(x, slot, src) if held else \
            torch.cat([x, x.new_zeros((1, d))])[tok]
        outs.append((y, xe) + torch.autograd.grad((y, xe), (a, g, x),
                                                  (dy, dxe)))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
