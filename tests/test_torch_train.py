"""The port's training slice against the JAX package's, on the CPU, from
the same numpy-seeded inputs and the same parameters (the reference's
``init_params`` pytree converted with ``params_from_numpy``): the
learning-rate schedule, one AdamW update, one train step (loss,
gradients leaf by leaf, parameters after the update), microbatch
accumulation, checkpoints (round trip, retention, async, the reference
reading the port's files), the fault-tolerance helpers and a bit-exact
supervised restart, and the training launcher.

Tolerances. fp32 AdamW: 1e-6 relative (the same arithmetic, pow and sqrt
of two libraries); bf16 parameters: 1 ulp (the fp32 update rounds once
to bf16 on both sides). The train step in fp32: loss 1e-5 relative;
each gradient leaf within 1e-4 of its largest magnitude (sums in other
orders). Parameters after the step: Adam's first update is
``lr * m / (sqrt(v) + eps)`` with ``m = g`` and ``v = g^2`` bias-
corrected, so it is ``lr * sign(g)`` up to ``lr * eps / |g|`` wherever
|g| >> eps, whatever |g| is. So where the reference's |g| is at least
1e-5 the two updates agree to 1e-2 lr (the eps term, plus the weight
decay's share, which is equal on both sides); where |g| is smaller a
gradient difference of 1e-4 max|g| may flip the sign, and the bound is
the whole update range, 2 lr (1 + wd |p|).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (resolves the reference's import cycle)
from repro.configs import get as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import fault_tolerance as jft  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jstep  # noqa: E402
from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import fault_tolerance as tft  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.tree import (leaves, named_leaves,  # noqa: E402
                                    tree_map)


def f32(x):
    """A jnp / torch array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def opt_pair(**kw):
    """The same optimizer settings on both sides (``state_dtype`` by
    name)."""
    sd = kw.pop("state_dtype", None)
    return (jopt.OptimizerConfig(state_dtype=getattr(jnp, sd) if sd
                                 else None, **kw),
            topt.OptimizerConfig(state_dtype=getattr(torch, sd) if sd
                                 else None, **kw))


# -------------------------------------------------------------- optimizer


def test_lr_schedule_matches():
    jcfg, tcfg = opt_pair(peak_lr=1e-3, min_lr=1e-4, warmup_steps=10,
                          total_steps=100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(jopt.lr_schedule(jcfg, jnp.asarray(s)))
        got = float(topt.lr_schedule(tcfg, torch.tensor(s,
                                                        dtype=torch.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), s
    # The reference test's shape.
    lrs = [float(topt.lr_schedule(tcfg, torch.tensor(s))) for s in
           (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3) and lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-3)


OPT_CASES = {
    "fp32": dict(dtype="float32", kw=dict(warmup_steps=2)),
    "bf16_params": dict(dtype="bfloat16", kw=dict(warmup_steps=2)),
    "bf16_state": dict(dtype="float32",
                       kw=dict(warmup_steps=2, state_dtype="bfloat16")),
    "clip": dict(dtype="float32", kw=dict(clip_norm=1e-6), gscale=100.0),
    "decay": dict(dtype="float32", kw=dict(weight_decay=0.3, peak_lr=1e-2,
                                           warmup_steps=0)),
    # The other (param, grad, moment) dtype triples the CUDA kernel takes:
    # microbatched steps' fp32 gradients, bf16 gradients of fp32
    # parameters, bf16 state of bf16 parameters.
    "bf16_f32_grads": dict(dtype="bfloat16", gdtype="float32",
                           kw=dict(warmup_steps=2)),
    "f32_bf16_grads": dict(dtype="float32", gdtype="bfloat16",
                           kw=dict(warmup_steps=2)),
    "bf16_bf16_state": dict(dtype="bfloat16",
                            kw=dict(warmup_steps=2, state_dtype="bfloat16")),
    # Every leaf decayed by ``decay_mask``, the 1-D scale too.
    "mask_all": dict(dtype="float32", mask=True,
                     kw=dict(weight_decay=0.2, warmup_steps=1)),
    "bf16_mask_all": dict(dtype="bfloat16", mask=True,
                          kw=dict(weight_decay=0.2, warmup_steps=1)),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_matches(case):
    """Three AdamW updates from the same params, grads and state: a 2-D
    weight (decayed), a 1-D scale (not decayed) and a 3-D stack.
    ``gdtype`` gives the gradients a dtype of their own; ``mask`` decays
    every leaf by ``decay_mask`` (the reference decays by ndim, so its
    leaves get a leading axis of 1 there)."""
    spec = OPT_CASES[case]
    jcfg, tcfg = opt_pair(**spec["kw"])
    rng = np.random.default_rng(7)
    shapes = {"w": (6, 5), "scale": (5,), "stack": (2, 3, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * spec.get("gscale", 1.0)
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    jd = getattr(jnp, spec["dtype"])
    td = getattr(torch, spec["dtype"])
    gd = spec.get("gdtype", spec["dtype"])
    lead = (lambda a: a[None]) if spec.get("mask") else (lambda a: a)
    mask = {k: True for k in shapes} if spec.get("mask") else None
    jp = {k: lead(jnp.asarray(v).astype(jd)) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(td) for k, v in p0.items()}
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    for g in grads:
        jp, js, jm = jopt.adamw_update(
            jp, {k: lead(jnp.asarray(v).astype(getattr(jnp, gd)))
                 for k, v in g.items()}, js, jcfg)
        tp, ts, tm = topt.adamw_update(
            tp, {k: torch.from_numpy(v).to(getattr(torch, gd))
                 for k, v in g.items()}, ts, tcfg, decay_mask=mask)
    assert int(ts["count"]) == int(js["count"]) == 3
    assert ts["count"].dtype == torch.int32
    for key in ("lr", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    for k, s in shapes.items():
        assert tp[k].dtype == td
        want = f32(jp[k]).reshape(s)
        if spec["dtype"] == "bfloat16":
            # 1 ulp of bf16 (8 significant bits) at each value.
            ulp = np.exp2(np.floor(np.log2(np.abs(want))) - 7)
            assert np.all(np.abs(f32(tp[k]) - want) <= ulp * 1.0001)
        else:
            np.testing.assert_allclose(f32(tp[k]), want, rtol=1e-6,
                                       atol=1e-7)
        sd = spec["kw"].get("state_dtype")
        for mom in ("m", "v"):
            assert ts[mom][k].dtype == (getattr(torch, sd) if sd
                                        else torch.float32)
            tol = 1e-2 if sd else 1e-6   # bf16 moments: 1 ulp
            np.testing.assert_allclose(f32(ts[mom][k]),
                                       f32(js[mom][k]).reshape(s),
                                       rtol=tol, atol=1e-7)


# (param dtype, grad dtype, moment dtype or None for fp32): the cell's
# bf16 / bf16 / fp32, microbatched steps' fp32 gradients, bf16 state, and
# fp32 parameters under either moment dtype.
KERNEL_TRIPLES = {
    "f32": ("float32", "float32", None),
    "bf16": ("bfloat16", "bfloat16", None),
    "bf16_f32_grads": ("bfloat16", "float32", None),
    "bf16_bf16_state": ("bfloat16", "bfloat16", "bfloat16"),
    "f32_bf16_state": ("float32", "float32", "bfloat16"),
}


def ops_update(tp, tg, ts, tcfg, mask):
    """One update through the kernel's two custom ops called by the
    dispatcher (their CPU kernels, the plain version of
    ``kernels/adamw/ref.py``), in place; returns the metrics."""
    from repro_torch.kernels.adamw.adamw import HYPER_FIELDS
    flat = [leaves(t) for t in (tp, tg, ts["m"], ts["v"])]
    decay = leaves(mask) if mask else [p.ndim >= 2 for p in flat[0]]
    sums = torch.ops.repro_torch.adamw_sum_squares(flat[1])
    count, lr, gnorm = torch.ops.repro_torch.adamw_apply(
        *flat, sums, ts["count"], decay,
        [float(getattr(tcfg, f)) for f in HYPER_FIELDS])
    ts["count"] = count
    return {"lr": lr, "grad_norm": gnorm}


@pytest.mark.parametrize("mask", ["ndim", "all"])
@pytest.mark.parametrize("triple", sorted(KERNEL_TRIPLES))
def test_adamw_ops_match(triple, mask):
    """The kernel's custom ops against the reference over every dtype
    triple the CUDA kernel takes, three updates (the second clipped).
    ``mask="all"`` decays every leaf by ``decay_mask``; the reference
    decays by ndim, so its leaves get a leading axis of 1 there."""
    pd, gd, sd = KERNEL_TRIPLES[triple]
    jcfg, tcfg = opt_pair(warmup_steps=1, weight_decay=0.2,
                          state_dtype=sd)
    rng = np.random.default_rng(11)
    shapes = {"w": (6, 5), "scale": (5,), "stack": (2, 3, 4)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * gs).astype(np.float32)
              for k, s in shapes.items()} for gs in (1.0, 50.0, 0.1)]
    lead = (lambda a: a[None]) if mask == "all" else (lambda a: a)
    jp = {k: lead(jnp.asarray(v).astype(getattr(jnp, pd)))
          for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, pd))
          for k, v in p0.items()}
    tmask = {k: True for k in shapes} if mask == "all" else None
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    for g in grads:
        jp, js, jm = jopt.adamw_update(
            jp, {k: lead(jnp.asarray(v).astype(getattr(jnp, gd)))
                 for k, v in g.items()}, js, jcfg)
        tm = ops_update(tp, {k: torch.from_numpy(v).to(getattr(torch, gd))
                             for k, v in g.items()}, ts, tcfg, tmask)
    assert int(ts["count"]) == 3 and ts["count"].dtype == torch.int32
    for key in ("lr", "grad_norm"):
        assert float(tm[key]) == pytest.approx(float(jm[key]), rel=1e-6)
    for k, s in shapes.items():
        want = f32(jp[k]).reshape(s)
        assert tp[k].dtype == getattr(torch, pd)
        if pd == "bfloat16":
            ulp = np.exp2(np.floor(np.log2(np.abs(want))) - 7)
            assert np.all(np.abs(f32(tp[k]) - want) <= ulp * 1.0001)
        else:
            np.testing.assert_allclose(f32(tp[k]), want, rtol=1e-6,
                                       atol=1e-7)
        for mom in ("m", "v"):
            assert ts[mom][k].dtype == (getattr(torch, sd) if sd
                                        else torch.float32)
            np.testing.assert_allclose(
                f32(ts[mom][k]), f32(js[mom][k]).reshape(s),
                rtol=1e-2 if sd else 1e-6, atol=1e-7)


def test_adamw_moves_params_and_clips():
    """The reference test's case on the port: an absurd clip norm makes
    a tiny update, and the reported norm is the unclipped one."""
    cfg = topt.OptimizerConfig(clip_norm=1e-6)
    params = {"w": torch.ones((4, 4))}
    grads = {"w": torch.full((4, 4), 100.0)}
    state = topt.adamw_init(params, cfg)
    before = params["w"].clone()
    new_params, state, metrics = topt.adamw_update(params, grads, state,
                                                   cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(400.0)
    assert float((new_params["w"] - before).abs().max()) < 1e-3
    assert new_params["w"] is params["w"]    # updated in place


def test_global_norm_matches():
    rng = np.random.default_rng(8)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32)]}
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(topt.global_norm({"a": torch.from_numpy(tree["a"]),
                                  "b": [torch.from_numpy(tree["b"][0])]}))
    assert got == pytest.approx(want, rel=1e-6)


# ------------------------------------------------------------- train step


def both(arch, seed=0, dtype="float32"):
    """(jcfg, tcfg, reference params, port params) from one JAX init: two
    periods, or one of Jamba's (its 8 layers hold every block kind)."""
    kw = dict(d_model=32, vocab=64,
              n_periods=1 if get(arch).period > 1 else 2)
    jcfg = jreduced(jget(arch), **kw)
    tcfg = reduced(get(arch), **kw)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed),
                            dtype=getattr(jnp, dtype))
    return jcfg, tcfg, jp, params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), device="cpu")


def make_batch(cfg, seed, b=4, s=16):
    """Numpy tokens and next-token labels (a few ignored with -1)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    labels = toks[:, 1:].copy()
    labels[:, -2:] = -1
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": labels.astype(np.int32)}


def as_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_layout(tcfg, jtree):
    """A reference pytree (grads or params) as the port's leaves, in the
    port's order: (name, float32 numpy) pairs."""
    conv = params_from_numpy(tcfg, jax.tree.map(np.asarray, jtree),
                             device="cpu", dtype=torch.float32)
    return [(n, f32(t)) for n, t in named_leaves(conv)]


# Jamba runs under one attention implementation: it has one attention
# layer, and the reference's compile of its step is most of the test's
# time (about 40 s a case on the CPU).
TRAIN_STEP_CASES = [(impl, arch) for impl in ("naive", "blockwise")
                    for arch in ("qwen1.5-0.5b", "llama3.2-3b",
                                 "deepseek-moe-16b", "jamba-1.5-large-398b")
                    if impl == "naive" or arch != "jamba-1.5-large-398b"]


@pytest.mark.parametrize("attention_impl,arch", TRAIN_STEP_CASES)
def test_train_step_matches(arch, attention_impl):
    """One train step from identical params, state and batch: the loss,
    the MoE aux loss, every gradient leaf (routers, expert stacks and the
    Mamba leaves included), the gradient norm and the parameters after
    the update, weight decay on (see the module docstring for the
    bounds)."""
    jcfg, tcfg, jp, tp = both(arch, seed=3)
    jo, to = opt_pair(peak_lr=1e-3, warmup_steps=0, weight_decay=0.1)
    batch = make_batch(tcfg, 4)
    (jtotal, jmet), jgrads = jax.value_and_grad(
        lambda p: jstep.loss_fn(p, jcfg, as_j(batch),
                                attention_impl=attention_impl),
        has_aux=True)(jp)
    lfn = lambda p, batch: tstep.loss_fn(  # noqa: E731
        p, tcfg, batch, attention_impl=attention_impl)
    tmet, tgrads = tstep.value_and_grad(tp, lfn, as_t(batch))
    assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]),
                                                rel=1e-5)
    assert float(tmet["aux_loss"]) == pytest.approx(
        float(jmet["aux_loss"]), rel=1e-5, abs=1e-7)
    assert (float(jmet["aux_loss"]) > 0) == (tcfg.moe is not None)
    want = port_layout(tcfg, jgrads)
    assert [n for n, _ in want] == [n for n, _ in named_leaves(tp)]
    for (name, w), g in zip(want, tgrads):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(f32(g) - w).max()) <= 1e-4 * scale, name

    jp2, _, jm = jax.jit(jstep.make_train_step(
        jcfg, jo, attention_impl=attention_impl))(
            jp, jopt.adamw_init(jp, jo), as_j(batch))
    p0 = [f32(t) for t in leaves(tp)]
    tp2, ts2, tm = tstep.make_train_step(
        tcfg, to, attention_impl=attention_impl)(
            tp, topt.adamw_init(tp, to), as_t(batch))
    assert int(ts2["count"]) == 1
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)
    lr = float(jm["lr"])
    for (name, w), (_, g), before, after in zip(port_layout(tcfg, jp2),
                                           port_layout(tcfg, jgrads), p0,
                                           leaves(tp2)):
        diff = np.abs(f32(after) - w)
        sure = np.abs(g) >= 1e-5
        assert np.all(diff[sure] <= 1e-2 * lr + 1e-6 * np.abs(w[sure])), \
            name
        assert np.all(diff <= 2 * lr * (1 + 0.1 * np.abs(before))
                      + 1e-6), name


@pytest.mark.parametrize("attention_impl", ["naive", "blockwise"])
def test_remat_keeps_the_gradients(attention_impl):
    """``remat`` recomputes each layer in the backward pass and changes
    no gradient bit; ``forward`` under no_grad ignores it."""
    _, tcfg, _, tp = both("llama3.2-3b", seed=6)
    batch = as_t(make_batch(tcfg, 7))
    out = []
    for remat in (True, False):
        lfn = lambda p, batch: tstep.loss_fn(  # noqa: E731
            p, tcfg, batch, attention_impl=attention_impl, remat=remat)
        out.append(tstep.value_and_grad(tp, lfn, batch))
    assert float(out[0][0]["loss"]) == float(out[1][0]["loss"])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    with torch.no_grad():
        logits, _ = tmodel.forward(tp, tcfg, tokens=batch["tokens"],
                                   attention_impl=attention_impl, remat=True)
    assert logits.grad_fn is None


def test_microbatch_accumulation():
    """Four microbatches: the same loss and gradients as the reference's
    four-microbatch step, and (the reference test's check) nearly the
    same update as one full batch."""
    jcfg, tcfg, jp, tp = both("qwen1.5-0.5b", seed=1)
    jo, to = opt_pair()
    batch = make_batch(tcfg, 5, b=8)
    lfn = lambda p, batch: tstep.loss_fn(p, tcfg, batch)  # noqa: E731
    met4, g4 = tstep.compute_grads(tp, lfn, as_t(batch), n_microbatches=4)
    _, jm4 = jax.jit(jstep.make_train_step(jcfg, jo, n_microbatches=4))(
        jp, jopt.adamw_init(jp, jo), as_j(batch))[1:]
    assert float(met4["loss"]) == pytest.approx(float(jm4["loss"]),
                                                rel=1e-5)
    assert all(g.dtype == torch.float32 for g in g4)
    tp1 = tree_map(torch.clone, tp)      # the update is in place
    p1, _, m1 = tstep.make_train_step(tcfg, to, n_microbatches=1)(
        tp1, topt.adamw_init(tp1, to), as_t(batch))
    p4, _, m4 = tstep.make_train_step(tcfg, to, n_microbatches=4)(
        tp, topt.adamw_init(tp, to), as_t(batch))
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(leaves(p1), leaves(p4))]
    assert max(diffs) < 0.05


def test_train_loss_decreases():
    """The reference test's overfit of one batch, on the port."""
    tcfg = reduced(get("qwen1.5-0.5b"), d_model=32, n_periods=1, vocab=64)
    params = tmodel.init_params(tcfg, seed=0, device="cpu")
    opt_cfg = topt.OptimizerConfig(peak_lr=5e-3, warmup_steps=2,
                                   total_steps=60)
    opt = topt.adamw_init(params, opt_cfg)
    step = tstep.make_train_step(tcfg, opt_cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, 8)))
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(30):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.7


# ------------------------------------------------------------- checkpoint


def small_tree():
    """A tree with every leaf kind the trainer saves."""
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3).to(
                torch.bfloat16),
            "b": {"c": torch.ones((4,), dtype=torch.float32)},
            "layers": [{"w": torch.full((2, 2), 0.5)}],
            "count": torch.tensor(7, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    tree = small_tree()
    path = tckpt.save_checkpoint(str(tmp_path), 7, tree, extra={"k": 1})
    assert tckpt.latest_checkpoint(str(tmp_path)) == path
    like = {k: v for k, v in small_tree().items()}
    restored, step, extra = tckpt.restore_checkpoint(path, like)
    assert step == 7 and extra == {"k": 1}
    for (na, a), (nb, b) in zip(named_leaves(tree), named_leaves(restored)):
        assert na == nb and a.dtype == b.dtype
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {**like, "b": {"c": torch.ones(5)}})
    with pytest.raises(KeyError, match="missing"):
        tckpt.restore_checkpoint(path, {**like, "z": torch.ones(1)})


def test_checkpoint_files_match_the_reference(tmp_path):
    """The same layout and manifest as the reference's, and each package
    reads the other's files (bf16 as raw 16-bit words)."""
    tree = small_tree()
    jtree = {"a": jnp.arange(6).reshape(2, 3).astype(jnp.bfloat16),
             "b": {"c": jnp.ones((4,), jnp.float32)},
             "layers": [{"w": jnp.full((2, 2), 0.5)}],
             "count": jnp.asarray(7, jnp.int32)}
    tpath = tckpt.save_checkpoint(str(tmp_path / "t"), 3, tree)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 3, jtree)
    import json
    tm = json.load(open(os.path.join(tpath, "MANIFEST.json")))
    jm = json.load(open(os.path.join(jpath, "MANIFEST.json")))
    assert tm == jm
    for f in sorted(os.listdir(os.path.join(jpath, "proc00000"))):
        a = np.load(os.path.join(tpath, "proc00000", f))
        b = np.load(os.path.join(jpath, "proc00000", f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    from_port, _, _ = jckpt.restore_checkpoint(tpath, jtree)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
    from_ref, _, _ = tckpt.restore_checkpoint(jpath, small_tree())
    for a, b in zip(leaves(from_ref), leaves(tree)):
        assert torch.equal(a, b)


def test_checkpoint_retention_and_no_tmp(tmp_path):
    tree = {"w": torch.ones(2)}
    for s in range(5):
        tckpt.save_checkpoint(str(tmp_path), s, tree, keep=2)
    entries = sorted(os.listdir(tmp_path))
    assert entries == ["step_00000003", "step_00000004"]
    assert not any(e.endswith(".tmp") for e in entries)


def test_async_checkpointer_snapshots(tmp_path):
    """Saves in order, keeps the newest, and writes the values at the
    time of ``save`` even when the tensors change in place after it."""
    ckpt = tckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.full((8, 8), 3.0)
    ckpt.save(1, {"w": w})
    w.add_(1.0)                # the trainer's in-place update
    ckpt.save(2, {"w": w})     # waits for the first
    ckpt.wait()
    assert ckpt.saved_steps == [1, 2]
    latest = tckpt.latest_checkpoint(str(tmp_path))
    assert latest.endswith("step_00000002")
    first, _, _ = tckpt.restore_checkpoint(
        str(tmp_path / "step_00000001"), {"w": w})
    assert float(first["w"][0, 0]) == 3.0


# -------------------------------------------------------- fault tolerance


def test_monitor_and_remesh_match_the_reference():
    """The copied numpy helpers give the reference's answers."""
    outs = []
    for ft in (jft, tft):
        t = [0.0]
        mon = ft.ClusterMonitor(4, heartbeat_timeout=5.0,
                                straggler_factor=1.5, clock=lambda: t[0])
        for i in range(4):
            mon.heartbeat(i, step_time_s=1.0 + (0.1 if i else 0.0))
        t[0] = 3.0
        for i in range(3):
            mon.heartbeat(i, step_time_s=1.0)
        mon.heartbeat(2, step_time_s=5.0)
        mon.heartbeat(2, step_time_s=5.0)
        t[0] = 7.0
        plan = ft.plan_elastic_remesh(
            n_hosts_alive=3, model_parallel=1,
            shard_sizes={i: 100 for i in range(8)},
            shard_layer={i: i // 2 for i in range(8)},
            lost_host_shards=[6, 7], host_budget_bytes=400,
            current_host={0: 0, 1: 0, 2: 1, 3: 1, 4: 2, 5: 2, 6: 3, 7: 3})
        outs.append((mon.dead_nodes(), dataclasses.asdict(mon.stragglers()),
                     dataclasses.asdict(plan)))
    assert outs[0] == outs[1]
    assert outs[1][0] == [3] and 2 in outs[1][1]["stragglers"]
    assert outs[1][2]["shard_moves"][6] == outs[1][2]["shard_moves"][7]


def test_supervisor_restart_is_deterministic(tmp_path):
    """Training with injected failures == uninterrupted training, bit for
    bit (the reference test, on the port's step and checkpoints)."""
    tcfg = reduced(get("qwen1.5-0.5b"), d_model=32, n_periods=1, vocab=64)
    opt_cfg = topt.OptimizerConfig(peak_lr=1e-3, total_steps=30)
    step = tstep.make_train_step(tcfg, opt_cfg)
    batches = [as_t(make_batch(tcfg, 100 + i, s=8)) for i in range(12)]

    def fresh_state():
        params = tmodel.init_params(tcfg, seed=2, device="cpu")
        return {"step": 0, "params": params,
                "opt": topt.adamw_init(params, opt_cfg)}

    def run(failures, ckdir):
        ck = tckpt.AsyncCheckpointer(ckdir, keep=2)
        st0 = fresh_state()
        tckpt.save_checkpoint(ckdir, 0, {"params": st0["params"],
                                         "opt": st0["opt"]})

        def step_fn(state):
            p, o, _ = step(state["params"], state["opt"],
                           batches[state["step"]])
            return {"step": state["step"] + 1, "params": p, "opt": o,
                    "tree": {"params": p, "opt": o}}

        def restore():
            latest = tckpt.latest_checkpoint(ckdir)
            like = {"params": st0["params"], "opt": st0["opt"]}
            tree, s, _ = tckpt.restore_checkpoint(latest, like)
            return {"step": s, "params": tree["params"], "opt": tree["opt"],
                    "tree": tree}

        sup = tft.TrainingSupervisor(ck, restore, ckpt_every=4)
        state = {"step": 0, "params": st0["params"], "opt": st0["opt"],
                 "tree": {"params": st0["params"], "opt": st0["opt"]}}
        return sup.run(state, step_fn, total_steps=12,
                       failure_at=set(failures))

    clean = run([], str(tmp_path / "a"))
    faulty = run([5, 9], str(tmp_path / "b"))
    for a, b in zip(leaves(clean["params"]), leaves(faulty["params"])):
        assert torch.equal(a, b)


# --------------------------------------------------------------- launcher


def test_launcher_trains_and_resumes(tmp_path, capsys):
    """The training entry point on the CPU: finite losses, the pipeline's
    cache hits, and a second run that resumes from the last checkpoint
    with the pipeline's state."""
    args = ["--device", "cpu", "--arch", "llama3.2-3b", "--d-model", "32",
            "--periods", "1", "--batch", "4", "--seq", "16", "--vocab",
            "64", "--log-every", "2", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "3", "--data-dir", str(tmp_path / "data")]
    out = tlaunch.main(args + ["--steps", "6"])
    assert len(out["losses"]) == 6 and np.all(np.isfinite(out["losses"]))
    stats = out["pipeline_stats"]
    assert stats.steps == 6 and stats.cache_hit_steps > 0
    log = capsys.readouterr().out
    assert "step     0 loss" in log and "data pipeline:" in log
    again = tlaunch.main(args + ["--steps", "8", "--data-dir",
                                 str(tmp_path / "data2")])
    assert "restored step 6" in capsys.readouterr().out
    assert len(again["losses"]) == 2


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-125m"])
def test_launcher_trains_moe_and_ssm(arch, tmp_path):
    """The training entry point runs an MoE and an attention-free
    architecture: finite losses from the pipeline's batches."""
    out = tlaunch.main(["--device", "cpu", "--arch", arch, "--d-model",
                        "32", "--periods", "1", "--batch", "2", "--seq",
                        "16", "--vocab", "64", "--steps", "3",
                        "--data-dir", str(tmp_path / "data")])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))
