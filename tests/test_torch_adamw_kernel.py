"""The AdamW kernels (``repro_torch.kernels.adamw``) and the optimizer's
route to them: on the CPU, the counters of what each route updated, the
train step's ``impl`` reaching the update, and the update seen as the
kernels' two ops under a dispatch mode (what a dry-run charges it); on
the card, the kernels against the plain version over every dtype triple
they take, ragged, misaligned and more leaves than one launch holds.

The JAX reference is compared in tests/test_torch_train.py; this file
imports no JAX, so its card test runs where JAX is absent."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.kernels.adamw import adamw as kadamw  # noqa: E402
from repro_torch.models.model import init_params  # noqa: E402
from repro_torch.obs.telemetry import Telemetry  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

SHAPES = {"w": (64, 32), "b": (32,), "stack": (2, 3, 5)}


def tree(dtype, device="cpu", seed=0):
    """Random leaves of :data:`SHAPES`."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=gen).to(dtype).to(device)
            for k, s in SHAPES.items()}


def test_counters_name_the_route():
    """CPU leaves take the plain version under either ``impl``: every
    element counts as plain, none as the kernel's."""
    cfg = topt.OptimizerConfig()
    n = sum(torch.Size(s).numel() for s in SHAPES.values())
    for impl in ("kernel", "plain"):
        params = tree(torch.float32)
        tel = Telemetry(mode="off")
        tel.start()
        topt.adamw_update(params, tree(torch.float32, seed=1),
                          topt.adamw_init(params, cfg), cfg, telemetry=tel,
                          impl=impl)
        rec = tel.stop()
        assert rec.registry.counter("optimizer.plain_elements").value == n
        assert rec.registry.counter("optimizer.kernel_elements").value == 0
    with pytest.raises(ValueError, match="unknown impl"):
        topt.adamw_update(params, params, topt.adamw_init(params, cfg), cfg,
                          impl="fused")


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_train_step_impl_reaches_the_update(impl, monkeypatch):
    """``make_train_step(impl=...)`` hands its ``impl`` to
    ``adamw_update``."""
    seen = []
    real = tstep.adamw_update

    def spy(*args, **kw):
        seen.append(args[6] if len(args) > 6 else kw.get("impl"))
        return real(*args, **kw)

    monkeypatch.setattr(tstep, "adamw_update", spy)
    cfg = reduced(get("llama3.2-3b"), d_model=32, vocab=64, n_periods=1)
    params = init_params(cfg, seed=0, device="cpu")
    step = tstep.make_train_step(cfg, remat=False, impl=impl)
    tokens = torch.randint(0, 64, (2, 8))
    step(params, topt.adamw_init(params, topt.OptimizerConfig()),
         {"tokens": tokens, "labels": tokens})
    assert seen == [impl]


def test_update_is_two_kernel_ops_under_a_dispatch_mode():
    """On fake leaves (a dry-run) the update is the kernels' two ops, and
    the op analyzer charges them what the kernels move: each gradient
    read once for the norm, then 22 bytes a bf16 parameter with fp32
    moments (p, g, m, v read, p, m, v written)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.op_analysis import OpAnalyzer
    cfg = topt.OptimizerConfig()
    with FakeTensorMode():
        params = {k: torch.empty(s, dtype=torch.bfloat16)
                  for k, s in SHAPES.items()}
        grads = {k: torch.empty_like(v) for k, v in params.items()}
        state = topt.adamw_init(params, cfg)
        analyzer = OpAnalyzer(record_ops=True)
        with analyzer:
            _, state, metrics = topt.adamw_update(params, grads, state, cfg)
        assert state["count"].dtype == torch.int32
        assert metrics["grad_norm"].shape == ()
    table = {row[0]: row for row in analyzer.op_table()}
    assert set(table) == {"repro_torch.adamw_sum_squares",
                          "repro_torch.adamw_apply"}
    n = sum(torch.Size(s).numel() for s in SHAPES.values())
    k = len(SHAPES)
    assert table["repro_torch.adamw_sum_squares"][3] == 2 * n + 4 * k
    # sumsq (4 k), count (4), and the three 0-dim outputs (12).
    assert table["repro_torch.adamw_apply"][3] == 22 * n + 4 * k + 16
    assert analyzer.cost.seq_iters == 2


# ------------------------------------------------------------ on the card


def _need_card():
    """Skip where there is no card (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc there)")


# (param, grad, moment) dtypes the kernel is instantiated for.
TRIPLES = {
    "f32": (torch.float32, torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.bfloat16, torch.float32),
    "bf16_f32_grads": (torch.bfloat16, torch.float32, torch.float32),
    "bf16_bf16_state": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
    "f32_bf16_state": (torch.float32, torch.float32, torch.bfloat16),
    "f32_bf16_grads": (torch.float32, torch.bfloat16, torch.float32),
}


#: The card tree's leaf whose data starts off a 16-byte boundary.
MISALIGNED = 2


def alloc(x, i, dev):
    """An uninitialised tensor shaped like ``x``, on ``dev``; for leaf
    :data:`MISALIGNED` one whose data starts one element past a 16-byte
    boundary."""
    if i != MISALIGNED:
        return torch.empty(x.shape, dtype=x.dtype, device=dev)
    return torch.empty(x.numel() + 1, dtype=x.dtype,
                       device=dev)[1:].view(x.shape)


def card_tree(pd, gd, md, seed):
    """Parameters, gradients and moments (as after an earlier step, so
    nonzero) on the host: ragged leaves, leaves of several chunks, and
    more leaves than one launch takes."""
    gen = torch.Generator().manual_seed(seed)
    shapes = [(1,), (7,), (33, 65), (3, 32768 + 5), (2, 40000), (4096,)]
    shapes += [(17, 3)] * 70
    out = {"p": [], "g": [], "m": [], "v": []}
    for s in shapes:
        for key, dtype, scale in (("p", pd, 1.0), ("g", gd, 0.5),
                                  ("m", md, 0.05), ("v", md, 0.01)):
            x = torch.randn(s, generator=gen) * scale
            out[key].append((x.abs() if key == "v" else x).to(dtype))
    out["decay"] = [len(s) >= 2 for s in shapes]
    return out


def on_card(tree, dev, gscale=1.0):
    """The tree copied to ``dev`` (gradients times ``gscale``)."""
    out = {"decay": tree["decay"]}
    for key in ("p", "g", "m", "v"):
        out[key] = [alloc(x, i, dev).copy_(x * gscale if key == "g" else x)
                    for i, x in enumerate(tree[key])]
    return out


def close(got, want, dtype, what):
    """Within one ulp of ``dtype`` at each value (bf16: 8 significant
    bits) or 1e-6 relative (float32), or 1e-6 of the leaf's largest
    magnitude (where the update cancels to near zero)."""
    got, want = got.float().cpu(), want.float().cpu()
    floor = 1e-6 * float(want.abs().max())
    if dtype == torch.bfloat16:
        bound = torch.exp2(torch.floor(torch.log2(want.abs())) - 7) * 1.0001
    else:
        bound = 1e-6 * want.abs()
    bad = ~((got - want).abs() <= torch.clamp(bound, min=floor))
    assert not bool(bad.any()), (what, float((got - want).abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("triple", sorted(TRIPLES))
def test_kernel_matches_plain_on_card(triple):
    """Three steps (the second clipped) of the kernels against the plain
    version on the same tree (:func:`close`); the kernels' bits equal on
    a second run; 2 + 2 + 1 + 2 launches a step (the 76 leaves are two
    launches' worth)."""
    _need_card()
    pd, gd, md = TRIPLES[triple]
    dev = torch.device("cuda", 0)
    host = card_tree(pd, gd, md, 3)
    cfg = topt.OptimizerConfig(warmup_steps=1, weight_decay=0.1)
    hyper = [float(getattr(cfg, f)) for f in kadamw.HYPER_FIELDS]
    runs = []
    for impl in ("plain", "kernel", "kernel"):
        t = on_card(host, dev)
        count = torch.zeros((), dtype=torch.int32, device=dev)
        metrics = []
        before = kadamw.LAUNCHES["adamw"]
        for gscale in (1.0, 1e3, 0.1):
            grads = on_card(host, dev, gscale)["g"]
            if impl == "plain":
                gnorm = topt.global_norm(grads)
                count, lr, scale, bc1, bc2 = topt.step_scalars(cfg, count,
                                                               gnorm)
                for p, g, m, v, dk in zip(t["p"], grads, t["m"], t["v"],
                                          t["decay"]):
                    topt.update_leaf(p, g, m, v, dk, scale, lr, bc1, bc2,
                                     cfg)
            else:
                count, lr, gnorm = kadamw.adamw_apply(
                    t["p"], grads, t["m"], t["v"], kadamw.sum_squares(grads),
                    count, t["decay"], hyper)
            metrics.append((int(count), float(lr), float(gnorm)))
        torch.cuda.synchronize()
        if impl == "kernel":
            assert kadamw.LAUNCHES["adamw"] - before == 3 * 7
        runs.append((t, metrics))
    (plain, pm), (kern, km), (again, am) = runs
    assert km == am
    for key in ("p", "m", "v"):
        for a, b in zip(kern[key], again[key]):
            assert torch.equal(a, b), key
    for (c0, lr0, g0), (c1, lr1, g1) in zip(pm, km):
        assert c0 == c1
        assert lr1 == pytest.approx(lr0, rel=1e-6)
        assert g1 == pytest.approx(g0, rel=1e-5)
    for key, dtype in (("p", pd), ("m", md), ("v", md)):
        for i, (want, got) in enumerate(zip(plain[key], kern[key])):
            close(got, want, dtype, f"{key} {i}")


@pytest.mark.cuda
def test_update_on_card_takes_the_kernels():
    """``adamw_update(impl="kernel")`` on CUDA leaves launches the kernels
    (four launches for one batch of one dtype) and counts every element
    as the kernel's; ``impl="plain"`` launches none."""
    _need_card()
    dev = torch.device("cuda", 0)
    cfg = topt.OptimizerConfig()
    n = sum(torch.Size(s).numel() for s in SHAPES.values())
    for impl, launches in (("kernel", 4), ("plain", 0)):
        params = tree(torch.bfloat16, dev)
        tel = Telemetry(mode="off")
        tel.start()
        before = kadamw.LAUNCHES["adamw"]
        topt.adamw_update(params, tree(torch.bfloat16, dev, seed=1),
                          topt.adamw_init(params, cfg), cfg, telemetry=tel,
                          impl=impl)
        torch.cuda.synchronize()
        rec = tel.stop()
        assert kadamw.LAUNCHES["adamw"] - before == launches
        name = "kernel" if impl == "kernel" else "plain"
        assert rec.registry.counter(f"optimizer.{name}_elements").value == n
    assert len(leaves(params)) == len(SHAPES)
