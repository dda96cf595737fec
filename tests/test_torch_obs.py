"""The port's tracer and telemetry on the training path, on the CPU.

Spans on more than one thread (each its own stack; a thread with none
open hangs its spans under the creating thread's innermost); every live
span a ``torch.profiler`` user annotation of the same name and interval;
the no-op tracer opening no profiler range; a telemetry made off that
starts and stops; one step of a reduced MoE model traced (the same bits
as untraced, the span tree of forward, backward and optimizer, the
recomputed layers under the backward) and its routing counted once per
layer, with and without remat.
"""
import dataclasses
import os
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.obs import (NULL_TELEMETRY, NULL_TRACER, Telemetry,  # noqa: E402
                             Tracer)
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.tree import leaves  # noqa: E402

B, S = 2, 16


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def children(spans, parent):
    return [s for s in spans if s.parent_id == parent.span_id]


# ------------------------------------------------------------------ tracer


def test_spans_on_two_threads_parent_and_close_apart():
    """A worker thread's first span hangs under the creating thread's
    innermost open span, its second under its first; the creating
    thread's spans ignore the worker's; closing the outer span leaves
    the worker's open, and each span records its thread's native id."""
    tracer = Tracer()
    opened, resume, done = threading.Event(), threading.Event(), \
        threading.Event()
    worker = {}

    def work():
        worker["tid"] = threading.get_native_id()
        worker["a"] = tracer.begin("a")
        worker["b"] = tracer.begin("b")
        opened.set()
        resume.wait(5)
        tracer.end(worker["a"])
        done.set()

    outer = tracer.begin("outer")
    th = threading.Thread(target=work)
    th.start()
    assert opened.wait(5)
    inner = tracer.begin("inner")
    assert inner.parent_id == outer.span_id
    tracer.end(outer)
    assert inner.end is not None and outer.end is not None
    assert worker["a"].end is None and worker["b"].end is None
    resume.set()
    assert done.wait(5)
    th.join()
    a, b = worker["a"], worker["b"]
    assert a.parent_id == outer.span_id and b.parent_id == a.span_id
    assert b.end is not None and a.end >= b.end
    assert outer.tid == inner.tid == threading.get_native_id()
    assert a.tid == b.tid == worker["tid"] != outer.tid
    # with nothing open on the creating thread, a worker's span is a root
    th = threading.Thread(target=lambda: worker.update(c=tracer.begin("c")))
    th.start()
    th.join()
    assert worker["c"].parent_id is None


def test_spans_from_many_threads_keep_their_own_stacks():
    """More threads than cores open and close nested spans under a
    short switch interval: every id is unique, every span closed, and
    each span's parent is its own thread's enclosing span or, for a
    thread's outermost, the creating thread's open one."""
    tracer = Tracer()
    root = tracer.begin("root")
    n_threads, depth, rounds = 4 * (os.cpu_count() or 1), 3, 20

    def work():
        for _ in range(rounds):
            opened = [tracer.begin(f"d{i}") for i in range(depth)]
            tracer.end(opened[0])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    tracer.end(root)
    spans = {s.span_id: s for s in tracer.spans}
    assert len(spans) == len(tracer.spans) == \
        1 + n_threads * depth * rounds
    assert all(s.end is not None for s in tracer.spans)
    for s in tracer.spans[1:]:
        if s.name == "d0":
            assert s.parent_id == root.span_id
        else:
            parent = spans[s.parent_id]
            assert parent.tid == s.tid and \
                parent.name == f"d{int(s.name[1:]) - 1}"


def profiled_spans():
    """Three live spans (one nested) under a CPU profiler: the tracer and
    its spans' user annotations by name."""
    tracer = Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with Tracer().span("warm-up"):
            pass
        with tracer.span("first"):
            time.sleep(0.003)
            with tracer.span("nested", k=1):
                time.sleep(0.002)
        time.sleep(0.001)
        with tracer.span("second"):
            time.sleep(0.002)
    events = prof.profiler.kineto_results.events()
    return tracer, {e.name(): e for e in events if e.is_user_annotation()}


def test_live_spans_are_profiler_annotations():
    """Under a CPU profiler every span of a live tracer is a user
    annotation of the same name whose start (from the first span) and
    length match the tracer's within 100 us. A process's first range pays
    a one-time cost of about a millisecond inside it, so a range opens
    first; a thread preempted between the profiler's stamp and the
    tracer's clock read shifts one reading by the preemption, so the
    match must hold in one of three tries (each try's names in all)."""
    worst = []
    for _ in range(3):
        tracer, annots = profiled_spans()
        assert {s.name for s in tracer.spans} <= set(annots)
        t0_ns = annots["first"].start_ns()
        t0 = tracer.spans[0].start
        worst.append(max(
            max(abs((e.start_ns() - t0_ns) / 1e9 - (s.start - t0)),
                abs((e.end_ns() - e.start_ns()) / 1e9 - s.duration_s))
            for s in tracer.spans for e in [annots[s.name]]))
        if worst[-1] < 1e-4:
            break
    assert min(worst) < 1e-4, worst


def test_null_tracer_opens_no_profiler_range(monkeypatch):
    """The off tracer never makes a ``record_function``; a live one
    makes one a span (so the count below would see them)."""
    made = []
    real = torch.profiler.record_function

    def counting(name, *args):
        made.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    with NULL_TRACER.span("x", k=1):
        NULL_TRACER.end(NULL_TRACER.begin("y"))
    with NULL_TELEMETRY.tracer.span("z"):
        pass
    assert made == []
    with Tracer().span("live"):
        pass
    assert made == ["live"]


def test_telemetry_made_off_starts_and_stops():
    """A telemetry made off records only between ``start`` and
    ``stop``, a fresh recording each time; the shared off bundle
    refuses to start."""
    tel = Telemetry(mode="off")
    assert tel.tracer is NULL_TRACER and not tel.enabled
    with pytest.raises(RuntimeError):
        tel.stop()
    tel.start()
    with pytest.raises(RuntimeError):
        tel.start()
    with tel.tracer.span("a"):
        tel.count("n", 2)
        tel.count("dev", torch.tensor(3))
        tel.count("dev", torch.tensor(4))
    rec = tel.stop()
    assert [s.name for s in rec.tracer.spans] == ["a"]
    assert rec.registry.counter("n").value == 2
    assert rec.registry.counter("dev").value == 7
    assert tel.tracer is NULL_TRACER and not tel.counting
    tel.count("n", 5)
    tel.start()
    assert tel.tracer.spans == [] and tel.registry.counter("n").value == 0
    tel.stop()
    with pytest.raises(RuntimeError):
        NULL_TELEMETRY.start()


# ------------------------------------------------------------- train step


def moe_config(capacity_factor=1.0):
    """Reduced deepseek-moe in fp32, two MoE layers, a capacity that
    drops pairs."""
    cfg = reduced(get("deepseek-moe-16b"), d_model=32, n_periods=2,
                  vocab=64)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=capacity_factor))


def batch_of(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def one_step(cfg, telemetry, remat=True):
    """(params, opt state, metrics) after one step from seed 3."""
    params = tmodel.init_params(cfg, seed=3, dtype=torch.float32,
                                device="cpu")
    opt_cfg = topt.OptimizerConfig(peak_lr=1e-2, warmup_steps=1)
    state = topt.adamw_init(params, opt_cfg)
    step = tstep.make_train_step(cfg, opt_cfg, remat=remat,
                                 telemetry=telemetry)
    return step(params, state, batch_of(cfg))


def traced_step(cfg, remat=True):
    tel = Telemetry(mode="off")
    tel.start()
    out = one_step(cfg, tel, remat)
    return out, tel.stop()


def test_traced_step_is_bit_identical_to_untraced():
    cfg = moe_config()
    (p1, s1, m1), _ = traced_step(cfg)
    p0, s0, m0 = one_step(cfg, NULL_TELEMETRY)
    assert torch.equal(m1["loss"], m0["loss"])
    for tree in ("m", "v"):
        for a, b in zip(leaves(s1[tree]), leaves(s0[tree])):
            assert torch.equal(a, b)
    for a, b in zip(leaves(p1), leaves(p0)):
        assert torch.equal(a, b)


def test_train_step_span_tree():
    """``train.step`` > forward, backward, optimizer; one ``model.layer``
    a layer and the head under the forward, every layer recomputed
    under the backward (last first), the MoE stages under each layer, the clipping
    norm and the per-leaf loop under the optimizer."""
    cfg = moe_config()
    _, rec = traced_step(cfg)
    spans = rec.tracer.spans
    (root,) = [s for s in spans if s.parent_id is None]
    assert root.name == "train.step"
    fwd, bwd, opt = children(spans, root)
    assert (fwd.name, bwd.name, opt.name) == \
        ("train.forward", "train.backward", "train.optimizer")
    assert fwd.end <= bwd.start and bwd.end <= opt.start
    order = list(range(cfg.n_layers))
    for phase, want in ((fwd, order), (bwd, order[::-1])):
        layers = [s for s in children(spans, phase)
                  if s.name == "model.layer"]
        assert [s.args["layer"] for s in layers] == want
        for layer in layers:
            assert [s.name for s in children(spans, layer)] == \
                ["moe.route", "moe.dispatch", "moe.experts",
                 "moe.combine", "moe.shared"]
    assert [s.name for s in children(spans, fwd)][-1] == "model.head"
    assert [s.name for s in children(spans, opt)] == \
        ["optimizer.norm", "optimizer.adamw"]
    assert all(s.end is not None for s in spans)


@pytest.mark.parametrize("remat", [True, False])
def test_moe_counters_count_each_layer_once(remat, monkeypatch):
    """``moe.kept_pairs`` is the sum of ``Routing.keep`` over the
    layers of the step's forward (the recompute is not counted again),
    ``moe.pairs`` and ``moe.slots`` the layers' T * K and E * C."""
    cfg = moe_config()
    routings = []
    real = tmoe.route

    def keep_routing(*args):
        r = real(*args)
        routings.append(r)
        return r

    params = tmodel.init_params(cfg, seed=3, dtype=torch.float32,
                                device="cpu")
    monkeypatch.setattr(tmoe, "route", keep_routing)
    with torch.no_grad():
        tmodel.forward(params, cfg, tokens=batch_of(cfg)["tokens"])
    monkeypatch.setattr(tmoe, "route", real)
    assert len(routings) == cfg.n_layers
    kept = sum(int(r.keep.sum()) for r in routings)
    assert 0 < kept < cfg.n_layers * B * S * cfg.moe.top_k
    _, rec = traced_step(cfg, remat)
    reg = rec.registry
    assert reg.counter("moe.kept_pairs").value == kept
    assert reg.counter("moe.pairs").value == \
        cfg.n_layers * B * S * cfg.moe.top_k
    assert reg.counter("moe.slots").value == \
        sum(cfg.moe.n_experts * r.capacity for r in routings)


def test_launcher_traces_the_pipeline_and_the_step(tmp_path):
    """The launcher's telemetry reaches the pipeline's cluster, the
    batch's placement, the step and the read back."""
    tel = Telemetry(mode="off")
    tel.start()
    tlaunch.main(["--device", "cpu", "--arch", "deepseek-moe-16b",
                  "--d-model", "32", "--periods", "1", "--batch", "2",
                  "--seq", "16", "--vocab", "64", "--steps", "2",
                  "--data-dir", str(tmp_path / "data")], telemetry=tel)
    rec = tel.stop()
    spans = rec.tracer.spans
    roots = [s.name for s in spans if s.parent_id is None]
    assert roots == ["pipeline.next_batch", "launch.place_batch",
                     "train.step", "launch.readback"] * 2
    for nb in by_name(spans, "pipeline.next_batch"):
        assert [s.name for s in children(spans, nb)] == \
            ["query", "pipeline.assemble"]
    assert len(by_name(spans, "moe.route")) == 4   # 1 layer, recomputed
    # the placed layer (DTensor parameters) counts too: steps x B x S x
    # top-k pairs, of which the reduced config's capacity drops none
    assert rec.registry.counter("moe.kept_pairs").value == \
        rec.registry.counter("moe.pairs").value == 2 * 2 * 16 * 2
