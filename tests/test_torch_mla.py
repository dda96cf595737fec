"""The port's Moonlight (DeepSeek-V3's layer: latent attention, a
sigmoid router with a balancing bias, a chip's share of the experts)
against the benchmark's plain float32 reference
(``portbench/reference/mla_moe_lm.py``, plain PyTorch), on the CPU at a
tiny size: the loss and every leaf's gradient, the expert shares adding
up to the uncut layer, and the balancing bias's update outside AdamW.

The tiny model keeps the published head widths (q/k heads 128 + 64,
value heads 128: the flash kernels' pair), with 2 heads over d_model 64,
1 dense and 2 MoE layers, 16 routed experts of which a layer holds 8,
top-6, and sequences long enough that the capacity drops pairs."""
import dataclasses
import math
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.reference import mla_moe_lm as ref  # noqa: E402
from repro_torch.configs import get  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.obs.telemetry import Telemetry  # noqa: E402
from repro_torch.train import train_step as tstep  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_init)
from repro_torch.train.tree import named_leaves  # noqa: E402

#: The tiny model in the reference's (Hugging Face) keys.
CONF = {"hidden_size": 64, "num_attention_heads": 2,
        "num_key_value_heads": 2, "kv_lora_rank": 32,
        "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
        "intermediate_size": 96, "moe_intermediate_size": 24,
        "n_routed_experts": 8, "router_experts": 16, "held_offset": 0,
        "num_experts_per_tok": 6, "n_shared_experts": 2,
        "first_k_dense_replace": 1, "num_hidden_layers": 3,
        "vocab_size": 128, "rms_norm_eps": 1e-5, "rope_theta": 50000.0,
        "norm_topk_prob": True, "routed_scaling_factor": 2.446,
        "capacity_factor": 1.25, "aux_loss_alpha": 0.001,
        "bias_update_speed": 0.001, "torch_dtype": "float32"}
B, S = 2, 96
TOL = 1e-5


def port_config(conf=CONF):
    """The port's config of ``conf``: the registered Moonlight with the
    tiny sizes."""
    cfg = get("moonlight-16b-a3b")
    return dataclasses.replace(
        cfg, n_layers=conf["num_hidden_layers"],
        d_model=conf["hidden_size"], n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        dense_prefix=conf["first_k_dense_replace"],
        mla=dataclasses.replace(cfg.mla, kv_rank=conf["kv_lora_rank"]),
        moe=dataclasses.replace(
            cfg.moe, n_experts=conf["router_experts"],
            n_held=conf["n_routed_experts"],
            held_offset=conf["held_offset"],
            d_expert=conf["moe_intermediate_size"],
            n_shared=conf["n_shared_experts"]))


def batch(seed=0, vocab=CONF["vocab_size"]):
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(1, vocab, (B, S), generator=gen)
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def test_port_config_counts_the_reference_leaves():
    """The port's analytic count of the tiny model equals the
    reference's leaves (balancing biases aside), and its tree has the
    reference's leaf names and shapes."""
    cfg = port_config()
    leaves = ref.make_params(CONF, 1, "cpu")
    trained = sum(t.numel() for n, t in leaves.items()
                  if not n.endswith(tmoe.BIAS))
    assert cfg.param_count() == trained
    port = tmodel.init_params(cfg, device="cpu", dtype=torch.float32)
    assert {n: tuple(t.shape) for n, t in named_leaves(port)} == \
        {n: tuple(t.shape) for n, t in leaves.items()}


@pytest.mark.parametrize("attention_impl", ["naive", "blockwise"])
@pytest.mark.parametrize("offset", [0, 8])
def test_loss_and_gradients_match_reference(attention_impl, offset):
    """Loss (cross entropy and the sequence-wise balance loss) and every
    trained leaf's gradient of the port against the reference in
    float32: naive attention and the flash path's plain versions, each
    share of the experts; the capacity drops held pairs."""
    conf = dict(CONF, held_offset=offset)
    cfg = port_config(conf)
    leaves = ref.make_params(conf, 3, "cpu")
    for n in leaves:
        if n.endswith(tmoe.BIAS):     # a bias that moves the choice
            leaves[n] = torch.linspace(-0.05, 0.05, leaves[n].numel())
    bt = batch(offset)
    names = sorted(n for n in leaves if not n.endswith(tmoe.BIAS))
    want_leaves = {n: t.clone().requires_grad_(n in names)
                   for n, t in leaves.items()}
    total, ce, aux, loads = ref.loss_terms(want_leaves, bt, conf)
    want = torch.autograd.grad(total, [want_leaves[n] for n in names])

    tree = ref.as_tree({n: t.clone() for n, t in leaves.items()})
    tel = Telemetry(mode="on")
    metrics, grads = tstep.value_and_grad(
        tree, lambda p, batch: tstep.loss_fn(
            p, cfg, batch, attention_impl=attention_impl, remat=True,
            telemetry=tel), bt)
    rec = tel.stop()
    got = dict(zip([n for n, _ in named_leaves(tree)], grads))
    held = rec.registry.counter("moe.held_pairs").value
    kept = rec.registry.counter("moe.kept_pairs").value
    assert 0 < kept < held, (kept, held)
    ce, aux = float(ce.detach()), float(aux.detach())
    assert abs(float(metrics["loss"]) - ce) <= TOL * ce
    assert abs(float(metrics["aux_loss"]) - aux) <= TOL * aux
    assert torch.equal(metrics["expert_load"], loads)
    for n, w in zip(names, want):
        g = got[n]
        scale = max(float(w.abs().max()), 1e-12)
        assert float((g - w).abs().max()) <= 1e-4 * scale, n
    for n in leaves:
        if n.endswith(tmoe.BIAS):
            assert not got[n].any(), f"{n} took a gradient"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expert_shares_add_up_to_the_uncut_layer(seed):
    """The routed parts that every 8-expert share of 16 gives, plus the
    shared experts once, equal the uncut layer of the reference (and of
    the port) on the same input: each share routes over all 16 experts,
    keeps the same pairs and computes its own experts' part."""
    full = dict(CONF, n_routed_experts=16)
    leaves = ref.make_params(full, 10 + seed, "cpu")
    p = ref._layer_leaves(leaves, 1)
    p[tmoe.BIAS] = torch.randn(16, generator=torch.Generator().manual_seed(
        seed)) * 0.05
    x = torch.randn((B, S, CONF["hidden_size"]),
                    generator=torch.Generator().manual_seed(100 + seed))
    m = ref._Math("fp32")
    want, _, _ = ref._moe(x, p, full, m)
    shared = ref._swiglu(x, p["sh_in"], p["sh_gate"], p["sh_out"], m)
    routed = torch.zeros_like(x)
    port_routed = torch.zeros_like(x)
    for off in (0, 8):
        part = dict(p, w_in=p["w_in"][off:off + 8],
                    w_gate=p["w_gate"][off:off + 8],
                    w_out=p["w_out"][off:off + 8])
        conf = dict(CONF, held_offset=off)
        y, _, _ = ref._moe(x, part, conf, m)
        routed += y - shared
        y, _ = tmoe.moe_forward(part, x, port_config(conf))
        port_routed += y - shared
    torch.testing.assert_close(routed + shared, want, rtol=TOL, atol=TOL)
    torch.testing.assert_close(port_routed + shared, want, rtol=1e-4,
                               atol=1e-5)


def test_absent_experts_take_no_slot():
    """Pairs chosen for an absent expert (or dropped) are never
    dispatched: the held experts' slots and the live pairs are inverse
    maps of each other, every filled slot's row is its pair's token, an
    empty slot is zeros, and every other pair has no slot."""
    cfg = port_config()
    x = torch.randn(B * S, CONF["hidden_size"])
    router = torch.randn(CONF["hidden_size"], 16) * 0.2
    bias = torch.zeros(16)
    bias[1:3] = 1.0                  # two held experts over capacity
    r = tmoe.route(router, x, cfg, bias, S)
    xe, how = tmoe._dispatch(x, r, 16, False, cfg)
    T, K = r.experts.shape
    C = r.capacity
    slot, src = how[:T * K].view(T, K), how[T * K:]
    assert xe.shape == (8, C, CONF["hidden_size"])
    live = r.keep & r.held
    assert 0 < int(live.sum()) < int(r.held.sum())       # some dropped
    assert bool((slot[live] < 8 * C).all())
    assert bool((slot[~live] == 8 * C).all())
    filled = src < T * K
    assert int(filled.sum()) == int(live.sum())
    assert torch.equal(slot.reshape(-1)[src[filled]],
                       torch.arange(8 * C)[filled])
    rows = xe.reshape(8 * C, -1)
    assert torch.equal(rows[filled], x[src[filled] // K])
    assert not rows[~filled].any()


@pytest.mark.parametrize("weight_decay,clip_norm", [(0.0, 1e3),
                                                     (0.5, 1e-3)])
def test_bias_moves_by_its_sign_rule_outside_adamw(weight_decay, clip_norm):
    """One train step moves each MoE layer's bias by exactly gamma *
    sign(mean load - load) of that step's routing, whatever AdamW's
    decay and clipping; the optimizer's state holds no bias leaf; every
    other leaf is AdamW's."""
    cfg = port_config()
    tree = ref.as_tree(ref.make_params(CONF, 5, "cpu"))
    opt = OptimizerConfig(peak_lr=1e-2, warmup_steps=1,
                          weight_decay=weight_decay, clip_norm=clip_norm)
    state = adamw_init(tree, opt)
    assert not [n for n, _ in named_leaves(state["m"])
                if n.endswith(tmoe.BIAS)]
    bt = batch(7)
    _, metrics = tstep.loss_fn(tree, cfg, bt)
    load = metrics["expert_load"].float()
    before = [b.clone() for b in tstep.bias_leaves(tree)]
    step = tstep.make_train_step(cfg, opt)
    tree, state, _ = step(tree, state, bt)
    after = tstep.bias_leaves(tree)
    assert len(after) == 2
    for i, (b0, b1) in enumerate(zip(before, after)):
        want = b0 + 0.001 * torch.sign(load[i].mean() - load[i])
        assert torch.equal(b1, want), i
        assert bool((load[i] != load[i].mean()).any())


def test_bias_sign_rule():
    """``balance_biases``: an expert above the mean load goes down by
    gamma, one below goes up, one at the mean stays."""
    cfg = port_config()
    tree = {"layers": [{"mlp": {}}, {"mlp": {tmoe.BIAS: torch.zeros(4)}}]}
    tstep.balance_biases(tree, torch.tensor([[1, 3, 2, 2]]), cfg)
    torch.testing.assert_close(tree["layers"][1]["mlp"][tmoe.BIAS],
                               torch.tensor([0.001, -0.001, 0.0, 0.0]))


def test_reference_train_moves_its_biases():
    """The reference's train step moves its biases by the same rule from
    its own loads, and they take no part in its gradients."""
    conf = dict(CONF, num_hidden_layers=2)
    bt = batch(11)
    out = ref.train(conf, {"peak_lr": 1e-3, "min_lr": 1e-4,
                           "warmup_steps": 1, "total_steps": 10, "b1": 0.9,
                           "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                           "clip_norm": 1.0}, 4, [bt], "cpu")
    leaves = ref.make_params(conf, 4, "cpu")
    *_, loads = ref.loss_terms(leaves, bt, conf)
    load = loads.float()[0]
    want = 0.001 * torch.sign(load.mean() - load)
    assert torch.equal(out["biases"]["layers/1/mlp/score_bias"], want)
    assert not [n for n in out["first_grad"] if n.endswith(tmoe.BIAS)]


def test_mla_refuses_decode():
    """Serving leaves latent attention out: no decode cache of the latent
    is written yet, and every decode entry point says so."""
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.serve.serve_step import make_serve_step
    cfg = port_config()
    with pytest.raises(NotImplementedError, match="latent"):
        tmodel.init_decode_state(cfg, 1, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="latent"):
        make_serve_step(cfg)
    with pytest.raises(NotImplementedError, match="latent"):
        ServingEngine(cfg, {}, device="cpu")


def test_active_params_count_a_share_of_held_experts():
    """The reference's active parameters count each held expert at k / E
    of its weights and leave out the embedding and the biases."""
    conf = dict(CONF)
    specs = {n: math.prod(s) for n, s, *_ in ref.leaf_specs(conf)}
    expert = sum(v for n, v in specs.items()
                 if n.split("/")[-1] in ("w_in", "w_gate", "w_out")
                 and "layers/0/" not in n)
    rest = sum(v for n, v in specs.items()
               if n != "embed/table" and not n.endswith(tmoe.BIAS)) - expert
    assert ref.active_params(conf) == rest + expert * 6 // 16


def test_traced_step_spans_and_counters():
    """A traced step has the MLA mixer's spans in every layer, in order,
    ``moe.balance`` after the optimizer, and ``moe.held_pairs`` counting
    the pairs of held experts once a layer (the recompute not again)."""
    cfg = port_config()
    tree = ref.as_tree(ref.make_params(CONF, 6, "cpu"))
    opt = OptimizerConfig()
    tel = Telemetry(mode="on")
    step = tstep.make_train_step(cfg, opt, telemetry=tel)
    bt = batch(2)
    step(tree, adamw_init(tree, opt), bt)
    rec = tel.stop()
    spans = rec.tracer.spans
    names = [s.name for s in spans]
    per_pass = cfg.n_layers * 2      # forward and the recompute
    for name in ("mla.project", "mla.core", "mla.out"):
        assert names.count(name) == per_pass, name
    (root,) = [s for s in spans if s.parent_id is None]
    top = [s.name for s in spans if s.parent_id == root.span_id]
    assert top == ["train.forward", "train.backward", "train.optimizer",
                   "moe.balance"]
    held = rec.registry.counter("moe.held_pairs").value
    pairs = rec.registry.counter("moe.pairs").value
    assert pairs == 2 * B * S * 6
    assert 0 < rec.registry.counter("moe.kept_pairs").value <= held < pairs
