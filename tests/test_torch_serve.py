"""The port's serving stack against the reference's on the CPU: the
paged KV-cache manager (a copy), the engine on the configurations of
tests/test_serve.py::test_engine_end_to_end and examples/serve_lm.py,
and the launcher. Both engines get the same weights (the reference's
``init_params`` through ``params_from_numpy``).

``EngineStats`` must be equal, and so must every generated token. The
reference rounds its decode logits to bf16 where the port keeps fp32,
so a near-tie can flip one argmax; where a token differs, the test
shows that the reference's top-2 margin at that step is below the bf16
decode tolerance of tests/test_torch_models.py and that the port chose
a token within that margin.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch import serve as jlaunch  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro.serve.kvcache import PagedKVCacheManager as JManager  # noqa: E402
from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import (decode_state_from_numpy,  # noqa: E402
                                        params_from_numpy)
from repro_torch.serve import engine as tengine  # noqa: E402
from repro_torch.serve.kvcache import PagedKVCacheManager as TManager  # noqa: E402

DECODE_BF16_TOL = 1e-1


def both(arch, seed=0, **cfg_kw):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jreduced(jget(arch), **cfg_kw)
    tcfg = reduced(get(arch), **cfg_kw)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def twin_requests(prompts, max_new):
    """The same requests for both engines."""
    return ([jengine.Request(i, list(p), max_new_tokens=max_new)
             for i, p in enumerate(prompts)],
            [tengine.Request(i, list(p), max_new_tokens=max_new)
             for i, p in enumerate(prompts)])


def reference_logits(jcfg, jp, prompt, generated, max_len):
    """The reference's next-token logits after ``prompt`` and the first
    ``len(generated)`` tokens, teacher-forced the way its engine feeds
    them (the last prompt token again at len - 1 before generating)."""
    seq = list(prompt) + list(generated)
    step = jax.jit(lambda p, tok, st, pos: jmodel.decode_step(p, jcfg, tok,
                                                              st, pos))
    state = jmodel.init_decode_state(jcfg, 1, max_len)
    logits = None
    for t, tok in enumerate(seq):
        logits, state = step(jp, jnp.full((1, 1), tok, jnp.int32), state,
                             jnp.full((1,), t, jnp.int32))
    return np.asarray(logits[0, -1], np.float32)


def assert_same_tokens(jdone, tdone, jcfg, jp, max_len):
    """Equal generations, or a flip that is a bf16 near-tie of the
    reference (see the module docstring)."""
    want = {r.request_id: r.generated for r in jdone}
    got = {r.request_id: r.generated for r in tdone}
    assert sorted(want) == sorted(got)
    for rid, gen in want.items():
        if got[rid] == gen:
            continue
        n = next(i for i, (a, b) in enumerate(zip(gen, got[rid])) if a != b)
        prompt = next(r.prompt for r in jdone if r.request_id == rid)
        logits = reference_logits(jcfg, jp, prompt, gen[:n], max_len)
        top2 = np.sort(logits)[-2:]
        assert int(np.argmax(logits)) == gen[n]
        assert top2[1] - top2[0] < DECODE_BF16_TOL, (rid, n, top2)
        assert logits[got[rid][n]] >= top2[1] - DECODE_BF16_TOL


def run_both(arch, engine_kw, prompts, max_new, cfg_kw=None, rounds=1):
    """Run both engines over ``prompts`` (``rounds`` times, same engine)
    and hold stats and tokens equal."""
    jcfg, tcfg, jp, tp = both(arch, **(cfg_kw or {}))
    jeng = jengine.ServingEngine(jcfg, jp, **engine_kw)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", **engine_kw)
    for _ in range(rounds):
        jreqs, treqs = twin_requests(prompts, max_new)
        jdone, tdone = jeng.run(jreqs), teng.run(treqs)
        assert [r.request_id for r in tdone] == \
            [r.request_id for r in jdone]
        assert [r.prefill_tokens_executed for r in tdone] == \
            [r.prefill_tokens_executed for r in jdone]
        assert_same_tokens(jdone, tdone, jcfg, jp, engine_kw["max_len"])
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    return jeng, teng, tdone


def test_engine_end_to_end_matches():
    """tests/test_serve.py::test_engine_end_to_end, on both engines."""
    system = list(range(1, 13))
    kw = dict(slots=2, max_len=64, page_size=4, cache_budget_pages=64)
    jeng, teng, tdone = run_both(
        "qwen1.5-0.5b", kw, [system + [20 + i] for i in range(4)], 4,
        cfg_kw=dict(d_model=32, n_periods=1, vocab=64))
    assert len(tdone) == 4 and all(len(r.generated) == 4 for r in tdone)
    assert teng.stats.prefill_saved > 0
    # Identical prompts decode identical tokens (batch consistency), on
    # the reference's own input: token 99 in a 64-token vocabulary, which
    # both embeddings clamp to id 63. Both engines give the same tokens.
    jdone2 = jeng.run([jengine.Request(10 + i, system + [99],
                                       max_new_tokens=2) for i in range(2)])
    done2 = teng.run([tengine.Request(10 + i, system + [99],
                                      max_new_tokens=2) for i in range(2)])
    assert done2[0].generated == done2[1].generated
    assert_same_tokens(jdone2, done2, jeng.cfg, jeng.params, kw["max_len"])
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)


@pytest.mark.parametrize("mix", ["shared", "cold"])
def test_serve_lm_example_matches(mix):
    """examples/serve_lm.py's two traffic mixes, on both engines."""
    rng = np.random.default_rng(1)
    vocab = 512
    system = rng.integers(1, vocab, 32).tolist()
    shared = [system + rng.integers(1, vocab, 8).tolist() for _ in range(6)]
    cold = [rng.integers(1, vocab, 40).tolist() for _ in range(6)]
    kw = dict(slots=3, max_len=96, page_size=8, cache_budget_pages=32,
              policy="cost")
    run_both("qwen1.5-0.5b", kw, shared if mix == "shared" else cold, 4,
             cfg_kw=dict(d_model=64, n_periods=2, vocab=vocab))


@pytest.mark.parametrize("arch,kv_update", [("llama3.2-3b", "scatter"),
                                            ("llama3.2-3b", "onehot"),
                                            ("olmo-1b", "scatter")])
def test_engine_matches_across_archs(arch, kv_update):
    """GQA (llama), the one-hot cache blend, and non-parametric LN (olmo)
    through the engine, over two runs of one engine (lane reuse)."""
    rng = np.random.default_rng(2)
    system = rng.integers(1, 256, 20).tolist()
    prompts = [system + rng.integers(1, 256, int(n)).tolist()
               for n in rng.integers(1, 9, 5)]
    jcfg, tcfg, jp, tp = both(arch)
    jcfg = dataclasses.replace(jcfg, kv_update=kv_update)
    tcfg = dataclasses.replace(tcfg, kv_update=kv_update)
    kw = dict(slots=2, max_len=48, page_size=4, cache_budget_pages=16)
    jeng = jengine.ServingEngine(jcfg, jp, **kw)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", **kw)
    for _ in range(2):
        jreqs, treqs = twin_requests(prompts, 5)
        assert_same_tokens(jeng.run(jreqs), teng.run(treqs), jcfg, jp, 48)
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)


def test_prefill_replay_leaves_other_lanes_alone():
    """Admitting a request leaves the state of a lane already decoding
    unchanged, position 0 of its KV included: with dense MLPs the replay
    runs on the admitted lane alone; with MoE layers (deepseek, and Jamba
    with its Mamba states) it runs every lane, as the reference does, and
    keeps only the admitted lane's new state."""
    for arch, all_lanes in (("llama3.2-3b", False),
                            ("deepseek-moe-16b", True),
                            ("jamba-1.5-large-398b", True)):
        _, tcfg, _, tp = both(arch)
        eng = tengine.ServingEngine(tcfg, tp, slots=3, max_len=16,
                                    device="cpu")
        assert eng.all_lane_replay == all_lanes
        gen = torch.Generator().manual_seed(4)
        kv = tmodel.init_decode_state(tcfg, 3, 16, device="cpu")
        state = {"kv": [{k: torch.randn(v.shape, generator=gen).to(v.dtype)
                         for k, v in st.items()} for st in kv],
                 "next_logits": [None] * 3}
        before = [{k: v.clone() for k, v in st.items()}
                  for st in state["kv"]]
        calls = []
        decode = eng._decode
        eng._decode = lambda *a: calls.append(a[1].shape[0]) or decode(*a)
        eng._prefill_into_slot(state, 1, [5, 6, 7], start=0)
        assert calls == [3 if all_lanes else 1] * 3
        for st, old in zip(state["kv"], before):
            for k in st:
                for lane in (0, 2):
                    assert torch.equal(st[k][lane], old[k][lane]), (arch, k)
                assert not torch.equal(st[k][1], old[k][1]), (arch, k)


def moe_pair(capacity_factor=1.25, seed=5):
    """(reference cfg, port cfg, reference params, port params): a
    reduced deepseek (d_model 64, 8 experts top-2, vocab 256) at
    ``capacity_factor``, fp32 weights (the routing is then the same on
    both sides)."""
    jcfg = jreduced(jget("deepseek-moe-16b"))
    tcfg = reduced(get("deepseek-moe-16b"))
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=capacity_factor)) for c in (jcfg, tcfg))
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed),
                            dtype=jnp.float32)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def test_moe_prompt_replay_matches_reference(monkeypatch):
    """The engines' prompt replay on the same state, compared state for
    state: prompts replayed into slots 0, 2 and 1 of 4 lanes at
    capacity_factor 1.25, where a step's capacity is 1 slot an expert.
    The admitted lane queues behind the lower lanes' token-0 steps, so
    some of its (token, k) are dropped; a replay on the admitted lane
    alone drops none and gives another state."""
    jcfg, tcfg, jp, tp = moe_pair()
    kw = dict(slots=4, max_len=16, page_size=4, cache_budget_pages=16)
    jeng = jengine.ServingEngine(jcfg, jp, **kw)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", **kw)
    jstate = {"kv": jmodel.init_decode_state(jcfg, 4, 16),
              "next_logits": [None] * 4}
    tstate = {"kv": tmodel.init_decode_state(tcfg, 4, 16, device="cpu"),
              "next_logits": [None] * 4}
    dropped = []
    route = tmoe.route

    def count(router, xt, cfg):
        r = route(router, xt, cfg)
        dropped.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(tmoe, "route", count)
    rng = np.random.default_rng(7)
    for slot in (0, 2, 1):
        prompt = rng.integers(1, 256, 6).tolist()
        jeng._prefill_into_slot(jstate, slot, prompt, start=0)
        teng._prefill_into_slot(tstate, slot, prompt, start=0)
        want = decode_state_from_numpy(
            tcfg, jax.tree.map(np.asarray, jstate["kv"]), device="cpu")
        for layer, (got_st, want_st) in enumerate(zip(tstate["kv"], want)):
            for k in got_st:
                # The KV caches are bf16 on both sides: an fp32 value at a
                # rounding boundary may land one bf16 ulp (2^-7) away.
                rtol = 2 ** -7 if got_st[k].dtype == torch.bfloat16 else 1e-4
                np.testing.assert_allclose(
                    got_st[k].float().numpy(), want_st[k].float().numpy(),
                    rtol=rtol, atol=1e-4, err_msg=f"{slot} {layer} {k}")
    assert sum(dropped) > 0


@pytest.mark.parametrize("slots", [2, 4])
def test_moe_engine_matches_reference(slots):
    """A reduced deepseek at its published capacity_factor 1.25, where a
    decode step's capacity is max(1, int(1.25 * 2 * slots / 8)) = 1 slot
    an expert and drops are common: the reference's prompt replay steps
    every lane, so the other lanes' tokens decide which of the admitted
    lane's are dropped. Both engines, fp32 weights (the routing is then
    the same on both sides), give the same tokens and EngineStats."""
    jcfg, tcfg, jp, tp = moe_pair()
    rng = np.random.default_rng(6)
    system = rng.integers(1, 256, 6).tolist()
    prompts = [system + rng.integers(1, 256, int(n)).tolist()
               for n in rng.integers(1, 5, 2 * slots + 1)]
    kw = dict(slots=slots, max_len=24, page_size=4, cache_budget_pages=16)
    jeng = jengine.ServingEngine(jcfg, jp, **kw)
    teng = tengine.ServingEngine(tcfg, tp, device="cpu", **kw)
    jreqs, treqs = twin_requests(prompts, 6)
    jdone, tdone = jeng.run(jreqs), teng.run(treqs)
    assert [(r.request_id, r.generated) for r in tdone] == \
        [(r.request_id, r.generated) for r in jdone]
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)


def test_malformed_prompts_raise():
    """A prompt longer than the cache is rejected on the host before any
    step runs."""
    _, tcfg, _, tp = both("qwen1.5-0.5b")
    eng = tengine.ServingEngine(tcfg, tp, slots=1, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.run([tengine.Request(0, list(range(1, 10)))])


def test_oov_prompts_match_reference():
    """Out-of-vocabulary ids (negative, V and above) are not refused: the
    engine serves them with the tokens the reference's engine gives."""
    jcfg, tcfg, jp, tp = both("qwen1.5-0.5b")
    eng = tengine.ServingEngine(tcfg, tp, slots=1, max_len=8, device="cpu")
    vocab = tcfg.vocab_size
    jreqs, treqs = twin_requests([[1, -2], [3, vocab + 40, vocab]], 3)
    jeng = jengine.ServingEngine(jcfg, jp, slots=1, max_len=8)
    assert_same_tokens(jeng.run(jreqs), eng.run(treqs), jcfg, jp, 8)


@pytest.mark.parametrize("policy", ["cost", "lru"])
def test_kvcache_manager_is_the_reference(policy):
    """The copied manager allocates, hits and evicts exactly as the
    reference over a random trace with shared prefixes."""
    rng = np.random.default_rng(3)
    kw = dict(page_size=4, budget_bytes=10 * 100, page_bytes=100,
              policy=policy)
    jm, tm = JManager(**kw), TManager(**kw)
    systems = [rng.integers(0, 50, 16).tolist() for _ in range(3)]
    for i in range(40):
        toks = systems[i % 3] + rng.integers(100, 200,
                                             int(rng.integers(1, 12))).tolist()
        a, b = jm.allocate(i, toks), tm.allocate(i, toks)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert jm.resident_bytes == tm.resident_bytes
    assert jm.assign_replica_groups(2, 600) == tm.assign_replica_groups(2,
                                                                       600)


def test_launcher_matches_reference(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` serves what the
    reference's launcher serves, with the same counters."""
    jeng = jlaunch.main([])
    teng = tlaunch.main(["--device", "cpu"])
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == out[-2] and out[-1].startswith("served 8 requests")


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "xlstm-125m"])
def test_launcher_serves_moe_and_ssm(arch):
    """The launcher serves an MoE and an attention-free architecture (its
    own random weights) with the reference launcher's counters."""
    argv = ["--arch", arch, "--requests", "3"]
    jeng = jlaunch.main(argv)
    teng = tlaunch.main(argv + ["--device", "cpu"])
    assert dataclasses.asdict(teng.stats) == dataclasses.asdict(jeng.stats)
    assert teng.stats.requests == 3 and teng.stats.decode_steps > 0


def test_engine_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    _, tcfg, _, tp = both("qwen1.5-0.5b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.ServingEngine(tcfg, tp)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main([])
