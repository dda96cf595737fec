"""The port's launch layer on the mesh it really has: ``make_host_mesh``,
train steps with parameters, moments and batches placed as ``DTensor``s
on a ``(1, 1)`` gloo mesh (``device="cpu"``) against the unplaced step,
checkpoints of placed trees, the hand-written kernels refusing a
``DTensor``, and sequence parallelism on a mesh against the reference's
forward under a one-device host mesh.

The unplaced step already matches the reference
(tests/test_torch_train.py), so the placed one is held to it bit for
bit. On a 2 x 2 gloo mesh of four processes, where the placements move
data and sums run in other orders, fp32 forwards, decode steps and train
steps are held to the unplaced ones at the fp32 tolerance."""
import dataclasses
import gc
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from torch.distributed.tensor import DTensor  # noqa: E402
from torch.distributed.tensor.experimental import \
    implicit_replication  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.launch.mesh import make_host_mesh as jhost_mesh  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import \
    flash_attention as tflash  # noqa: E402
from repro_torch.kernels.paged_attention import \
    paged_attention as tpaged  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_numpy  # noqa: E402
from repro_torch.sharding.partition import (P, make_policy,  # noqa: E402
                                            place)
from repro_torch.train.checkpoint import (restore_checkpoint,  # noqa: E402
                                          save_checkpoint)
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_init)
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.tree import leaves, named_leaves  # noqa: E402

B, S = 4, 64


@pytest.fixture(scope="module")
def mesh():
    """The ``(1, 1)`` gloo mesh of this process."""
    return make_host_mesh(device="cpu")


def test_host_mesh(mesh):
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert mesh.device_type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_host_mesh()


def batch_of(cfg, seed=0):
    """A seeded token batch."""
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g),
            "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "moonlight-16b-a3b"])
def test_placed_train_step_equals_unplaced(mesh, arch):
    """Two steps of the launcher's placed state equal two unplaced steps:
    losses, grad norms and every parameter and moment, bit for bit
    (moonlight's balancing biases among the parameters, its layers
    holding 4 of the 8 reduced experts)."""
    cfg = reduced(get(arch))
    if cfg.mla is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_held=4, held_offset=2))
    opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt_cfg)
    policy = make_policy(cfg, mesh)
    p0 = tmodel.init_params(cfg, seed=0, device="cpu")
    o0 = adamw_init(p0, opt_cfg)
    p1, o1 = tlaunch.placed_state(cfg, opt_cfg, 0, mesh, policy)
    assert all(isinstance(t, DTensor) for t in leaves(p1) + leaves(o1["m"]))
    for i in range(2):
        batch = batch_of(cfg, seed=i)
        p0, o0, m0 = step(p0, o0, batch)
        with implicit_replication():
            p1, o1, m1 = step(p1, o1, tlaunch.place_batch(batch, mesh,
                                                          policy))
        for key in ("loss", "grad_norm", "aux_loss"):
            assert float(m0[key]) == tlaunch.scalar(m1[key]), key
    for a, b in zip(leaves(p0) + leaves(o0["m"]) + leaves(o0["v"]),
                    leaves(p1) + leaves(o1["m"]) + leaves(o1["v"])):
        assert torch.equal(a, b.full_tensor())


def test_checkpoint_of_placed_tree(mesh, tmp_path):
    """A placed tree is saved whole, in the reference's format, and
    restored by the target's placements."""
    cfg = reduced(get("llama3.2-3b"))
    policy = make_policy(cfg, mesh)
    params, opt = tlaunch.placed_state(cfg, OptimizerConfig(), 3, mesh,
                                       policy)
    path = save_checkpoint(str(tmp_path), 5, {"params": params, "opt": opt})
    like_p, like_o = tlaunch.placed_state(cfg, OptimizerConfig(), 4, mesh,
                                          policy)
    tree, step, _ = restore_checkpoint(path, {"params": like_p,
                                              "opt": like_o})
    assert step == 5
    got = named_leaves(tree)
    for (name, a), (_, b) in zip(named_leaves({"params": params,
                                               "opt": opt}), got):
        if isinstance(a, DTensor):
            assert isinstance(b, DTensor) and b.placements == a.placements
            assert torch.equal(a.full_tensor(), b.full_tensor()), name
        else:
            assert torch.equal(a, b), name
    manifest = json.loads((tmp_path / "step_00000005" /
                           "MANIFEST.json").read_text())
    shapes = {e["name"]: tuple(e["shape"]) for e in manifest["leaves"]}
    for name, leaf in named_leaves({"params": params, "opt": opt}):
        assert shapes[name] == tuple(leaf.shape)    # whole, not a shard


def test_launcher_trains_on_the_host_mesh(tmp_path):
    out = tlaunch.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--d-model", "32", "--periods", "1",
                        "--vocab", "64", "--data-dir", str(tmp_path / "d"),
                        "--log-every", "1"])
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))


def test_launcher_trains_moonlight_on_the_host_mesh(tmp_path):
    """``--arch moonlight-16b-a3b`` through the launcher: latent
    attention, the sigmoid router and its biases on the host mesh."""
    out = tlaunch.main(["--device", "cpu", "--arch", "moonlight-16b-a3b",
                        "--steps", "2", "--batch", "2", "--seq", "16",
                        "--d-model", "32", "--periods", "1", "--vocab",
                        "64", "--data-dir", str(tmp_path / "d"),
                        "--log-every", "1"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))


def test_settled_heap_freezes_set_up_for_the_loop_alone(tmp_path):
    """The step loop's heap: what set-up left is frozen out of the
    collector's sight inside the loop and thawed after it, also when the
    loop raises; the launcher's own loop leaves nothing frozen."""
    before = gc.get_freeze_count()
    with tlaunch.settled_heap():
        assert gc.get_freeze_count() > before
    assert gc.get_freeze_count() <= before
    with pytest.raises(RuntimeError):
        with tlaunch.settled_heap():
            raise RuntimeError("a failing step")
    assert gc.get_freeze_count() <= before
    tlaunch.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                  "--seq", "16", "--d-model", "32", "--periods", "1",
                  "--vocab", "64", "--data-dir", str(tmp_path / "d"),
                  "--log-every", "1"])
    assert gc.get_freeze_count() <= before


def test_kernels_refuse_a_dtensor(mesh):
    """The kernels' ops have no DTensor rule: a DTensor input raises; it
    never runs a plain version on its own (callers pass local shards
    through ``local_map``)."""
    q = place(torch.randn(1, 2, 64, 32), P(None, None, None, None), mesh)
    with pytest.raises(Exception, match="flash_attention_fwd"):
        tflash.flash_attention_fwd(q, q, q, bq=64, bk=64)
    qd = place(torch.randn(1, 2, 32), P(None, None, None), mesh)
    pages = place(torch.randn(2, 8, 2, 32), P(None, None, None, None), mesh)
    table = place(torch.arange(2, dtype=torch.int32).view(1, 2),
                  P(None, None), mesh)
    lens = place(torch.tensor([9], dtype=torch.int32), P(None), mesh)
    with pytest.raises(Exception, match="paged_attention"):
        tpaged.paged_attention(qd, pages, pages, table, lens)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_seq_parallel_on_mesh_matches_reference(mesh, dtype, tol):
    """A ``seq_parallel`` reduced llama on the ``(1, 1)`` mesh gives the
    unplaced, non-sequence-parallel logits bit for bit, and the
    reference's forward with ``seq_parallel`` under
    ``jax.set_mesh(make_host_mesh())`` within the tolerances of
    tests/test_torch_models.py."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jcfg = dataclasses.replace(jreduced(jget("llama3.2-3b")),
                               seq_parallel=True)
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0), dtype=jd)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 16))
    with jax.set_mesh(jhost_mesh()):
        want, _ = jmodel.forward(jp, jcfg, tokens=jnp.asarray(
            tokens.astype(np.int32)))
    cfg = dataclasses.replace(reduced(get("llama3.2-3b")),
                              seq_parallel=True)
    base = dataclasses.replace(cfg, seq_parallel=False)
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    plain, _ = tmodel.forward(tp, base, tokens=torch.from_numpy(tokens))
    policy = make_policy(cfg, mesh)
    placed = tlaunch.place_params(tp, mesh, policy)
    tok = place(torch.from_numpy(tokens), P(("data",), None), mesh)
    with implicit_replication():
        got, _ = tmodel.forward(placed, cfg, tokens=tok)
    got = got.full_tensor()
    assert torch.equal(got, plain)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


RANKS = 4
# name -> (arch, config overrides): llama with two KV heads so its heads
# split over ``model`` (one KV head replicates them), the same with
# sequence parallelism, MoE with expert-sharded GEMMs, xLSTM and Jamba's
# recurrences on batch rows.
MESH_CASES = {
    "llama-gqa": ("llama3.2-3b", {"n_kv_heads": 2}),
    "llama-seq-parallel": ("llama3.2-3b", {"n_kv_heads": 2,
                                           "seq_parallel": True}),
    "deepseek-moe": ("deepseek-moe-16b", {}),
    "xlstm": ("xlstm-125m", {}),
    "jamba": ("jamba-1.5-large-398b", {}),
    "moonlight": ("moonlight-16b-a3b", {}),
    "moonlight-held": ("moonlight-16b-a3b", {"moe": {"n_held": 4,
                                                     "held_offset": 2}}),
}
FP32_TOL = 1e-4
# Mamba keeps its conv window in bf16 (tests/test_torch_models.py).
MAMBA_FP32_DECODE_TOL = 1e-2

RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get, reduced
    from repro_torch.launch import train as tlaunch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.sharding.partition import (P, RuleContext,
                                                decode_state_specs,
                                                make_policy, place,
                                                place_tree)
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    from repro_torch.train.train_step import make_train_step
    from repro_torch.train.tree import leaves

    rank, world, store, cases, b, s, steps = json.loads(sys.argv[1])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = make_host_mesh(model_parallel=2, device="cpu")

    def full(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    def rel(got, want):
        got, want = full(got).double(), full(want).double()
        return float((got - want).abs().max()
                     / want.abs().max().clamp(min=1e-30))

    def fresh(cfg):
        return tmodel.init_params(cfg, seed=0, dtype=torch.float32,
                                  device="cpu")

    out = {}
    for name, (arch, over) in cases.items():
        base = reduced(get(arch))
        if "moe" in over:
            over = dict(over, moe=dataclasses.replace(base.moe,
                                                      **over["moe"]))
        cfg = dataclasses.replace(base, **over)
        policy = make_policy(cfg, mesh)
        g = torch.Generator().manual_seed(1)
        batch = {k: torch.randint(0, cfg.vocab_size, (b, s), generator=g)
                 for k in ("tokens", "labels")}
        # separate copies: a placed shard may share the unplaced
        # tensor's storage, and the train step updates in place
        p0 = fresh(cfg)
        p1 = tlaunch.place_params(fresh(cfg), mesh, policy)
        pb = tlaunch.place_batch(batch, mesh, policy)
        r = {}
        want, _ = tmodel.forward(p0, cfg, tokens=batch["tokens"])
        with implicit_replication():
            got, _ = tmodel.forward(p1, cfg, tokens=pb["tokens"])
        r["forward"] = rel(got, want)
        # latent attention has no decode cache yet: serving refuses it
        if cfg.mla is None:
            st0 = tmodel.init_decode_state(cfg, b, steps, device="cpu")
            st1 = place_tree(tmodel.init_decode_state(cfg, b, steps,
                                                      device="cpu"),
                             decode_state_specs(st0, mesh, policy, b,
                                                ("model",)), mesh)
            rows = RuleContext(mesh, policy).fit(policy.dp_axes, b)
            r["decode"] = 0.0
            for t in range(steps):
                tok = batch["tokens"][:, t:t + 1]
                pos = torch.full((b,), t, dtype=torch.int32)
                want, st0 = tmodel.decode_step(p0, cfg, tok, st0, pos)
                with implicit_replication():
                    got, st1 = tmodel.decode_step(
                        p1, cfg, place(tok, P(rows, None), mesh), st1,
                        place(pos, P(rows), mesh))
                r["decode"] = max(r["decode"], rel(got, want))
        opt_cfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1,
                                  total_steps=10)
        step = make_train_step(cfg, opt_cfg)
        o0, o1 = adamw_init(p0, opt_cfg), adamw_init(p1, opt_cfg)
        _, o0, m0 = step(p0, o0, batch)
        with implicit_replication():
            _, o1, m1 = step(p1, o1, pb)
        for key in ("loss", "grad_norm"):
            r[key] = rel(m1[key], m0[key])
        for key in ("m", "v"):
            r[key] = max(rel(x, y) for x, y in zip(leaves(o1[key]),
                                                   leaves(o0[key])))
        out[name] = r
    dist.destroy_process_group()
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every mesh case's largest relative differences from the unplaced
    run, as each of the four ranks measured them."""
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(Path(__file__).resolve().parents[1] / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_SCRIPT,
         json.dumps([rank, RANKS, store, MESH_CASES, 4, 16, 4])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(RANKS)]
    results = []
    for proc in procs:
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stdout[-4000:] + stderr[-4000:]
        line = next(ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT "))
        results.append(json.loads(line[7:]))
    return results


@pytest.mark.parametrize("case", list(MESH_CASES))
def test_four_rank_mesh_matches_unplaced(four_ranks, case):
    """fp32 parameters placed by the sharding rules on a 2 x 2 (data,
    model) gloo mesh: the forward's logits, four teacher-forced decode
    steps' logits, and one train step's loss, grad norm and AdamW
    moments (every leaf) against the unplaced model on every rank, each
    relative to the unplaced values' largest magnitude. This exercises
    vocab-parallel embedding and label pick, heads and GQA groups split
    over ``model``, sequence parallelism, expert-sharded MoE GEMMs and
    the recurrences on batch rows, and every gradient summed over the
    ranks that split its work."""
    arch = MESH_CASES[case][0]
    for rank, result in enumerate(four_ranks):
        r = result[case]
        for key, err in r.items():
            tol = MAMBA_FP32_DECODE_TOL if key == "decode" and \
                get(arch).mamba is not None else FP32_TOL
            assert err <= tol, (rank, key, err)
