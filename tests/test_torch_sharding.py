"""The port's sharding rules (``repro_torch.sharding.partition``) against
the reference's (``repro.sharding.partition``): every case of
tests/test_sharding.py on the port's per-layer layout, then every
parameter and decode-state leaf of all ten architectures, reduced and
full, on the ``(1, 1)``, 16 x 16 and 2 x 16 x 16 axis sizes.

The reference's rules read only ``mesh.shape[name]`` and
``mesh.axis_names``, so the port's ``MeshShape`` stands in for a jax
mesh of 256 or 512 devices on both sides. The reference stacks every
block leaf over the periods; its spec there has a leading None, which is
dropped before the comparison (the port keeps one dict per layer). Full
configurations are built as fake tensors on the port's side and with
``jax.eval_shape`` on the reference's, so nothing is allocated.
"""
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get as jget  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.sharding import partition as jpart  # noqa: E402
from repro_torch.configs import get, list_archs, reduced  # noqa: E402
from repro_torch.launch.mesh import MULTIPOD, POD, MeshShape  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.sharding import partition as tpart  # noqa: E402
from repro_torch.sharding.partition import P, ShardingPolicy  # noqa: E402
from repro_torch.train.tree import named_leaves  # noqa: E402

HOST = MeshShape(("data", "model"), (1, 1))
MESHES = {"host": HOST, "pod": POD, "multipod": MULTIPOD}
DECODE_B, DECODE_S = 128, 4096


def port_params(cfg):
    """The port's parameters of ``cfg`` as fake tensors."""
    with FakeTensorMode():
        return tmodel.init_params(cfg, device="cpu")


def specs(arch, scale, mesh):
    """(port config, port params, its specs)."""
    cfg = get(arch) if scale == "full" else reduced(get(arch))
    params = port_params(cfg)
    policy = tpart.make_policy(cfg, mesh)
    return cfg, params, tpart.param_specs(params, mesh, policy)


def jtuple(spec):
    """A spec of either package as a plain tuple, a one-axis tuple entry
    written as its axis (jax's PartitionSpec normalises ``("data",)`` to
    ``"data"`` on some versions; both name the same sharding)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def layer_block(cfg, layer):
    """(period, block name) of port layer ``layer`` in the reference's
    stacked pytree."""
    return layer // cfg.period, f"b{layer % cfg.period}"


def reference_lookup(tree, cfg, path):
    """The leaf of the reference's tree at a port path: ``layers/<l>/...``
    becomes ``blocks/b<l % period>/...``."""
    parts = path.split("/")
    if parts[0] == "layers":
        _, blk = layer_block(cfg, int(parts[1]))
        node, parts = tree["blocks"][blk], parts[2:]
        stacked = True
    else:
        node, stacked = tree, False
    for p in parts:
        node = node[p]
    return node, stacked


# ------------------------------------------------- tests/test_sharding.py


def test_tp_specs_for_attention_and_mlp():
    _, _, sp = specs("llama3.2-3b", "reduced", HOST)
    b0 = sp["layers"][0]
    assert b0["mixer"]["wq"] == P(None, "model")          # column-parallel
    assert b0["mixer"]["wo"] == P("model", None)          # row-parallel
    assert b0["mlp"]["w_in"] == P(None, "model")
    assert b0["mlp"]["w_out"] == P("model", None)
    assert sp["final_norm"]["scale"] == P(None)


def test_fsdp_adds_dp_axis():
    cfg = reduced(get("llama3.2-3b"), d_model=64)
    policy = ShardingPolicy(dp_axes=("data",), fsdp=True)
    sp = tpart.param_specs(port_params(cfg), HOST, policy)
    assert sp["layers"][0]["mixer"]["wq"] == P(("data",), "model")


@pytest.mark.parametrize("mesh", ["host", "pod"])
def test_indivisible_dims_degrade_to_replication(mesh):
    # internvl2 vocab 92553 is not divisible by a 16-wide model axis.
    cfg = get("internvl2-2b")
    m = MESHES[mesh]
    policy = ShardingPolicy(dp_axes=("data",), fsdp=False)
    sp = tpart.param_specs(port_params(cfg), m, policy)
    if m.shape["model"] > 1 and cfg.vocab_size % m.shape["model"]:
        assert sp["embed"]["table"][0] is None
    else:
        assert sp["embed"]["table"][0] == "model"


@pytest.mark.parametrize("mesh", ["host", "pod", "multipod"])
def test_policy_thresholds(mesh):
    m = MESHES[mesh]
    small = tpart.make_policy(get("qwen1.5-0.5b"), m)
    big = tpart.make_policy(get("nemotron-4-340b"), m)
    assert not small.fsdp and big.fsdp
    assert small.dp_axes == tuple(a for a in m.axis_names if a != "model")
    # the threshold itself: llama3.2-3b (3.2e9) is FSDP only below it
    assert tpart.make_policy(get("llama3.2-3b"), m, 3e9).fsdp
    assert not tpart.make_policy(get("llama3.2-3b"), m).fsdp


def test_moe_expert_axis_sharded():
    _, _, sp = specs("deepseek-moe-16b", "reduced", HOST)
    assert sp["layers"][0]["mlp"]["w_in"][0] == "model"   # E axis
    # at full size (16.4e9 parameters) FSDP adds the data axis
    _, _, sp = specs("deepseek-moe-16b", "full", POD)
    assert sp["layers"][0]["mlp"]["w_in"] == P("model", ("data",), None)
    assert sp["layers"][0]["mlp"]["w_out"] == P("model", None, ("data",))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_leaf_specs(mesh):
    """moonlight-16b-a3b's new leaves at full size: the q and per-head
    up-projections split by head over ``model`` (16 heads), the latent's
    down-projection keeps its columns whole, its norm and the balancing
    bias are replicated, the held experts' stacks split by expert like
    every expert stack, and every leaf has a spec of its rank."""
    m = MESHES[mesh]
    cfg, params, sp = specs("moonlight-16b-a3b", "full", m)
    tp = "model"
    dense, moe = sp["layers"][0], sp["layers"][1]
    assert dense["mixer"]["wq"][1] == tp
    assert dense["mixer"]["wkv_b"][1] == tp
    assert dense["mixer"]["wkv_a"][1] is None
    assert dense["mixer"]["wo"][0] == tp
    assert tuple(dense["mixer"]["kv_norm"]) == (None,)
    assert tuple(moe["mlp"]["score_bias"]) == (None,)
    assert moe["mlp"]["w_in"][0] == tp and moe["mlp"]["router"][1] is None
    assert dense["mlp"]["w_in"][1] == tp          # the dense layer's MLP
    for (path, spec), (_, leaf) in zip(
            named_leaves(sp, is_leaf=tpart.is_spec), named_leaves(params)):
        assert len(spec) == leaf.ndim, path


# ------------------------------------------------- every leaf, every arch


#: The architectures the reference has too. The port's own
#: (moonlight-16b-a3b) have no JAX counterpart: test_mla_leaf_specs holds
#: its new leaves to the rules.
SHARED_ARCHS = [a for a in list_archs() if a in jlist_archs()]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("scale", ["reduced", "full"])
@pytest.mark.parametrize("arch", SHARED_ARCHS)
def test_param_specs_match_reference(arch, scale, mesh):
    m = MESHES[mesh]
    cfg, params, sp = specs(arch, scale, m)
    jcfg = jget(arch) if scale == "full" else jreduced(jget(arch))
    aps = jax.eval_shape(lambda: jmodel.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    jpolicy = jpart.make_policy(jcfg, m)
    assert tpart.make_policy(cfg, m) == ShardingPolicy(
        tp_axis=jpolicy.tp_axis, dp_axes=jpolicy.dp_axes,
        fsdp=jpolicy.fsdp)
    jspecs = jpart.param_specs(aps, m, jpolicy)
    port = named_leaves(sp, is_leaf=tpart.is_spec)
    assert len(port) == len(named_leaves(params))
    n_ref = len(jax.tree.leaves(aps))
    assert len({p.split("/", 2)[-1] if p.startswith("layers/") else p
                for p, _ in port}) <= n_ref
    for path, spec in port:
        ref, stacked = reference_lookup(jspecs, cfg, path)
        want = jtuple(ref)[1:] if stacked else jtuple(ref)
        assert jtuple(spec) == want, (path, spec, ref)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("scale", ["reduced", "full"])
@pytest.mark.parametrize("arch", [a for a in SHARED_ARCHS
                                  if not get(a).encoder_only])
def test_decode_state_specs_match_reference(arch, scale, mesh):
    m = MESHES[mesh]
    cfg = get(arch) if scale == "full" else reduced(get(arch))
    jcfg = jget(arch) if scale == "full" else jreduced(jget(arch))
    policy = tpart.make_policy(cfg, m)
    jpolicy = jpart.make_policy(jcfg, m)
    with FakeTensorMode():
        state = tmodel.init_decode_state(cfg, DECODE_B, DECODE_S,
                                         device="cpu")
    ast = jax.eval_shape(lambda: jmodel.init_decode_state(jcfg, DECODE_B,
                                                          DECODE_S))
    for seq_axes in (("model",), policy.dp_axes + ("model",)):
        sp = tpart.decode_state_specs(state, m, policy, DECODE_B, seq_axes)
        jsp = jpart.decode_state_specs(ast, m, jpolicy, DECODE_B, seq_axes)
        for path, spec in named_leaves(sp, is_leaf=tpart.is_spec):
            layer, name = path.split("/")
            _, blk = layer_block(cfg, int(layer))
            assert jtuple(spec) == jtuple(jsp[blk][name])[1:], (path, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 32, 128, 256])
def test_batch_spec_matches_reference(mesh, batch):
    m = MESHES[mesh]
    cfg = get("llama3.2-3b")
    policy = tpart.make_policy(cfg, m)
    jpolicy = jpart.make_policy(cfg, m)
    for extra in (1, 2):
        assert jtuple(tpart.batch_spec(m, policy, batch, extra)) == \
            jtuple(jpart.batch_spec(m, jpolicy, batch, extra))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard
    assert tpart.to_placements(P(None, "model"), POD) == \
        [Replicate(), Shard(1)]
    # FSDP's two DP axes shard one dim on both mesh dims
    assert tpart.to_placements(P(("pod", "data"), "model"), MULTIPOD) == \
        [Shard(0), Shard(0), Shard(1)]
    assert tpart.to_placements(P(None, None), HOST) == \
        [Replicate(), Replicate()]
    tree = tpart.tree_shardings({"a": P("model"), "b": [P(None)]}, POD)
    assert tree == {"a": [Replicate(), Shard(0)],
                    "b": [[Replicate(), Replicate()]]}
