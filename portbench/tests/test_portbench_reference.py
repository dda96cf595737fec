"""The plain references against the port at small sizes, and the
reference's layout of the weights against the port's."""
import itertools

import numpy as np
import pytest
import torch

from portbench.drivers import train
from portbench.reference import moe_lm, simjoin
from portbench.tests import tiny

CONF = dict(tiny.load("configs/deepseek-moe-16b.json"), **tiny.MODEL)
CONF["program"] = dict(CONF["program"], replace=tiny.PORT)


def test_weights_have_the_ports_names_shapes_and_dtypes():
    from repro_torch.models.model import init_params
    from repro_torch.train.tree import named_leaves
    cfg = train.program_config(CONF)
    port = dict(named_leaves(init_params(cfg, seed=0, device="cpu")))
    ours = moe_lm.make_params(dict(CONF, torch_dtype="bfloat16"), 0, "cpu")
    assert sorted(port) == sorted(ours)
    for name, t in ours.items():
        assert t.shape == port[name].shape, name
        assert t.dtype == port[name].dtype, name


def test_weights_repeat_with_the_seed_and_move_with_it():
    a = moe_lm.make_params(CONF, 2**31 + 11, "cpu")
    b = moe_lm.make_params(CONF, 2**31 + 11, "cpu")
    c = moe_lm.make_params(CONF, 2**31 + 12, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["embed/table"], c["embed/table"])


def test_loss_and_gradients_match_the_port_in_float32():
    """The port's loss and gradients (plain attention, float32 weights)
    against the reference's, at a sequence long enough that experts
    drop tokens."""
    from repro_torch.train.train_step import loss_fn, value_and_grad
    from repro_torch.train.tree import named_leaves
    cfg = train.program_config(CONF)
    leaves = moe_lm.make_params(CONF, 5, "cpu")
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, 512, (2, 96), generator=gen)
    labels = torch.roll(tokens, -1, 1)
    labels[:, -7:] = -1
    batch = {"tokens": tokens, "labels": labels}
    metrics, grads = value_and_grad(
        moe_lm.as_tree(leaves),
        lambda p, batch: loss_fn(p, cfg, batch, impl="plain"), batch)
    names = [n for n, _ in named_leaves(moe_lm.as_tree(leaves))]
    ref = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
    total, ce, aux = moe_lm.loss_terms(ref, batch, CONF)
    want = torch.autograd.grad(total, [ref[n] for n in names])
    assert float(metrics["loss"]) == pytest.approx(float(ce.detach()), rel=1e-5)
    assert float(metrics["aux_loss"]) == pytest.approx(float(aux.detach()),
                                                       rel=1e-5)
    for n, g, w in zip(names, grads, want):
        err = float((g - w).norm() / w.norm().clamp(min=1e-12))
        assert err < 1e-4, (n, err)


def test_learning_rate_schedule():
    opt = {"peak_lr": 1e-3, "min_lr": 1e-4, "warmup_steps": 10,
           "total_steps": 110}
    assert moe_lm.learning_rate(opt, 1) == pytest.approx(1e-4)
    assert moe_lm.learning_rate(opt, 10) == pytest.approx(1e-3)
    assert moe_lm.learning_rate(opt, 60) == pytest.approx(5.5e-4)
    assert moe_lm.learning_rate(opt, 500) == pytest.approx(1e-4)


def brute_force(cells: np.ndarray, eps: int) -> int:
    n = 0
    for i, j in itertools.combinations(range(len(cells)), 2):
        n += int(np.abs(cells[i] - cells[j]).sum() <= eps)
    return n


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_join_count_matches_brute_force(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    cells = np.unique(rng.integers(0, 60, size=(700, 3)), axis=0)
    monkeypatch.setattr(simjoin, "BLOCK_ROWS", 64)
    monkeypatch.setattr(simjoin, "BLOCK_COLS", 96)
    got = simjoin.count_pairs(torch.from_numpy(cells), 9)
    assert got == brute_force(cells, 9) > 0
    box = ((10, 0, 5), (40, 59, 50))
    inside = simjoin.cells_in_box(torch.from_numpy(cells), box).numpy()
    lo, hi = np.array(box[0]), np.array(box[1])
    assert len(inside) == int(((cells >= lo) & (cells <= hi)).all(1).sum())


def test_join_reference_matches_the_ports_numpy_executor():
    from repro_torch.backend.executors import count_similar_pairs_np
    rng = np.random.default_rng(4)
    cells = np.unique(rng.integers(0, 5000, size=(3000, 3)), axis=0)
    assert simjoin.count_pairs(torch.from_numpy(cells), 300) == \
        count_similar_pairs_np(cells, cells, 300, True)
