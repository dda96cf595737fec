"""The check sees faults: the harness driven on the CPU at the tiny
size (the look for a CUDA device skipped) with the timed path broken
underneath, and ``correct`` comes out false; and the lower-precision
controls fail the cells' limits at a size a test run holds."""
import json

import pytest
import torch

from portbench import control
from portbench.drivers import join, train
from portbench.tests import tiny
from portbench.tests.test_portbench_harness import harness


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def faulty_program(plant):
    class Faulty(train.Program):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            plant(self)
    return Faulty


def alter_token(program):
    """A token of every batch altered where the pipeline produces it."""
    next_batch = program.pipeline.next_batch

    def altered():
        out = next_batch()
        out["tokens"][0, 3] += 1
        return out
    program.pipeline.next_batch = altered


TRAIN_FAULTS = {"unchanged": control.plant_unchanged,
                "half_batch": control.plant_half_batch,
                "token_altered": alter_token}


@pytest.mark.parametrize("fault", sorted(TRAIN_FAULTS))
def test_training_fault_is_not_correct(root, fault, capsys, monkeypatch):
    monkeypatch.setattr(train, "Program",
                        faulty_program(TRAIN_FAULTS[fault]))
    rc, res, err = harness(root, "deepseek-moe-16b.train", 0, capsys)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def alter_answer(cluster):
    """The third query's match count altered where it is produced."""
    execute = cluster.backend.execute
    seen = [0]

    def altered(query, report):
        e = execute(query, report)
        seen[0] += 1
        if seen[0] == 3:
            e.matches += 1
        return e
    cluster.backend.execute = altered


def half_the_tasks(cluster):
    """Every batch of join tasks counts only its first half."""
    dispatch = cluster.executor.dispatch

    def half(batch, eps, arrays=None):
        out = dispatch(batch, eps, arrays=arrays).clone()
        out[len(out) // 2:] = 0
        return out
    cluster.executor.dispatch = half


JOIN_FAULTS = {"answer_altered": alter_answer, "half_tasks": half_the_tasks}


@pytest.mark.parametrize("fault", sorted(JOIN_FAULTS))
def test_join_fault_is_not_correct(root, fault, capsys, monkeypatch):
    make = join.make_cluster

    def faulty(*a, **k):
        cluster = make(*a, **k)
        JOIN_FAULTS[fault](cluster)
        return cluster
    monkeypatch.setattr(join, "make_cluster", faulty)
    rc, res, err = harness(root, "ptf.join", 0, capsys)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]


def failed_limits(cell, readings):
    return [n for n, limit in cell["limits"].items()
            if n in readings and readings[n] > limit]


def test_training_control_fails_the_limits(root):
    """The reference with float8 products in the program's place, against
    the float32 reference, on three seeds: each fails a limit."""
    cell = json.loads((root / "workloads" /
                       "deepseek-moe-16b.train.json").read_text())
    conf = json.loads((root / "configs" /
                       "deepseek-moe-16b.json").read_text())
    for seed in (11, 2**31 + 3, 4_000_000_001):
        r = control.train_readings(cell, conf, seed, torch.device("cpu"),
                                   control=True)
        assert not failed_limits(cell, r["program"]), r["program"]
        assert failed_limits(cell, r["control"]), r["control"]


def test_join_control_fails_the_limits(root):
    cell = json.loads((root / "workloads" / "ptf.join.json").read_text())
    conf = json.loads((root / "configs" / "ptf.json").read_text())
    for seed in (11, 2**31 + 3, 4_000_000_001):
        r = control.join_control(cell, conf, seed, torch.device("cpu"))
        assert failed_limits(cell, r["control"]), r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["deepseek-moe-16b.train", "ptf.join"])
def test_control_fails_at_the_cells_size(workload):
    """The control at the cell's own size on three seeds (the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny.load(f"workloads/{workload}.json")
    conf = tiny.load(f"configs/{cell['config']}.json")
    dev = torch.device("cuda")
    for seed in (4_600_000_001, 4_600_000_002, 4_600_000_003):
        if cell["driver"] == "join":
            r = control.join_control(cell, conf, seed, dev)
        else:
            r = control.train_readings(cell, conf, seed, dev, control=True)
        assert failed_limits(cell, r["control"]), r["control"]
