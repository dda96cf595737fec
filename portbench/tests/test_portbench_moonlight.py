"""The latent-attention cell end to end on the CPU at the tiny size
(``tiny_mla``): ``run.py`` prints a valid result that is ``correct``,
its per-layer metrics are found by name, and each fault planted in the
program flips ``correct`` to false."""
import json

import pytest
import torch
import torch.nn.functional as F

from portbench import control_mla, run
from portbench.tests import tiny_mla

CELL = tiny_mla.CELL


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_mla.make(tmp_path_factory.mktemp("tiny_mla"))


def harness(root, trace, capsys, seed=3000000011):
    """(exit code, the parsed last stdout line)."""
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "2", "--trace", str(trace)], root=root,
                  bench_file=root / "BENCHMARK.json", device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_cell_is_correct(root, trace, capsys):
    res = harness(root, trace, capsys)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"first_grad_gap", "first_grad_l2",
                                  "change_gap", "bias_gap",
                                  "batch_mismatches"}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        # the counter metric reads; the device ones need a card
        assert "moe_held_drop_share.train" in res["metrics"]
        names = {m["name"] for m in bench["per_layer"]
                 if CELL in m.get("workloads", [CELL])}
        assert set(res["metrics"]) <= names
    else:
        assert set(res["metrics"]) == {"setup_s", "train_tokens_per_s",
                                       "train_step_p90_s"}


def wrong_expert(monkeypatch):
    """A held pair dispatched to the next held expert."""
    from repro_torch.models import moe
    real = moe._dispatch_held

    def shifted(xt, r, cfg):
        off, held = cfg.moe.held_offset, cfg.moe.held
        experts = torch.where(r.held, off + (r.experts - off + 1) % held,
                              r.experts)
        return real(xt, r._replace(experts=experts), cfg)
    monkeypatch.setattr(moe, "_dispatch_held", shifted)


def bias_frozen(monkeypatch):
    """The balancing biases never move."""
    from repro_torch.train import train_step
    monkeypatch.setattr(train_step, "balance_biases",
                        lambda params, load, cfg: None)


def v_padded(monkeypatch):
    """v padded with zeros to the q/k width, and the output read in rows
    of that width."""
    from repro_torch.models import mla
    real = mla.core

    def padded(q, k, v, *args):
        b, s, h, dv = v.shape
        o = real(q, k, F.pad(v, (0, q.shape[-1] - dv)), *args)
        return o.reshape(b, s, -1)[..., :h * dv]
    monkeypatch.setattr(mla, "core", padded)


@pytest.mark.parametrize("fault", [wrong_expert, bias_frozen, v_padded])
def test_planted_fault_is_caught(root, fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = harness(root, 0, capsys)
    assert res["correct"] is False, res["checks"]


def test_half_batch_fault_fails_a_limit(root):
    """``control_mla.py --fault half_batch`` (every other position of each
    row left out of the loss) reads beyond one of the cell's limits."""
    cell = json.loads((root / "workloads" / f"{CELL}.json").read_text())
    conf = json.loads((root / "configs" / f"{tiny_mla.CONFIG}.json")
                      .read_text())
    out = control_mla.readings(cell, conf, 3000000011, torch.device("cpu"),
                               fault="half_batch")
    assert out["fault"] == "half_batch"
    got = out["program"]
    assert any(got[n] > limit for n, limit in cell["limits"].items()
               if n in got), got
