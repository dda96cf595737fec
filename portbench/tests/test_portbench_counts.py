"""The operation, byte and MFU counts, pinned on known shapes."""
import json

import pytest

from portbench.counts import ops, peaks
from portbench.reference import moe_lm
from portbench.tests import tiny

CONF = tiny.load("configs/deepseek-moe-16b.json")


def test_deepseek_parameter_counts():
    """2,770,880,512 parameters at 4 layers (the port's count); a token
    multiplies with 554,190,848 of them: the input embedding (a gather)
    and 58 of every 64 routed experts left out."""
    import math
    total = sum(math.prod(s[1]) for s in moe_lm.leaf_specs(CONF))
    assert total == CONF["parameters"] == 2_770_880_512
    assert moe_lm.active_params(CONF) == 554_190_848
    assert 554_190_848 + 102_400 * 2048 == 763_906_048


def test_attention_counts_at_deepseeks_shape():
    pairs = ops.live_pairs(1, 16, 4096, True)
    assert pairs == 16 * 4096 * 4097 // 2 == 134_250_496
    assert ops.live_pairs(2, 4, 8, False) == 2 * 4 * 64
    assert ops.flash_fwd_ops(128, pairs) == 68_736_253_952
    assert ops.flash_bwd_ops(128, pairs) == 2 * 68_736_253_952
    w = {"batch": 1, "seq": 4096, "heads": 16, "kv_heads": 16,
         "head_dim": 128, "elem_bytes": 2, "lse": True}
    q = 4096 * 16 * 128 * 2
    assert ops.flash_fwd_bytes(w) == 4 * q + 16 * 4096 * 4 == 67_371_008
    assert ops.flash_bwd_bytes(w) == 8 * q + 16 * 4096 * 4 == 134_479_872
    assert ops.flash_fwd_bytes(dict(w, lse=False, kv_heads=8)) == 3 * q


def test_train_step_flops_and_mfu():
    pairs = ops.live_pairs(1, 16, 4096, True)
    flops = ops.train_step_flops(554_190_848, 4096, 128, pairs, 4)
    assert flops == 6 * 554_190_848 * 4096 + 12 * 128 * pairs * 4
    assert flops == 14_444_629_327_872
    # One step a second is 1.46 % of the bf16 peak.
    assert 100 * flops / peaks.BF16_FLOPS_PER_S == pytest.approx(
        1.460529, rel=1e-6)


def test_cell_pair_ops_and_roofline_share():
    assert ops.cell_pair_ops(3) == 10
    assert ops.cell_pair_ops(2) == 7
    # 67e9 operations at 67e12/s take 1 ms: 50 % of 2 ms; bytes bound
    # when they take longer.
    assert ops.roofline_share(67e9, peaks.INT32_OPS_PER_S, 0, 2e-3) == \
        pytest.approx(50.0)
    assert ops.roofline_share(0, peaks.INT32_OPS_PER_S, 3.35e9, 1e-3) == \
        pytest.approx(100.0)


def test_metric_readers_read_nothing_from_an_empty_record():
    from pathlib import Path
    from portbench import run
    names = [m["name"] for m in json.loads(
        (tiny.CHECKOUT / "BENCHMARK.json").read_text())["per_layer"]]
    for name in names:
        assert run.metric_reader(name, Path(tiny.BENCH))({}) is None
