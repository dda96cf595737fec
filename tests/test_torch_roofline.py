"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``): ``model_flops`` equal exactly
on every arch x shape cell, and ``build_report`` on the same per-chip
cost with the hardware swapped for the H100."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get as jget  # noqa: E402
from repro.configs import list_archs as jlist_archs  # noqa: E402
from repro.launch import hlo_analysis as jhlo  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch.configs import SHAPES, get, list_archs  # noqa: E402
from repro_torch.launch import roofline as troof  # noqa: E402
from repro_torch.launch.op_analysis import Cost  # noqa: E402

H100 = troof.H100
COST = dict(flops=3.7e14, bytes=2.1e12, coll_bytes=4.5e10, seq_iters=9e3)
#: The architectures the reference has too. The port's own
#: (moonlight-16b-a3b) have no JAX counterpart; test_model_flops_of_mla
#: and tests/test_torch_mla.py hold them to their plain reference.
SHARED_ARCHS = [a for a in list_archs() if a in jlist_archs()]


@pytest.mark.parametrize("shape", [s.name for s in SHAPES])
@pytest.mark.parametrize("arch", SHARED_ARCHS)
def test_model_flops_equal_reference(arch, shape):
    tshape = next(s for s in SHAPES if s.name == shape)
    jshape = next(s for s in JSHAPES if s.name == shape)
    assert troof.model_flops(get(arch), tshape) == \
        jroof.model_flops(jget(arch), jshape)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "xlstm-125m", "jamba-1.5-large-398b"])
@pytest.mark.parametrize("chips", [1, 256, 512])
def test_build_report_matches_reference_with_h100(arch, chips):
    """The reference's report with a Hardware holding the H100's numbers
    (collectives at the between-node rate, which the port charges bytes
    on no known axis) equals the port's, field by field."""
    shape, jshape = SHAPES[0], JSHAPES[0]
    kinds = {"all-reduce": 3e10, "all-gather": 1.5e10}
    jcost = jhlo.Cost(**COST, coll_by_kind=dict(kinds))
    tcost = Cost(**COST, coll_by_kind=dict(kinds))
    jhw = jroof.Hardware(name="h100", peak_flops=H100.peak_flops,
                         hbm_bw=H100.hbm_bw, link_bw=H100.node_link_bw,
                         hbm_bytes=H100.hbm_bytes,
                         loop_latency=H100.loop_latency)
    want = jroof.build_report(arch, jshape, "pod", chips, jcost, jget(arch),
                              hbm_per_chip=1e9, hw=jhw)
    got = troof.build_report(arch, shape, "pod", chips, tcost, get(arch),
                             hbm_per_chip=1e9)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.compute_s == COST["flops"] / 989e12
    assert got.memory_s == COST["bytes"] / 3.35e12
    ideal = got.model_flops / (chips * 989e12)
    assert got.roofline_fraction == min(1.0, ideal / got.step_time_s)
    assert "useful=" in troof.format_row(got)


def test_collectives_by_axis_rate():
    """An axis of up to 8 chips runs over NVLink, a wider one over the
    network cards; bytes on no known axis at the slower rate."""
    cost = Cost(coll_bytes=6e9, coll_by_axis={"model": 2e9, "data": 3e9,
                                              "?": 1e9})
    got = troof.collective_seconds(cost, {"model": 8, "data": 16})
    assert got == pytest.approx(2e9 / 450e9 + 3e9 / 50e9 + 1e9 / 50e9)
    assert H100.axis_link_bw(8) == 450e9 and H100.axis_link_bw(16) == 50e9
    rep = troof.build_report("llama3.2-3b", SHAPES[0], "pod", 256, cost,
                             get("llama3.2-3b"),
                             axis_sizes={"model": 8, "data": 16})
    assert rep.collective_s == pytest.approx(got)
    assert rep.bottleneck == "collective"


def test_model_flops_of_mla():
    """Latent attention's model FLOPs: 6 N_active T for training, 2
    N_active T for a prefill, where N_active counts a token's top-6 of the
    experts; its decode shapes are not applicable (no latent cache)."""
    cfg = get("moonlight-16b-a3b")
    n = cfg.active_param_count()
    assert 2.9e9 < n < 3.0e9 and 15.9e9 < cfg.param_count() < 16.0e9
    for shape in SHAPES:
        tokens = shape.global_batch * shape.seq_len
        if shape.kind == "train":
            assert troof.model_flops(cfg, shape) == 6.0 * n * tokens
        elif shape.kind == "prefill":
            assert troof.model_flops(cfg, shape) == 2.0 * n * tokens
