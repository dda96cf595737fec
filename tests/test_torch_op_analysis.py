"""The port's per-chip op analyzer (``repro_torch.launch.op_analysis``),
the counterpart of tests/test_hlo_analysis.py: product FLOPs from the
contracted dims, in-place writes charged by the region written, weights
charged on every read (the stated difference from the reference's
invariant-weight discount), per-chip FLOPs of sharded and replicated
products on a 4-rank fake mesh, and the bytes of known collectives.

The mesh cases run in a subprocess each: a fake process group lives as
long as its process, and an xdist worker runs other test files after
this one."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.op_analysis import OpAnalyzer  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def cost_of(fn, *args):
    """The analyzer's cost of ``fn(*args)`` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        an = OpAnalyzer(record_ops=True)
        with an:
            fn(*fake)
    return an


def test_dot_flops_from_contracting_dims():
    a = torch.empty(4, 32, 64)
    b = torch.empty(4, 64, 16)
    an = cost_of(lambda a, b: torch.einsum("bik,bkj->bij", a, b), a, b)
    assert an.cost.flops == 2 * 4 * 32 * 16 * 64
    assert an.cost.seq_iters >= 1
    an = cost_of(lambda a, b: a[0] @ b[0], a, b)
    assert an.cost.flops == 2 * 32 * 16 * 64


def test_row_write_charged_by_the_row():
    """The KV-cache row write and a copy into a row of a 16 MB buffer are
    charged about the row (read and written), not the buffer."""
    buf = torch.empty(4096, 1024)
    row = torch.empty(1, 1024)

    def write(buf, row):
        buf[7:8].copy_(row)
        buf[torch.tensor([3, 9])] = row.expand(2, 1024)

    an = cost_of(write, buf, row)
    assert an.cost.bytes < 1e6
    table = dict((r[0], r[3]) for r in an.op_table())
    assert table["aten.copy_"] == 2 * 1024 * 4


def test_weight_charged_on_every_read():
    """h = tanh(h @ W) a hundred times: eager PyTorch reads W from memory
    each time, so the analyzer charges it each time (the reference
    discounts a scan's invariant carries to one pass)."""
    h = torch.empty(8, 512)
    w = torch.empty(512, 512)

    def loop(h, w):
        for _ in range(100):
            h = torch.tanh(h @ w)
        return h

    an = cost_of(loop, h, w)
    assert an.cost.bytes >= 100 * 512 * 512 * 4
    assert an.cost.flops >= 100 * 2 * 8 * 512 * 512
    assert an.cost.seq_iters == 200


def run_on_fake_mesh(body):
    """Run ``body`` (Python source) after a 4-rank fake group and a
    ``("model",)`` mesh of 4 exist; returns its stdout."""
    code = textwrap.dedent("""
        import torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import (distribute_tensor, Replicate,
                                              Shard, Partial, DTensor)
        from torch._subclasses.fake_tensor import FakeTensorMode
        from repro_torch.launch.op_analysis import OpAnalyzer
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("model",))
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_sharded_product_counts_a_quarter_per_chip():
    out = run_on_fake_mesh("""
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(32, 4096), mesh, [Replicate()])
            w = distribute_tensor(torch.empty(4096, 8192), mesh, [Shard(1)])
            r = distribute_tensor(torch.empty(4096, 8192), mesh,
                                  [Replicate()])
            sharded, replicated = OpAnalyzer(mesh), OpAnalyzer(mesh)
            with sharded:
                a @ w
            with replicated:
                a @ r
        print(sharded.cost.flops, replicated.cost.flops,
              sharded.cost.coll_bytes)
    """)
    sharded, replicated, coll = map(float, out.split())
    full = 2 * 32 * 4096 * 8192
    assert replicated == full
    assert sharded == full / 4
    assert coll == 0


def test_collective_bytes_of_known_size():
    """An all-reduce of a 4 KB partial sum moves 2 x 4 KB (ring), an
    all-gather of 1 KB shards moves the 1 KB operand; both on the
    ``model`` axis."""
    out = run_on_fake_mesh("""
        with FakeTensorMode():
            p = DTensor.from_local(torch.empty(1024), mesh, [Partial()])
            s = DTensor.from_local(torch.empty(256), mesh, [Shard(0)])
            an = OpAnalyzer(mesh)
            with an:
                p.redistribute(mesh, [Replicate()])
                s.redistribute(mesh, [Replicate()])
        c = an.cost
        print(c.coll_by_kind["all-reduce"], c.coll_by_kind["all-gather"],
              c.coll_by_axis["model"], c.coll_bytes)
    """)
    ar, ag, axis, total = map(float, out.split())
    assert ar == 2 * 1024 * 4
    assert ag == 256 * 4
    assert axis == total == ar + ag
