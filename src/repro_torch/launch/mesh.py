"""Device meshes: the production mesh shapes as data, and a mesh over the
devices that exist.

The port of ``repro/launch/mesh.py``. A ``torch.distributed`` mesh has
one rank per process, over a process group that must exist first.
:func:`make_production_mesh` builds the 256-chip pod (or 512-chip
two-pod) mesh over whatever group exists; in this package that is the
dry-run's fake group (``launch.dryrun``). :func:`make_host_mesh` builds
the mesh of the devices this job really has: with no group yet, it makes
a one-rank group (NCCL on the card, gloo on the CPU), so one H100 is a
``(1, 1)`` mesh. Nothing here runs when the module is imported.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.models.model import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind it: what the
    sharding rules read (``axis_names``, ``shape[name]``)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Number of chips."""
        n = 1
        for s in self.sizes:
            n *= s
        return n


#: The reference's v5e pod: 16 x 16 = 256 chips.
POD = MeshShape(("data", "model"), (16, 16))
#: Two pods: 2 x 16 x 16 = 512 chips.
MULTIPOD = MeshShape(("pod", "data", "model"), (2, 16, 16))


def mesh_over_group(shape: MeshShape, device_type: str = "cpu"
                    ) -> DeviceMesh:
    """A mesh of ``shape`` over ranks ``0 .. shape.size - 1`` of the
    process group that exists, which must have at least that many
    ranks."""
    if not dist.is_initialized() or dist.get_world_size() < shape.size:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a {shape.sizes} mesh needs a process group of at least "
            f"{shape.size} ranks, found {have}: the production meshes are "
            f"reached through repro_torch.launch.dryrun")
    ranks = torch.arange(shape.size).reshape(shape.sizes)
    return DeviceMesh(device_type, ranks, mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> DeviceMesh:
    """The pod (or two-pod) mesh over the process group that exists (the
    dry-run's fake group of 512 ranks)."""
    return mesh_over_group(MULTIPOD if multi_pod else POD, device_type)


def ensure_process_group(device: torch.device) -> None:
    """Make a one-rank process group when none exists: NCCL for a CUDA
    device, gloo for the CPU. A launcher that started several ranks has
    made its group already."""
    if dist.is_initialized():
        return
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_host_mesh(model_parallel: int = 1,
                   device="cuda") -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks of this job, one device
    each: ``(1, 1)`` on one card. ``device="cpu"`` runs it on gloo; a
    CUDA device without a card raises, as ``resolve_device`` does."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    n = dist.get_world_size()
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    mp = max(1, min(model_parallel, n))
    return DeviceMesh(dev.type, torch.arange(n).reshape(n // mp, mp),
                      mesh_dim_names=("data", "model"))
