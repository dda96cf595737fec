"""PyTorch/CUDA port of the raw-array caching engine.

The counterpart of the JAX package ``repro``, module for module
(``core``, ``backend``, ``faults``, ``obs``, ``arrayio``,
``kernels.simjoin``). It imports ``torch`` and ``numpy`` and nothing of
``repro`` or ``jax``. The main entry point is
:class:`repro_torch.core.cluster.RawArrayCluster`, re-exported here,
which runs on the card by default (``device="cuda"``); tests pass
``device="cpu"``.

``repro_torch.core`` is imported first, whatever submodule a caller
names: the planning modules and ``faults`` import each other, and only
this order resolves the cycle (importing ``backend`` or ``faults``
first fails, as it does in the reference package).
"""
from repro_torch.core.cluster import RawArrayCluster

__all__ = ["RawArrayCluster"]
