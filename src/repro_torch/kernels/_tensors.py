"""Tensor-layout and dispatch helpers shared by the kernels' wrappers."""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its data does not start on 16 bytes
    (the kernels read their inputs in 16-byte vectors or by TMA)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def run_op(op: Callable, cuda: Callable, cpu: Callable, *args):
    """Call a kernel's custom op where something must see the call as
    one op: a tensor subclass among the arguments, lists included (a fake
    tensor, or a ``DTensor``, which the op refuses) or an active dispatch
    mode (``FakeTensorMode``, ``launch.op_analysis``). Plain tensors with
    no mode take the op's own CUDA or CPU kernel directly, by the first
    tensor's device: the op's dispatch would add nothing there, and its
    first call in a process imports ``torch.distributed.tensor``, sympy
    and dynamo (seconds)."""
    tensors = [x for a in args
               for x in (a if isinstance(a, (list, tuple)) else (a,))
               if isinstance(x, torch.Tensor)]
    if is_in_torch_dispatch_mode() or \
            any(type(x) is not torch.Tensor for x in tensors):
        return op(*args)
    return (cuda if tensors[0].device.type == "cuda" else cpu)(*args)
