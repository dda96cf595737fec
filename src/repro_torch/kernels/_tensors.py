"""Tensor-layout helpers shared by the attention kernels' wrappers."""
from __future__ import annotations

import torch


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it when its data does not start on 16 bytes
    (the kernels read their inputs in 16-byte vectors or by TMA)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()
