"""Pure-torch oracle for the simjoin kernels."""
from __future__ import annotations

import torch


def count_pairs_ref(a: torch.Tensor, b: torch.Tensor, eps: int,
                    same: bool) -> torch.Tensor:
    """a: (Na, d), b: (Nb, d) integer coords. Number of (x, y) pairs with
    L1(x, y) <= eps; in self-join mode each unordered pair counts once and
    identical indices are excluded. Distances in int64, an int32 result."""
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return torch.zeros((), dtype=torch.int32, device=a.device)
    dist = (a[:, None, :].to(torch.int64)
            - b[None, :, :].to(torch.int64)).abs().sum(-1)
    hit = dist <= eps
    if same:
        i = torch.arange(a.shape[0], device=a.device)[:, None]
        j = torch.arange(b.shape[0], device=a.device)[None, :]
        hit = hit & (i < j)
    return hit.sum().to(torch.int32)
