"""Plain PyTorch oracle for flash attention (fp32 softmax, GQA
broadcast): the port of ``repro/kernels/flash_attention/ref.py`` and the
plain version the CUDA kernel is held against."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, Hk, Sk, D) -> (B, H, Sq, D) in q's
    dtype. Scores, softmax and the weighted sum run in fp32; with
    ``causal``, query i sees keys j <= i + q_offset."""
    b, h, sq, d = q.shape
    _, hk, sk, _ = k.shape
    rep = h // hk
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        kj = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(kj <= qi, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
