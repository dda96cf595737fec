"""Plain PyTorch oracle for paged decode attention: the port of
``repro/kernels/paged_attention/ref.py`` and the plain version the CUDA
kernel is held against. Gathers each request's pages into a dense KV
cache and runs masked softmax attention in fp32."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        seq_lens: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k_pages/v_pages: (NP, PS, Hk, D); page_table:
    (B, MAXP) page ids; seq_lens: (B,). Position p of request b is live
    when p < seq_lens[b]; a request with no live position attends
    uniformly over all MAXP * PS positions (softmax of equal masked
    scores), as the reference does. Returns (B, H, D) in q's dtype."""
    b, h, d = q.shape
    _, ps, hk, _ = k_pages.shape
    maxp = page_table.shape[1]
    rep = h // hk
    idx = page_table.long()
    k = k_pages[idx].reshape(b, maxp * ps, hk, d)
    v = v_pages[idx].reshape(b, maxp * ps, hk, d)
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) / math.sqrt(d)
    live = (torch.arange(maxp * ps, device=q.device)[None, None, :]
            < seq_lens.to(q.device)[:, None, None])
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, v.float())
    return out.to(q.dtype)
