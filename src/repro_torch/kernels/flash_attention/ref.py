"""Plain PyTorch oracles for flash attention (fp32 softmax, GQA
broadcast): the port of ``repro/kernels/flash_attention/ref.py`` and the
plain versions the CUDA kernels are held against, forward
(:func:`attention_ref`) and backward (:func:`attention_bwd_ref`)."""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30

#: Keys per step of :func:`attention_bwd_ref`'s scan (the reference's
#: ``_blockwise_attention`` default block).
BWD_BLOCK = 512


def _masked_scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
                   q_offset: int, k0: int = 0) -> torch.Tensor:
    """fp32 scores q k^T / sqrt(D) of (B, H, Sq, D) q against (B, H, n, D)
    keys k0 .. k0 + n - 1, with ``causal`` masking to NEG_INF."""
    sq, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        kj = torch.arange(k0, k0 + k.shape[2], device=q.device)[None, :]
        s = torch.where(kj <= qi, s, torch.full_like(s, NEG_INF))
    return s


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, q_offset: int = 0,
                  return_lse: bool = False):
    """q: (B, H, Sq, D); k, v: (B, Hk, Sk, D) -> (B, H, Sq, D) in q's
    dtype. Scores, softmax and the weighted sum run in fp32; with
    ``causal``, query i sees keys j <= i + q_offset. ``return_lse`` also
    returns the (B, H, Sq) fp32 natural-log logsumexp of the masked
    scores, as the reference's ``_blockwise_impl`` does."""
    rep = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    s = _masked_scores(q, k, causal, q_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      q_offset: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients (dq, dk, dv) of attention from the forward's ``out`` and
    ``lse``: the port of the reference's custom backward
    ``_blockwise_bwd`` (``repro/models/attention.py:150``), a scan over
    key blocks of :data:`BWD_BLOCK` that recomputes each block's
    probabilities ``p = exp(s - lse)``.

    q, out, dout: (B, H, Sq, D); k, v: (B, Hk, Sk, D); lse: (B, H, Sq)
    fp32. ``delta = sum_d dout * out``, ``ds = p (dp - delta) / sqrt(D)``
    with ``dp = dout v^T``; dq, dk and dv are summed in fp32, dk and dv
    then over each GQA group of H / Hk query heads, and all three are
    cast to the inputs' dtype. Scores are fp32 products of the inputs, as
    in the forward whose ``lse`` this reads."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = 1.0 / math.sqrt(d)
    kx = torch.repeat_interleave(k, rep, dim=1)
    vx = torch.repeat_interleave(v, rep, dim=1)
    doutf = dout.float()
    qf = q.float()
    delta = torch.einsum("bhqd,bhqd->bhq", doutf, out.float())
    dq = torch.zeros(b, h, sq, d, dtype=torch.float32, device=q.device)
    dk = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    dv = torch.zeros(b, h, sk, d, dtype=torch.float32, device=q.device)
    for k0 in range(0, sk, BWD_BLOCK):
        kb = kx[:, :, k0:k0 + BWD_BLOCK].float()
        vb = vx[:, :, k0:k0 + BWD_BLOCK].float()
        s = _masked_scores(q, kb, causal, q_offset, k0)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum("bhqd,bhkd->bhqk", doutf, vb)
        ds = p * (dp - delta[..., None]) * scale
        dv[:, :, k0:k0 + BWD_BLOCK] = torch.einsum("bhqk,bhqd->bhkd", p,
                                                   doutf)
        dk[:, :, k0:k0 + BWD_BLOCK] = torch.einsum("bhqk,bhqd->bhkd", ds,
                                                   qf)
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb)
    dk = dk.view(b, hk, rep, sk, d).sum(2)
    dv = dv.view(b, hk, rep, sk, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
