"""Entry point around the flash kernels: the model's (B, S, H, D) layout
in and out, padding of the sequence to block multiples, and the gradient.

The port of ``repro/kernels/flash_attention/ops.py``: the same contract
(``q_offset`` is never passed; non-causal callers must give Sk % bk ==
0), with ``impl`` (``"kernel"`` or ``"plain"``) in place of the
reference's ``interpret``. When a gradient is asked for, the call runs
through :class:`FlashAttention`, the counterpart of the reference's
custom VJP around its blockwise attention (``repro/models/attention.py:
127-186``): the forward keeps ``(q, k, v, out, lse)`` and the backward is
:func:`flash_attention_bwd`."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)


def _pad_seq(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad dim 2 of a (B, H, S, D) tensor to a multiple of block."""
    pad = (-x.shape[2]) % block
    return F.pad(x, (0, 0, 0, pad)) if pad else x


class FlashAttention(torch.autograd.Function):
    """Flash attention on padded heads-first (B, H, Sq, D) q and (B, Hk,
    Sk, D) k, v with a gradient: the forward kernel with its ``lse``, the
    backward from the saved ``(q, k, v, out, lse)`` (the reference's
    ``_blockwise_fwd`` / ``_blockwise_bwd`` residuals). Under a
    checkpointed layer the forward runs again in the backward pass and
    writes the same ``lse``: the kernels are deterministic."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, bq: int, bk: int, impl: str):
        """``flash_attention_fwd`` with ``return_lse``; saves the
        residuals."""
        out, lse = flash_attention_fwd(q, k, v, causal=causal, bq=bq, bk=bk,
                                       impl=impl, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.impl = causal, impl
        return out

    @staticmethod
    def backward(ctx, dout):
        """dq, dk, dv through ``flash_attention_bwd``."""
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(),
                                         causal=ctx.causal, impl=ctx.impl)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128,
                    impl: str = "kernel") -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) — model layout in, model
    layout out. Padded query rows are sliced off (so their gradient is
    0); padded key columns lie past every real query under the causal
    mask, so their dk and dv are 0 and sliced off too, and only causal
    calls may pad K (non-causal ones must pass Sk % bk == 0). With grad
    mode on and an input that requires grad, the call is differentiable
    through :class:`FlashAttention`; otherwise it runs the forward alone,
    with no ``lse`` written."""
    sq = q.shape[1]
    if not causal and k.shape[1] % bk != 0:
        raise ValueError("non-causal requires Sk % bk == 0")
    qt = _pad_seq(q.transpose(1, 2), bq)
    kt = _pad_seq(k.transpose(1, 2), bk)
    vt = _pad_seq(v.transpose(1, 2), bk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = FlashAttention.apply(qt, kt, vt, causal, bq, bk, impl)
    else:
        out = flash_attention_fwd(qt, kt, vt, causal=causal, bq=bq, bk=bk,
                                  impl=impl)
    return out[:, :, :sq].transpose(1, 2)
