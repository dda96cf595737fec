"""Entry point around the flash kernel: the model's (B, S, H, D) layout
in and out, and padding of the sequence to block multiples.

The port of ``repro/kernels/flash_attention/ops.py``: the same contract
(``q_offset`` is never passed; non-causal callers must give Sk % bk ==
0), with ``impl`` (``"kernel"`` or ``"plain"``) in place of the
reference's ``interpret``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention_fwd


def _pad_seq(x: torch.Tensor, block: int) -> torch.Tensor:
    """Zero-pad dim 2 of a (B, H, S, D) tensor to a multiple of block."""
    pad = (-x.shape[2]) % block
    return F.pad(x, (0, 0, 0, pad)) if pad else x


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128,
                    impl: str = "kernel") -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, Hk, D) — model layout in, model
    layout out. Padded query rows are sliced off; padded key columns lie
    past every real query under the causal mask, so only causal calls
    may pad K (non-causal ones must pass Sk % bk == 0)."""
    sq = q.shape[1]
    if not causal and k.shape[1] % bk != 0:
        raise ValueError("non-causal requires Sk % bk == 0")
    qt = _pad_seq(q.transpose(1, 2), bq)
    kt = _pad_seq(k.transpose(1, 2), bk)
    vt = _pad_seq(v.transpose(1, 2), bk)
    out = flash_attention_fwd(qt, kt, vt, causal=causal, bq=bq, bk=bk,
                              impl=impl)
    return out[:, :, :sq].transpose(1, 2)
