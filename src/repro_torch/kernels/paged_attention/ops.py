"""Entry point for paged decode attention: the port of
``repro/kernels/paged_attention/ops.py``, with ``impl`` (``"kernel"`` or
``"plain"``) in place of the reference's ``interpret``."""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.paged_attention import \
    paged_attention


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, page_table: torch.Tensor,
                           seq_lens: torch.Tensor,
                           impl: str = "kernel") -> torch.Tensor:
    """Paged decode attention (see ``paged_attention.paged_attention``
    for shapes and semantics)."""
    return paged_attention(q, k_pages, v_pages, page_table, seq_lens,
                           impl=impl)
