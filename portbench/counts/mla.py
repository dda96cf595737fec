"""Operations and bytes of latent attention's work, whose value head
(DV) is narrower than its q/k head (D): the products over the q/k width
and those over the value width are counted apart."""
from __future__ import annotations

from typing import Mapping


def flash_fwd_ops(qk_dim: int, v_dim: int, pairs: int) -> int:
    """Attention forward: Q K^T (2 D flops a live pair) and P V (2 DV)."""
    return 2 * (qk_dim + v_dim) * pairs


def flash_bwd_ops(qk_dim: int, v_dim: int, pairs: int) -> int:
    """Attention backward as model work, twice the forward: dP = dO V^T
    and dV = P^T dO over DV, dQ = dS K and dK = dS^T Q over D, 2 flops a
    column each a live pair (the recomputed Q K^T is overhead and not
    counted)."""
    return 4 * (qk_dim + v_dim) * pairs


def _sizes(w: Mapping[str, int]):
    """(q or k bytes, v or out bytes, lse bytes) of one call."""
    rows = w["batch"] * w["seq"] * w["heads"] * w["elem_bytes"]
    return rows * w["qk_dim"], rows * w["v_dim"], \
        w["batch"] * w["heads"] * w["seq"] * 4


def flash_fwd_bytes(w: Mapping[str, int]) -> int:
    """Bytes one forward call must move: q, k (D wide) and v (DV) read
    once, the output (DV) and the fp32 log-sum-exp written once (q and k
    have as many heads: latent attention's keys are whole heads)."""
    qk, vo, lse = _sizes(w)
    return 2 * qk + 2 * vo + lse


def flash_bwd_bytes(w: Mapping[str, int]) -> int:
    """Bytes one backward call must move: q, k, v, out, dout and the
    log-sum-exp read once; dq, dk and dv written once."""
    qk, vo, lse = _sizes(w)
    return 2 * qk + 3 * vo + lse + 2 * qk + vo


def train_step_flops(n_active: int, tokens: int, qk_dim: int, v_dim: int,
                     pairs_per_layer: int, layers: int) -> int:
    """Model FLOPs of one training step (PaLM's MFU count): 6 N T for the
    parameters a token multiplies with, plus 6 (D + DV) a live attention
    pair in every latent-attention layer (forward and backward).
    Recomputation under remat is not counted."""
    return 6 * n_active * tokens + \
        6 * (qk_dim + v_dim) * pairs_per_layer * layers
