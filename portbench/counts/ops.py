"""Operations and bytes of the work the port's kernels and steps do,
computed from shapes and counts."""
from __future__ import annotations

from typing import Mapping

from portbench.counts.peaks import HBM_BYTES_PER_S


def live_pairs(batch: int, heads: int, seq: int, causal: bool) -> int:
    """(query, key) pairs attention evaluates over ``heads`` heads of
    ``batch`` rows of ``seq`` positions: under a causal mask each query
    sees itself and every earlier key."""
    per_head = seq * (seq + 1) // 2 if causal else seq * seq
    return batch * heads * per_head


def flash_fwd_ops(head_dim: int, pairs: int) -> int:
    """Attention forward: Q K^T and P V, 2 * D flops each a live pair."""
    return 4 * head_dim * pairs


def flash_bwd_ops(head_dim: int, pairs: int) -> int:
    """Attention backward as model work: twice the forward, dP = dO V^T,
    dV = P^T dO, dQ = dS K and dK = dS^T Q at 2 * D flops each a live
    pair (the recomputed Q K^T is overhead and not counted)."""
    return 8 * head_dim * pairs


def flash_fwd_bytes(w: Mapping[str, int]) -> int:
    """Bytes one forward call must move: q, k, v read once, the output
    written once, and the fp32 log-sum-exp written when training."""
    q = w["batch"] * w["seq"] * w["heads"] * w["head_dim"] * w["elem_bytes"]
    kv = w["batch"] * w["seq"] * w["kv_heads"] * w["head_dim"] * \
        w["elem_bytes"]
    lse = w["batch"] * w["heads"] * w["seq"] * 4 if w.get("lse") else 0
    return 2 * q + 2 * kv + lse


def flash_bwd_bytes(w: Mapping[str, int]) -> int:
    """Bytes one backward call must move: q, out, dout, k, v and the
    log-sum-exp read once; dq, dk, dv written once."""
    q = w["batch"] * w["seq"] * w["heads"] * w["head_dim"] * w["elem_bytes"]
    kv = w["batch"] * w["seq"] * w["kv_heads"] * w["head_dim"] * \
        w["elem_bytes"]
    lse = w["batch"] * w["heads"] * w["seq"] * 4
    return 3 * q + 2 * kv + lse + q + 2 * kv


def cell_pair_ops(ndim: int) -> int:
    """int32 operations one cell pair of the L1 similarity join needs:
    per dimension a subtraction, an absolute value and an addition (into
    the distance, the last one into the count), plus the ``<= eps``
    comparison."""
    return 3 * ndim + 1


def train_step_flops(n_active: int, tokens: int, head_dim: int,
                     pairs_per_layer: int, layers: int) -> int:
    """Model FLOPs of one training step (PaLM's MFU count): 6 N T for the
    parameters a token multiplies with (forward and backward), plus 12 D
    a live attention pair in every attention layer. Recomputation under
    remat is not counted: it is overhead, not model work."""
    return 6 * n_active * tokens + 12 * head_dim * pairs_per_layer * layers


def roofline_share(ops: float, ops_per_s: float, nbytes: float,
                   seconds: float) -> float:
    """The least time the work could take on the chip (operations over
    the peak or bytes over the HBM rate, whichever is larger) as a
    percentage of ``seconds``."""
    bound = max(ops / ops_per_s, nbytes / HBM_BYTES_PER_S)
    return 100.0 * bound / seconds
