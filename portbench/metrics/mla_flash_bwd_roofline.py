"""Attention kernels: latent attention's flash backward at its (q/k,
value) head pair, the least time of the traced window's calls (4 (D +
DV) flops a live pair at the bf16 peak, or its bytes at the HBM rate)
over the device time of the ``flash_bwd`` kernels (delta, dK/dV, dQ),
%."""
from portbench.common import kernel_seconds
from portbench.counts import mla, ops, peaks


def read(record):
    w = record.get("trace", {}).get("work", {}).get("mla_flash_bwd")
    sec = kernel_seconds(record, "flash_bwd")
    if not w or not w["calls"] or sec <= 0:
        return None
    pairs = ops.live_pairs(w["batch"], w["heads"], w["seq"], w["causal"])
    return ops.roofline_share(
        w["calls"] * mla.flash_bwd_ops(w["qk_dim"], w["v_dim"], pairs),
        peaks.BF16_FLOPS_PER_S, w["calls"] * mla.flash_bwd_bytes(w), sec)
