"""Attention kernels: the flash forward's least time (4 D flops a live
pair at the bf16 peak, or its bytes at the HBM rate) over the device time
of the ``flash_fwd`` kernels in the traced window, %."""
from portbench.common import kernel_seconds
from portbench.counts import ops, peaks


def read(record):
    w = record.get("trace", {}).get("work", {}).get("flash_attention_fwd")
    sec = kernel_seconds(record, "flash_fwd")
    if not w or not w["calls"] or sec <= 0:
        return None
    pairs = ops.live_pairs(w["batch"], w["heads"], w["seq"], w["causal"])
    return ops.roofline_share(w["calls"] * ops.flash_fwd_ops(w["head_dim"],
                                                             pairs),
                              peaks.BF16_FLOPS_PER_S,
                              w["calls"] * ops.flash_fwd_bytes(w), sec)
