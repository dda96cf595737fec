"""Attention kernels: the flash backward's least time (8 D flops a live
pair at the bf16 peak, or its bytes at the HBM rate) over the device time
of the ``flash_bwd`` kernels in the traced window, %."""
from portbench.common import kernel_seconds
from portbench.counts import ops, peaks


def read(record):
    w = record.get("trace", {}).get("work", {}).get("flash_attention_bwd")
    sec = kernel_seconds(record, "flash_bwd")
    if not w or not w["calls"] or sec <= 0:
        return None
    pairs = ops.live_pairs(w["batch"], w["heads"], w["seq"], w["causal"])
    return ops.roofline_share(w["calls"] * ops.flash_bwd_ops(w["head_dim"],
                                                             pairs),
                              peaks.BF16_FLOPS_PER_S,
                              w["calls"] * ops.flash_bwd_bytes(w), sec)
