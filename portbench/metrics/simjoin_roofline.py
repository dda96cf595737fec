"""Simjoin kernels: the least time of the traced window's joins ((3 d +
1) int32 operations an evaluated cell pair against the assumed int32
ceiling, or the batches' bytes at the HBM rate) over the device time of
the ``simjoin`` kernels, %."""
from portbench.common import kernel_seconds
from portbench.counts import ops, peaks


def read(record):
    w = record.get("trace", {}).get("work", {}).get("simjoin")
    sec = kernel_seconds(record, "simjoin")
    if not w or not w["cell_pairs"] or sec <= 0:
        return None
    return ops.roofline_share(w["cell_pairs"] * ops.cell_pair_ops(w["ndim"]),
                              peaks.INT32_OPS_PER_S, w["bytes"], sec)
