"""Model step: the window's model FLOPs over its seconds, as a share of
the bf16 peak, % (``counts.ops.train_step_flops``)."""


def read(record):
    if not record.get("steps") or record.get("window_s", 0) <= 0:
        return None
    return 100.0 * record["step_flops"] * record["steps"] / \
        record["window_s"] / record["peak_flops"]
