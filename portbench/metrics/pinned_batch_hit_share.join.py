"""Device cache: pinned dispatch batches reused over those looked up in
the window, % (``TorchDeviceBackend.device_stats``)."""


def read(record):
    looked = record.get("pinned_batch_hits", 0) + \
        record.get("pinned_batch_misses", 0)
    if not looked:
        return None
    return 100.0 * record["pinned_batch_hits"] / looked
