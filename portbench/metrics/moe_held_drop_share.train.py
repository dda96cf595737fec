"""Expert layer: the share of the (token, k) pairs chosen for an expert
held on this chip that its capacity dropped over the traced steps, %:
100 (1 - kept / held pairs), from the port's counters ``moe.kept_pairs``
and ``moe.held_pairs`` (forward passes only, recomputes not counted)."""


def read(record):
    c = record.get("trace", {}).get("counters", {})
    if not c.get("moe.held_pairs"):
        return None
    return 100.0 * (1.0 - c["moe.kept_pairs"] / c["moe.held_pairs"])
