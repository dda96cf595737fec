"""Device: the share of the traced window in which no operation ran on
the device, % (the union of the profiler's device intervals)."""
from portbench.common import idle_share


def read(record):
    return idle_share(record)
