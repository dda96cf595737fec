"""Operation, byte and peak arithmetic of the benchmark's roofline and MFU
metrics: functions of shapes and counts only, so they read the same work
whatever kernel carries it."""
