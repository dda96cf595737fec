"""Training: the optimizer, the train step, checkpointing and fault
tolerance (the port of ``repro.train``)."""
