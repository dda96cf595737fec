"""The PyTorch and CUDA port's benchmark: one cell (a configuration under a
traffic mix) a run, as ``BENCHMARK.json`` at the repository's root lists
them. See ``run.py``."""
