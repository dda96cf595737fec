"""Hand-written Hopper kernels for the compute hot-spots the paper
optimizes, each beside its plain PyTorch version.

Each kernel package ships its CUDA source (``<name>.cu``), a wrapper
module that builds, binds and launches it (``<name>.py``), an ``ops.py``
of entry points mirroring the reference's, and a pure-torch oracle
(``ref.py``). ``simjoin`` carries both the dense grid and the
block-sparse (eps-pruned, pair-list) variant the join executors
dispatch. ``adamw`` (no Pallas counterpart: the optimizer's update, fused
by hand) has no ``ops.py``: ``repro_torch.train.optimizer`` calls its
wrapper's ops, and takes its ``ref.py`` as the plain update.
"""
