"""Flash-attention forward: the hand-written CUDA kernel, its wrapper,
the model-layout entry point, and the plain oracle."""
