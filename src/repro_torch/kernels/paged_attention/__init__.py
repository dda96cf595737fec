"""Paged single-token decode attention: the hand-written CUDA kernel,
its wrapper and entry point, and the plain oracle."""
