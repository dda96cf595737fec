"""AdamW's update: the hand-written CUDA kernels, their wrapper and the
custom ops the optimizer calls."""
