"""Plain references: PyTorch and NumPy only. They import nothing of the
port, of the JAX package or of JAX, and take nothing the port made: the
benchmark hands them the inputs it made itself."""
