"""Builder and loader for the port's hand-written CUDA kernels."""
