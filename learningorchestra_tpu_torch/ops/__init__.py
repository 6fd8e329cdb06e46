"""Ops of the port: attention (kernel K1), row-wise int8 quantization
(kernels K4 and K5) and the attention layer."""
