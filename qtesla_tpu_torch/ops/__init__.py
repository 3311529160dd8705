"""Modular arithmetic, twiddle tables, plain transforms and the fused CUDA
kernels' wrappers."""
