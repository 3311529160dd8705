"""Kernel build (nvcc + ctypes) and CUDA-event timing."""
