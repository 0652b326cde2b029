"""Attention: the plain path and the hand-written CUDA kernels."""
