"""Degree-bucketed SpMM plans, walks and the hand-written CUDA kernels."""
