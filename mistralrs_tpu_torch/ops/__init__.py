"""Tensor ops and the hand-written CUDA kernels' wrappers (see ops/kernels.py)."""
