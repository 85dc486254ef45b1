"""Attention ops, the hand-written CUDA kernels' wrappers and host image ops."""
