"""Packed-key top-k and its Hopper kernels."""
