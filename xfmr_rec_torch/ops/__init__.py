"""Packed-key top-k and its Hopper kernels; the loss family, masking and
similarity."""
