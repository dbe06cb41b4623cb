"""The benchmark's plain reference: plain PyTorch and NumPy.

Nothing here imports `jax`, the JAX package or the port: the check that
decides a run's `correct` holds the port's answers against what these
modules compute from the inputs the benchmark made itself.
"""
