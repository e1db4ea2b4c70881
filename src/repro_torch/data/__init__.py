"""Numpy-only data helpers (copies of the JAX package's jax-free modules)."""
