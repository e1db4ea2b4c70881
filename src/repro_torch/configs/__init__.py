"""The port's own copies of the JAX package's configuration numbers."""
