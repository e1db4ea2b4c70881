"""Hand-written CUDA kernels of the port, each beside its plain version.

``<name>/ref.py`` is the plain PyTorch version of the JAX package's
``ref.py``; ``<name>/ops.py`` is the wrapper, which runs the plain version
for a CPU tensor and launches the kernel (built from ``csrc/``) for a CUDA
tensor.
"""
