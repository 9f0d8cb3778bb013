"""The plain reference: NumPy and PyTorch only.  Nothing here imports
``jax``, the JAX package or the port (``benchmark/tests`` checks it)."""
