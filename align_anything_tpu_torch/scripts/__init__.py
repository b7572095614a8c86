"""Scripts of the port, at the paths of the JAX package's ``scripts/``."""
