"""Weight interchange with the JAX package."""
