"""Input data: the port's own numpy copies of the JAX package's loaders."""
