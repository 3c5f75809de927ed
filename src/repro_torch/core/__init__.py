"""Framework-free modules of the JAX package's core/ that the port needs,
kept as copies (the port imports nothing of the JAX package)."""
