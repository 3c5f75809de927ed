"""Framework-free modules of the JAX package's core/ that the port needs,
kept as copies (the port imports nothing of the JAX package): the energy
model and the paper's schedule; and hopper_mapping.py, the Hopper
counterpart of core/tpu_mapping.py, which picks K4's tile."""
