"""Launch layer of the port: the training entry point (train.py)."""
