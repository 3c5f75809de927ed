"""Launch layer of the port: the training entry point (train.py) and the
serving mesh of tensor-parallel serving (mesh.py)."""
