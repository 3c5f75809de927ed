"""Launch layer of the port: the training and serving entry points
(train.py, serve.py), the meshes (mesh.py: training's production and
debug meshes, tensor-parallel serving's serve mesh), the cells' specs,
shardings and steps (specs.py), and the dry run of every cell on the
meta device (dryrun.py) with its cost counter (cost.py)."""
