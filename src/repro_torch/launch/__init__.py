"""Launch layer of the port: the training and serving entry points
(train.py, serve.py), the meshes (mesh.py: training's production and
debug meshes, tensor-parallel serving's serve mesh) and the cells' specs
and shardings (specs.py)."""
