"""Multi-GPU runs of the port: the process group and its (data, model)
grid (distributed.py), the sharding policy (mesh.py) and the
tensor-parallel column products (tensor.py)."""
