"""Multi-GPU runs of the port: the process group (distributed.py) and the
data-axis sharding policy (mesh.py)."""
