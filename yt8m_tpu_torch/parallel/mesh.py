"""The data axis of a multi-GPU run and its sharding policy (reference:
the JAX package's parallel/mesh.py, data axis only).

A run is one process a card over one axis, "data": each rank takes its
dim-0 block of every global batch. `param_spec` is the FSDP policy: with
--fsdp_min_size > 0, a parameter of at least that many elements whose
dim 0 divides by the number of ranks is sharded on dim 0 (each rank keeps
and steps its block, with its optimizer state and EMA); every other
parameter is replicated. It is mesh.py:61-87's decision on a data-only
mesh, so both packages shard the same variables of a model (the port's
parameter names are the JAX paths with "." for "/").
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

DATA_AXIS = "data"


def param_spec(name: str, shape: Sequence[int], world: int,
               fsdp_min_size: int = 0) -> Tuple:
    """(DATA_AXIS, None, ...) where the parameter `name` of `shape` is
    sharded on dim 0 over `world` ranks, () where it is replicated."""
    del name  # the data-axis policy reads the shape only, as mesh.py's
    shape = tuple(int(s) for s in shape)
    if (fsdp_min_size and world > 1 and len(shape) >= 1
            and math.prod(shape) >= fsdp_min_size
            and shape[0] % world == 0):
        return (DATA_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def is_sharded(spec: Tuple) -> bool:
    return any(axis is not None for axis in spec)


def param_specs(model, world: int, fsdp_min_size: int = 0) -> Dict[str, Tuple]:
    """{name: spec} of the model's trainable parameters."""
    return {name: param_spec(name, p.shape, world, fsdp_min_size)
            for name, p in model.named_parameters() if p.requires_grad}


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s block of n rows."""
    if n % world:
        raise ValueError(f"{n} rows do not divide over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s rows of a global batch (arrays, tensors or the id
    list), for eval, inference and the replayed train steps."""
    rows = shard_rows(len(batch["batch_mask"]), rank, world)
    return {k: v[rows] for k, v in batch.items()}
