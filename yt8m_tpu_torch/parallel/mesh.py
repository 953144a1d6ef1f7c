"""The (data, model) axes of a multi-GPU run and its sharding policy
(reference: the JAX package's parallel/mesh.py).

A run is one process a card. Each rank takes its data block's rows of
every global batch: its dim-0 block over the data axis, which the mp
ranks of one model group share (parallel/distributed.py :: use_grid).
`param_spec` is mesh.py:61-87's decision, leaf by leaf: with
--model_parallel=mp > 1, a leaf named gates_kernel, experts_kernel,
experts_bias, logistic_kernel, logistic_bias or cluster_kernel whose
last dim divides by mp is sharded on that dim over "model" (each rank
keeps its block of columns, with its gradient, optimizer state and EMA,
and computes with it: parallel/tensor.py); otherwise, with
--fsdp_min_size > 0, a parameter of at least that many elements whose
dim 0 divides by the data axis is sharded on dim 0 over "data" (each
rank keeps and steps its block, with its optimizer state and EMA); every
other parameter is replicated. Both packages shard the same variables
of a model (the port's parameter names are the JAX paths with "." for
"/").
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

from yt8m_tpu_torch.parallel.distributed import grid_shape

DATA_AXIS = "data"
MODEL_AXIS = "model"

# The leaves whose last dim scales with the vocabulary (the MoE head's
# gates and experts, the logistic head, DBoF's cluster layer).
TP_SHARDABLE = ("gates_kernel", "experts_kernel", "experts_bias",
                "logistic_kernel", "logistic_bias", "cluster_kernel")


def param_spec(name: str, shape: Sequence[int], world: int,
               fsdp_min_size: int = 0, model_parallel: int = 1) -> Tuple:
    """(None, ..., MODEL_AXIS) where the parameter `name` of `shape` is
    sharded on its last dim over the model axis, (DATA_AXIS, None, ...)
    where it is sharded on dim 0 over the data axis, () where it is
    replicated, on `world` ranks in a grid of model_parallel columns."""
    data, model = grid_shape(world, model_parallel)
    shape = tuple(int(s) for s in shape)
    if (model > 1 and name.split(".")[-1] in TP_SHARDABLE and len(shape) >= 1
            and shape[-1] % model == 0):
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    if (fsdp_min_size and data > 1 and len(shape) >= 1
            and math.prod(shape) >= fsdp_min_size
            and shape[0] % data == 0):
        return (DATA_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def param_specs(model, world: int, fsdp_min_size: int = 0,
                model_parallel: int = 1) -> Dict[str, Tuple]:
    """{name: spec} of the model's trainable parameters."""
    return {name: param_spec(name, p.shape, world, fsdp_min_size,
                             model_parallel)
            for name, p in model.named_parameters() if p.requires_grad}


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank `rank`'s block of n rows."""
    if n % world:
        raise ValueError(f"{n} rows do not divide over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch: dict, rank: int, world: int) -> dict:
    """Rank `rank`'s rows of a global batch (arrays, tensors or the id
    list), for eval, inference and the replayed train steps (a
    tensor-parallel run passes its data index and data blocks)."""
    rows = shard_rows(len(batch["batch_mask"]), rank, world)
    return {k: v[rows] for k, v in batch.items()}
