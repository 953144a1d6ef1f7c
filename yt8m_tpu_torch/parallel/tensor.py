"""Column-parallel products of a tensor-parallel run (--model_parallel;
reference: the JAX package's GSPMD step over a (data, model) mesh, where
parallel/mesh.py :: param_spec shards a head kernel's last dim over
"model").

A parameter that the policy shards is, on each rank, the block of its
columns that the rank's model index names: a Parameter that carries
`tp`, a `Block`. The training forward multiplies by the block and
gathers the product's columns over the model group, so what follows
runs replicated on the mp ranks of a data block, on the same bits. The
autograd functions below make each rank's backward give the gradients
of the data block's loss:

  copy_to_model      identity; the backward sums the cotangent over the
                     model group (the input of a block's product: each
                     rank's product gives its columns' share of it);
  gather_columns     the blocks' columns gathered; the backward takes
                     this rank's columns of the (replicated) cotangent;
  take_columns       this rank's columns of a replicated per-column
                     parameter; the backward gathers the blocks'
                     cotangents, so its gradient is whole on every rank;
  sum_to_model       the sum over the model group of values that meet in
                     the replicated part (a sharded kernel's l2); the
                     backward passes the cotangent through;
  sum_over_model     the sum of per-rank partials that feed the blocks
                     again (a softmax's denominator over the columns);
                     the backward sums the cotangents too.

Serving never sees a block: a checkpoint, an export and every kernel
read the whole tensors (train/state.py gathers them), and a module whose
parameter is a block refuses to build its serving constants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from yt8m_tpu_torch.parallel import distributed


@dataclasses.dataclass(frozen=True)
class Block:
    """This rank's columns of a parameter sharded on its last dim: the
    variable's width `full` in `parts` blocks, this rank's `index`."""
    full: int
    index: int
    parts: int

    @property
    def width(self) -> int:
        return self.full // self.parts

    @property
    def start(self) -> int:
        return self.index * self.width


def block_of(p) -> Optional[Block]:
    """The Block a parameter holds, or None for a whole tensor."""
    return getattr(p, "tp", None)


def whole_shape(p) -> tuple:
    """The shape of the variable a (block) parameter belongs to."""
    blk = block_of(p)
    shape = tuple(p.shape)
    return shape if blk is None else shape[:-1] + (blk.full,)


def columns(t: torch.Tensor, blk: Block) -> torch.Tensor:
    """`blk`'s columns (last dim) of a whole tensor."""
    return t.narrow(-1, blk.start, blk.width)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce_(grad.contiguous().clone(),
                                       group=distributed.model_group())


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, blk):
        ctx.blk = blk
        return distributed.all_gather_rows(
            x, group=distributed.model_group(), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        return columns(grad, ctx.blk).contiguous(), None


class _TakeColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, p, blk):
        return columns(p, blk).clone()

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_gather_rows(
            grad, group=distributed.model_group(), dim=-1), None


class _SumToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce_(x.clone(),
                                       group=distributed.model_group())

    @staticmethod
    def backward(ctx, grad):
        return grad


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return distributed.all_reduce_(x.contiguous().clone(),
                                       group=distributed.model_group())

    @staticmethod
    def backward(ctx, grad):
        return distributed.all_reduce_(grad.contiguous().clone(),
                                       group=distributed.model_group())


def copy_to_model(x):
    return _CopyToModel.apply(x)


def gather_columns(x, blk: Optional[Block]):
    """x whole where `blk` is a Block (x is its columns), else x."""
    return x if blk is None else _GatherColumns.apply(x, blk)


def take_columns(p, blk: Optional[Block]):
    """`blk`'s columns of the replicated p, or p where blk is None."""
    return p if blk is None else _TakeColumns.apply(p, blk)


def sum_to_model(x):
    return _SumToModel.apply(x)


def sum_over_model(x):
    return _SumOverModel.apply(x)


def gathered(t: torch.Tensor, blk: Optional[Block]) -> torch.Tensor:
    """A block's tensor gathered whole outside autograd (the running
    statistics of per-column BatchNorm moments), or t."""
    if blk is None:
        return t
    return distributed.all_gather_rows(t, group=distributed.model_group(),
                                       dim=-1)


def column_products(x, weights, params):
    """[x @ w for w in weights], each whole: where the parameter behind w
    (params, in the same order) is a block, the block's product gathered
    over the model group, x's cotangent summed over it once for all the
    blocks."""
    shared = None
    out = []
    for w, p in zip(weights, params):
        blk = block_of(p)
        if blk is None:
            out.append(torch.matmul(x, w))
            continue
        if shared is None:
            shared = copy_to_model(x)
        out.append(gather_columns(torch.matmul(shared, w), blk))
    return out


def whole(p):
    """A bias-like parameter whole in the forward: its blocks gathered
    where it is a block (the gradient this rank's columns), else p."""
    return gather_columns(p, block_of(p))


def refuse_blocks(module) -> None:
    """Raise where `module` holds a block: serving reads whole tensors."""
    for name, p in module.named_parameters():
        if block_of(p) is not None:
            raise RuntimeError(
                f"{name} is one rank's block of a tensor-parallel variable: "
                f"serve the whole state (ParallelTrainState.model_state "
                f"in a one-card model), not the training model")
