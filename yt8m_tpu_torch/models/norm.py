"""BatchNorm with the reference's slim defaults, in eval and training
mode, and the folds that turn it into a per-channel affine for the
serving kernels.

Every BN of the model zoo uses eps 1e-3 and momentum 0.99 (the JAX
package's models/norm.py). torch.nn.BatchNorm1d defaults to eps 1e-5 and
updates its running variance with the unbiased n/(n-1) estimate, so the
port keeps its own. Two kinds, as in the JAX package:

  * `BatchNorm`, flax's nn.BatchNorm: the batch variance is
    max(E[x^2] - E[x]^2, 0) (flax's default fast variance), and
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias;
  * the inline BN of DBoF and NetVLAD (`bn_moments`, `bn_apply`): the
    batch variance is E[(x - mean)^2] (jnp.var), and
    y = (x - mean) * rsqrt(var + eps) * scale + bias.

Training mode normalises with the batch moments (biased variance) and
moves the running statistics once per forward, ra = 0.99 ra + 0.01 batch,
outside autograd.

Cross-replica moments: where the training model's `hparams.bn_axis` is
set (the trainer of a multi-GPU run sets it, and never records it), both
kinds average the first and second moments over the ranks of the process
group, one all-reduce a site whose backward all-reduces the cotangents,
and the variance is max(E[x^2] - E[x]^2, 0) for both (the JAX package's
bn_moments with an axis; for the inline BN this differs from the
single-device E[(x - mean)^2], as it does there). The ranks' batches are
of equal size, so these are the global batch's moments. Without an axis
nothing changes. In a tensor-parallel run the ranks that average are
the data group (parallel/distributed.py): the model group's ranks hold
the same rows, and counting them mp times would be wrong. A BN over a
block's columns (DBoF's cluster BN) moves the running statistics of the
whole, gathered over the model group (`inline_bn`'s `block`).
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.parallel import tensor
from yt8m_tpu_torch.parallel.distributed import (
    all_reduce_,
    data_group,
    group_size,
)

BN_EPS = 1e-3
BN_MOMENTUM = 0.99


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks; the backward sums the cotangents likewise."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone(), group=data_group())

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), group=data_group())


def replica_moments(x):
    """(E[x], max(E[x^2] - E[x]^2, 0)) over axis 0 and over the ranks of
    the data group (one rank where there is none)."""
    ranks = group_size(data_group())
    moments = torch.stack([torch.mean(x, dim=0),
                           torch.mean(torch.square(x), dim=0)])
    if ranks > 1:
        moments = _AllReduceSum.apply(moments) / ranks
    mean, mean2 = moments[0], moments[1]
    return mean, torch.clamp_min(mean2 - torch.square(mean), 0.0)


def bn_fold(scale, bias, mean, var, eps: float = BN_EPS):
    """(s, b) with bn(x) == x * s + b, as the JAX model folds it."""
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def bn_apply(x, scale, bias, mean, var, eps: float = BN_EPS):
    """The inline BN in the JAX model's order."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def bn_moments(x, axis: str = ""):
    """Batch mean and biased variance E[(x - mean)^2] over axis 0 (the
    JAX package's models/norm.py :: bn_moments, jnp.var); cross-replica
    moments where `axis` is set."""
    if axis:
        return replica_moments(x)
    mean = torch.mean(x, dim=0)
    return mean, torch.mean(torch.square(x - mean), dim=0)


def update_running(ra_mean, ra_var, mean, var) -> None:
    """ra = 0.99 ra + 0.01 batch, in place and outside autograd."""
    with torch.no_grad():
        ra_mean.copy_(BN_MOMENTUM * ra_mean + (1.0 - BN_MOMENTUM) * mean)
        ra_var.copy_(BN_MOMENTUM * ra_var + (1.0 - BN_MOMENTUM) * var)


def inline_bn(x, scale, bias, ra_mean, ra_var, training: bool,
              axis: str = "", block=None):
    """The inline BN of DBoF and NetVLAD: batch moments (and a running
    statistics update) in training, the running statistics otherwise.
    With a tensor-parallel `block`, x holds that block's columns of the
    running statistics' whole."""
    if training:
        mean, var = bn_moments(x, axis)
        update_running(ra_mean, ra_var, tensor.gathered(mean.detach(), block),
                       tensor.gathered(var.detach(), block))
    else:
        mean, var = ra_mean, ra_var
    return bn_apply(x, scale, bias, mean, var)


class BatchNorm(nn.Module):
    """flax's nn.BatchNorm over the last axis, with flax's parameter names
    (`scale`, `bias`; running `mean`, `var`) and arithmetic order:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias. `axis` (the
    model's hparams.bn_axis) makes the training moments cross-replica."""

    def __init__(self, features: int, eps: float = BN_EPS, axis: str = ""):
        super().__init__()
        self.eps = eps
        self.axis = axis
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training and self.axis:
            mean, var = replica_moments(x)
            update_running(self.mean, self.var, mean, var)
        elif self.training:
            mean = torch.mean(x, dim=0)
            var = torch.clamp_min(
                torch.mean(torch.square(x), dim=0) - torch.square(mean), 0.0)
            update_running(self.mean, self.var, mean, var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias
