"""Eval-mode BatchNorm with the reference's slim defaults, and the folds
that turn it into a per-channel affine for the serving kernels.

Every BN of the model zoo uses eps 1e-3 (and momentum 0.99 in training,
which the serving slice does not run). torch.nn.BatchNorm1d defaults to
eps 1e-5, so the port keeps its own.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-3


def bn_fold(scale, bias, mean, var, eps: float = BN_EPS):
    """(s, b) with bn(x) == x * s + b, as the JAX model folds it."""
    s = scale * torch.rsqrt(var + eps)
    return s, bias - mean * s


def bn_apply(x, scale, bias, mean, var, eps: float = BN_EPS):
    """Eval-mode BN in the JAX model's inline order."""
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis with flax's parameter names
    (`scale`, `bias`; running `mean`, `var`) and flax's arithmetic order:
    y = (x - mean) * (rsqrt(var + eps) * scale) + bias."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "training-mode BatchNorm is not ported yet"
            )
        mul = torch.rsqrt(self.var + self.eps) * self.scale
        return (x - self.mean) * mul + self.bias
