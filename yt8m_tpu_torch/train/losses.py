"""Label losses (reference: the JAX package's train/losses.py).

Each loss maps (predictions [B, C] probabilities, labels [B, C] {0, 1})
to a per-example loss [B]; the train step takes the masked batch mean.
Selected by --label_loss class name.
"""

from __future__ import annotations

from typing import Dict, Type

import torch

_EPSILON = 10e-6  # reference losses.py epsilon


class BaseLoss:
    def calculate_loss(self, predictions, labels, **kw):
        raise NotImplementedError


class CrossEntropyLoss(BaseLoss):
    """Per-class sigmoid cross entropy on eps-clipped probabilities,
    summed over classes."""

    def calculate_loss(self, predictions, labels, **kw):
        p = torch.clamp(predictions.to(torch.float32), _EPSILON,
                        1.0 - _EPSILON)
        y = labels.to(torch.float32)
        ce = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))
        return torch.sum(ce, dim=-1)


class HingeLoss(BaseLoss):
    """Labels mapped to +-1, max(0, b + (1 - 2y) p) summed over classes."""

    def __init__(self, b: float = 1.0):
        self.b = b

    def calculate_loss(self, predictions, labels, **kw):
        signs = 1.0 - 2.0 * labels.to(torch.float32)
        hinge = torch.clamp_min(
            self.b + signs * predictions.to(torch.float32), 0.0)
        return torch.sum(hinge, dim=-1)


class SoftmaxLoss(BaseLoss):
    """-sum(label_dist * log_softmax(predictions)), the labels L1-normalised
    with the row sum floored at 10e-8 (the reference's own epsilon)."""

    _EPS = 10e-8

    def calculate_loss(self, predictions, labels, **kw):
        y = labels.to(torch.float32)
        rowsum = torch.clamp_min(torch.sum(y, dim=-1, keepdim=True),
                                 self._EPS)
        log_sm = torch.log_softmax(predictions.to(torch.float32), dim=-1)
        return -torch.sum(y / rowsum * log_sm, dim=-1)


class MixedCrossEntropyDistillLoss(BaseLoss):
    """alpha * CE(labels) + (1 - alpha) * CE(teacher soft targets); CE
    alone without a teacher."""

    def __init__(self, alpha: float = 0.5):
        self.alpha = alpha
        self._ce = CrossEntropyLoss()

    def calculate_loss(self, predictions, labels, teacher=None, **kw):
        hard = self._ce.calculate_loss(predictions, labels)
        if teacher is None:
            return hard
        soft = self._ce.calculate_loss(predictions, teacher)
        return self.alpha * hard + (1.0 - self.alpha) * soft


_LOSSES: Dict[str, Type[BaseLoss]] = {
    "CrossEntropyLoss": CrossEntropyLoss,
    "HingeLoss": HingeLoss,
    "SoftmaxLoss": SoftmaxLoss,
    "MixedCrossEntropyDistillLoss": MixedCrossEntropyDistillLoss,
}


def get_loss(name: str, **kw) -> BaseLoss:
    if name not in _LOSSES:
        raise ValueError(f"unknown loss {name!r}; available {sorted(_LOSSES)}")
    return _LOSSES[name](**kw)
