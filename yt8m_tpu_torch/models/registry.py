"""Model registry keyed by the reference class names (`--model`).

Only the models the port has are registered; asking for another raises
with the list of those available.
"""

from __future__ import annotations

from typing import Callable, Dict

from yt8m_tpu_torch.models.hparams import ModelHParams

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def get_model(name: str, hparams: ModelHParams):
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](hparams)
