"""Model registry keyed by the reference class names (`--model`), with
whether each model reads frame-level features (the JAX package's
models/registry.py)."""

from __future__ import annotations

from typing import Callable, Dict, List

from yt8m_tpu_torch.models.hparams import ModelHParams

_REGISTRY: Dict[str, Callable] = {}
_FRAME_LEVEL: Dict[str, bool] = {}


def register(name: str, frame_level: bool):
    def deco(cls):
        _REGISTRY[name] = cls
        _FRAME_LEVEL[name] = frame_level
        return cls

    return deco


def get_model(name: str, hparams: ModelHParams):
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](hparams)


def is_frame_level_model(name: str) -> bool:
    if name not in _FRAME_LEVEL:
        raise ValueError(f"unknown model {name!r}")
    return _FRAME_LEVEL[name]


def list_models() -> List[str]:
    return sorted(_REGISTRY)
