"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on the CPU; False when all are on one
    CUDA device; raises on a mix or on another device type."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def require_cuda_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                         shape) -> None:
    """dtype, shape, contiguity and 16-byte alignment of a kernel operand."""
    require(t.dtype == dtype, f"{name}: dtype {t.dtype}, want {dtype}")
    require(tuple(t.shape) == tuple(shape),
            f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    require(t.is_contiguous(), f"{name}: must be contiguous")
    require(t.data_ptr() % 16 == 0, f"{name}: must be 16-byte aligned")
