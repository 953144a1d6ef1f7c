"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for CUDA where there is none raises: nothing falls back silently.

On the card every entry point computes float32 as float32: resolving a
CUDA device turns TF32 off for matrix products and for cuDNN's
convolutions (cuDNN allows it by default, so FrameCnnModel's f32 conv1d
would keep about three decimal digits). At --compute_dtype=float32 that
is the reference's arithmetic; at bf16 nothing changes, since operands
rounded to bf16 are exact in TF32.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` (None means "cuda") as a torch.device, checked usable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
