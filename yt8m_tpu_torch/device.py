"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. Asking
for CUDA where there is none raises: nothing falls back silently.
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
    return dev
