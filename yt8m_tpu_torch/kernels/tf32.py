"""The 3xTF32 split of the f32 routes of DBoF v2 and the MoE head.

At --compute_dtype=float32 the card multiplies f32 operands on the TF32
tensor cores as three products (csrc/hopper_gemm.cuh :: consume3). Each
operand v is split into two TF32 values,

    big   = tf32(v)            (to nearest, ties away from zero, a
    small = tf32(v - big)       10-bit mantissa; v - big is exact in f32)

and a product is summed as a_small b_big + a_big b_small + a_big b_big in
f32: big + small holds v to 2^-22 of |v|, and the dropped a_small b_small
is about 2^-22 of |a b|. The activations are split on the card, in the
launch that writes them (csrc/input_affine.cuh, `cvt.rna.tf32.f32`); the
weights once per weight version, here, into the K-major copy that TF32's
wgmma reads (`split_weights`): the models build it with their serving
constants, never on a call. `round_tf32` is the same rounding on a tensor
(integer arithmetic on the bits: the same on the CPU and the card).
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels._checks import require, require_cuda_operand

PITCH = 4  # the split copies' depth: a multiple of 4 f32 (16-byte rows)
_CHUNK = 1 << 24  # elements a step of split_weights (64 MB of f32)


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """f32 v rounded to TF32 (to nearest, ties away from zero, to a 10-bit
    mantissa; the low 13 bits zero), as `cvt.rna.tf32.f32`. Infinities
    and NaNs pass through."""
    bits = v.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isfinite(v), rounded, v)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small): v's two TF32 halves, v ~ big + small."""
    big = round_tf32(v)
    return big, round_tf32(v - big)


def split_weights(w: torch.Tensor) -> torch.Tensor:
    """w [depth, cols] f32 (any strides) -> [2, cols, depth rounded up to
    PITCH] f32: w transposed (each column a row of depth, K-major) and
    split, big in [0], small in [1], zeros past the depth. Made in steps
    of columns, so a weight of gigabytes needs little more memory than
    its copy."""
    depth, cols = w.shape
    dp = -(-depth // PITCH) * PITCH
    out = torch.zeros((2, cols, dp), dtype=torch.float32, device=w.device)
    step = max(1, _CHUNK // max(depth, 1))
    for c0 in range(0, cols, step):
        part = w[:, c0:c0 + step].to(torch.float32).t()
        big, small = split(part)
        out[0, c0:c0 + step, :depth] = big
        out[1, c0:c0 + step, :depth] = small
    return out


def check_split(name: str, split_w, depth: int, cols: int) -> None:
    """The card's split operand: `split_weights` of a [depth, cols]
    weight, contiguous and 16-byte aligned (TMA's rows)."""
    require(split_w is not None,
            f"{name}: the f32 route on the card takes the weight's split "
            f"copy: pass kernels.tf32.split_weights of it")
    require_cuda_operand(name, split_w, torch.float32,
                         (2, cols, -(-depth // PITCH) * PITCH))
