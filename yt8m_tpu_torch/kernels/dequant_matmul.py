"""Fused dequantize + per-feature affine + matmul.

Replaces yt8m_tpu/kernels/dequant_matmul.py :: dequant_affine_matmul:

    y[M, N] = (x_u8[M, D] * scale[D] + bias[D]) @ w[D, N]     f32 out

with `scale` and `bias` folding the YT-8M dequantization and an
inference BatchNorm. The compute dtype is the TPU kernel's: bf16 operands
with f32 sums when D >= 512, f32 otherwise. On the card csrc/dequant_matmul.cu
runs it: for bf16, one launch rounds `w` to bf16 on every call (as the
TPU kernel does in its body), a second applies the affine once into a
[M, D] bf16 buffer, and a third runs the tensor-core product, both
buffers allocated by this wrapper; for f32, one tiled FMA product applies
the affine as it loads its tiles. No model of
the JAX package calls it; it is a library op for uint8-input dense
layers.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

BF16_MIN_DEPTH = 512  # D from which the TPU kernel computes in bf16


def compute_dtype(d: int) -> torch.dtype:
    return torch.bfloat16 if d >= BF16_MIN_DEPTH else torch.float32


def dequant_affine_matmul_plain(x_u8, w, scale, bias):
    """Plain PyTorch version with the kernel's rounding points: the affine
    in f32, both operands rounded to the compute dtype, f32 sums."""
    dt = compute_dtype(x_u8.shape[1])
    x = x_u8.to(torch.float32) * scale + bias
    return torch.matmul(x.to(dt).to(torch.float32),
                        w.to(dt).to(torch.float32))


def dequant_affine_matmul(x_u8, w, scale, bias):
    """y = (x_u8 * scale + bias) @ w: [M, N] f32.

    x_u8 [M, D] uint8; w [D, N] f32; scale and bias [D] f32. Any M and N;
    on the card D must be a multiple of 8 when D >= 512.
    """
    require(x_u8.dim() == 2, f"x_u8 must be [M, D], got {tuple(x_u8.shape)}")
    m, d = x_u8.shape
    require(w.dim() == 2 and w.shape[0] == d,
            f"w must be [{d}, N], got {tuple(w.shape)}")
    n = w.shape[1]
    if on_cpu(x_u8, w, scale, bias):
        return dequant_affine_matmul_plain(x_u8, w, scale, bias)
    require(m >= 1 and n >= 1, "M and N must be at least 1")
    require_cuda_operand("x_u8", x_u8, torch.uint8, (m, d))
    require_cuda_operand("w", w, torch.float32, (d, n))
    require_cuda_operand("scale", scale, torch.float32, (d,))
    require_cuda_operand("bias", bias, torch.float32, (d,))
    out = torch.empty((m, n), dtype=torch.float32, device=x_u8.device)
    lib = _build.library()
    stream = _build.current_stream(x_u8.device)
    if compute_dtype(d) == torch.bfloat16:
        require(d % 8 == 0, f"D={d} must be a multiple of 8")
        # The product copies w in 16-byte rows: its bf16 copy has its
        # columns padded (with zeros) to a multiple of 8.
        ldw = -(-n // 8) * 8
        w16 = torch.empty((d, ldw), dtype=torch.bfloat16,
                          device=x_u8.device)
        xa = torch.empty((m, d), dtype=torch.bfloat16, device=x_u8.device)
        code = lib.yt8m_dequant_matmul_bf16(
            _build.ptr(x_u8), _build.ptr(scale), _build.ptr(bias),
            _build.ptr(w), _build.ptr(w16), _build.ptr(xa), _build.ptr(out),
            m, d, n, ldw, stream)
    else:
        code = lib.yt8m_dequant_matmul_f32(
            _build.ptr(x_u8), _build.ptr(scale), _build.ptr(bias),
            _build.ptr(w), _build.ptr(out), m, d, n, stream)
    _build.check_launch("dequant_affine_matmul", code)
    dequant_affine_matmul.launches += 1
    return out


dequant_affine_matmul.launches = 0
