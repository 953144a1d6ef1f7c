"""Fused DBoF cluster + max-pool for the serving path.

Replaces yt8m_tpu/kernels/dbof.py :: dbof_cluster_maxpool_v2. For sampled
frames x [B, S, D] (uint8, or float32):

    xa   = round_to(x * in_scale + in_bias, w.dtype)   (affine in f32)
    act  = xa @ w                                      (f32 accumulate)
    out  = max_s relu(act * act_scale + act_bias)      [B, K] f32

The CUDA kernel (csrc/dbof.cu) is bound by the bf16 tensor-core rate at
the serving shapes; it never writes the [B*S, K] activations to device
memory. It applies the input affine once, into a [B*S, D] bf16 buffer
this wrapper allocates, then runs the product with the BN, ReLU and max
over frames in its epilogue (see the source for the design). The model
folds dequantization and both BatchNorms into the two affines, and casts
`w` to bf16 once. The kernel pools at most 32 frames a video; more are
pooled in chunks of 32 frames, one launch each, whose outputs the
wrapper reduces with an elementwise max (a max of maxes is exact).
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

MAX_FRAMES_PER_VIDEO = 32  # S one launch takes (one warp per video)


def dbof_cluster_maxpool_plain(x, w, in_scale, in_bias, act_scale,
                               act_bias):
    """Plain PyTorch version with the kernel's rounding points: the input
    affine in f32, one rounding to w.dtype, exact products summed in f32,
    the cluster affine in f32."""
    xa = x.to(torch.float32) * in_scale + in_bias
    xa = xa.to(w.dtype).to(torch.float32)
    act = torch.matmul(xa, w.to(torch.float32))
    act = torch.relu(act * act_scale + act_bias)
    return torch.amax(act, dim=1)


def dbof_cluster_maxpool_v2(x, w, in_scale, in_bias, act_scale, act_bias):
    """relu-activated cluster activations max-pooled over S: [B, K] f32.

    x [B, S, D] uint8 or float32; w [D, K] in the compute dtype (bf16 on
    the card); the affines are f32 vectors of D and K.
    """
    require(x.dim() == 3, f"x must be [B, S, D], got {tuple(x.shape)}")
    b, s, d = x.shape
    require(w.dim() == 2 and w.shape[0] == d,
            f"w must be [{d}, K], got {tuple(w.shape)}")
    k = w.shape[1]
    if on_cpu(x, w, in_scale, in_bias, act_scale, act_bias):
        return dbof_cluster_maxpool_plain(
            x, w, in_scale, in_bias, act_scale, act_bias
        )
    require(x.dtype in (torch.uint8, torch.float32),
            f"x: dtype {x.dtype}, want uint8 or float32")
    require(w.dtype == torch.bfloat16,
            "the CUDA kernel computes in bf16; w must be bfloat16")
    require(s >= 1, "S must be at least 1")
    require(d % 32 == 0, f"D={d} must be a multiple of 32")
    require(k % 8 == 0, f"K={k} must be a multiple of 8")
    require_cuda_operand("x", x, x.dtype, (b, s, d))
    require_cuda_operand("w", w, torch.bfloat16, (d, k))
    for name, t, n in (("in_scale", in_scale, d), ("in_bias", in_bias, d),
                       ("act_scale", act_scale, k),
                       ("act_bias", act_bias, k)):
        require_cuda_operand(name, t, torch.float32, (n,))
    out = None
    for s0 in range(0, s, MAX_FRAMES_PER_VIDEO):
        part = _launch(x[:, s0:s0 + MAX_FRAMES_PER_VIDEO].contiguous(), w,
                       in_scale, in_bias, act_scale, act_bias)
        out = part if out is None else torch.maximum(out, part)
    return out


def _launch(x, w, in_scale, in_bias, act_scale, act_bias):
    """One launch over x [B, S <= 32, D]."""
    b, s, d = x.shape
    k = w.shape[1]
    out = torch.empty((b, k), dtype=torch.float32, device=x.device)
    xa = torch.empty((b * s, d), dtype=torch.bfloat16, device=x.device)
    lib = _build.library()
    fn = (lib.yt8m_dbof_cluster_maxpool_u8 if x.dtype == torch.uint8
          else lib.yt8m_dbof_cluster_maxpool_f32)
    code = fn(
        _build.ptr(x), _build.ptr(in_scale), _build.ptr(in_bias),
        _build.ptr(w), _build.ptr(act_scale), _build.ptr(act_bias),
        _build.ptr(xa), _build.ptr(out), b, s, d, k,
        _build.current_stream(x.device),
    )
    _build.check_launch("dbof_cluster_maxpool_v2", code)
    dbof_cluster_maxpool_v2.launches += 1
    return out


dbof_cluster_maxpool_v2.launches = 0
