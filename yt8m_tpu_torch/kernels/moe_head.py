"""Fused mixture-of-experts head for the serving path.

Replaces yt8m_tpu/kernels/moe_head.py :: moe_head_serving. For hidden
activations x [B, H] f32:

    G = round(x) @ Wg             [B, C*(M+1)]  column c*(M+1)+m, no bias
    E = round(x) @ We + be        [B, C*M]      column c*M+m
    eg = exp(clamp(G, -80, 80))
    probs = sum_{m<M} eg[..., m] * sigmoid(E[..., m]) / sum_{m<=M} eg[..., m]

`round` is the cast to the weights' dtype (bf16 on the card). The
softmax is in the TPU kernel's ratio form with clamped logits, and the
dummy expert m = M adds to the denominator only. The CUDA kernel
(csrc/moe_head.cu) is bound by the bf16 tensor-core rate and keeps the
[B, C, M+1] and [B, C, M] intermediates on chip.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

CUDA_MIXTURES = range(1, 17)  # num_mixtures the CUDA kernel takes


def moe_head_plain(x, gate_kernel, expert_kernel, expert_bias,
                   num_mixtures: int):
    """Plain PyTorch version with the kernel's rounding points."""
    m = num_mixtures
    b = x.shape[0]
    c = gate_kernel.shape[1] // (m + 1)
    xa = x.to(gate_kernel.dtype).to(torch.float32)
    g = torch.matmul(xa, gate_kernel.to(torch.float32))
    e = torch.matmul(xa, expert_kernel.to(torch.float32)) + expert_bias
    eg = torch.exp(torch.clamp(g, -80.0, 80.0)).reshape(b, c, m + 1)
    num = torch.sum(eg[..., :m] * torch.sigmoid(e.reshape(b, c, m)), -1)
    return num / torch.sum(eg, -1)


def moe_head_serving(x, gate_kernel, expert_kernel, expert_bias,
                     num_mixtures: int):
    """probs [B, C] f32.

    x [B, H] f32; gate_kernel [H, C*(M+1)] and expert_kernel [H, C*M] in
    the compute dtype (bf16 on the card); expert_bias [C*M] f32.
    """
    m = num_mixtures
    require(x.dim() == 2, f"x must be [B, H], got {tuple(x.shape)}")
    b, h = x.shape
    require(gate_kernel.dim() == 2 and gate_kernel.shape[0] == h
            and gate_kernel.shape[1] % (m + 1) == 0,
            f"gate_kernel must be [{h}, C*{m + 1}], "
            f"got {tuple(gate_kernel.shape)}")
    c = gate_kernel.shape[1] // (m + 1)
    if on_cpu(x, gate_kernel, expert_kernel, expert_bias):
        return moe_head_plain(x, gate_kernel, expert_kernel, expert_bias, m)
    require(m in CUDA_MIXTURES,
            f"num_mixtures={m}: the CUDA kernel takes 1..16")
    require(h % 32 == 0, f"H={h} must be a multiple of 32")
    require_cuda_operand("x", x, torch.float32, (b, h))
    require_cuda_operand("gate_kernel", gate_kernel, torch.bfloat16,
                         (h, c * (m + 1)))
    require_cuda_operand("expert_kernel", expert_kernel, torch.bfloat16,
                         (h, c * m))
    require_cuda_operand("expert_bias", expert_bias, torch.float32, (c * m,))
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    code = _build.library().yt8m_moe_head_serving(
        _build.ptr(x), _build.ptr(gate_kernel), _build.ptr(expert_kernel),
        _build.ptr(expert_bias), _build.ptr(out), b, h, c, m,
        _build.current_stream(x.device),
    )
    _build.check_launch("moe_head_serving", code)
    moe_head_serving.launches += 1
    return out


moe_head_serving.launches = 0
