"""Trainable NetVLAD core: a CUDA forward and a CUDA backward behind a
torch.autograd.Function.

Replaces yt8m_tpu/kernels/netvlad_train.py :: netvlad_core, a custom VJP
over two pallas_calls (the forward at :135, the backward at :189), with
its contract. Per video, with n = num_frames live frames:

    assign = softmax_K(act) * (f < n)                    [F, K]  f32
    a_sum  = sum_f assign                                [K]     f32
    vlad   = bf16(assign)^T @ bf16(x) - a_sum (x) centers  [K, D]  f32 sums

and the backward, which recomputes the assignment from act:

    dassign = bf16(x) @ bf16(dvlad)^T - cdot,  cdot[k] = sum_d centers dvlad
    dact    = assign * (dassign - sum_k assign * dassign)
    dx      = bf16(assign) @ bf16(dvlad)
    dcenters = -sum_b a_sum[b] (x) dvlad[b]     (a plain reduction, as in JAX)

The products' operands are rounded to bf16 whatever the compute dtype,
as the TPU kernel rounds them; the plain versions round at the same
points, so the card and the CPU differ only in the order of f32 sums
(and in exp's last bits). The Function saves act, x, num_frames, centers
and a_sum, never the [B, F, K] assignment. dx is skipped when x needs no
gradient (the flagship's frames come from data).

`netvlad_core_forward.launches` and `netvlad_core_backward.launches`
count the kernel calls (one each way a training step).
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

MAX_CLUSTERS = 512


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def masked_assignment(act, num_frames):
    """softmax over K of act [B, F, K] in f32 (max subtracted, exp, divided
    by the sum), 0 on rows f >= num_frames."""
    a = act.to(torch.float32)
    e = torch.exp(a - torch.amax(a, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    f = act.shape[1]
    live = (torch.arange(f, device=act.device)[None, :]
            < num_frames.to(torch.int64)[:, None])
    return torch.where(live[:, :, None], p, 0.0)


def netvlad_core_plain_forward(act, x, num_frames, centers):
    """(vlad [B, K, D], a_sum [B, K]) in f32 with the kernel's rounding
    points."""
    assign = masked_assignment(act, num_frames)
    vlad = torch.matmul(_bf(assign).transpose(1, 2), _bf(x))
    a_sum = torch.sum(assign, dim=1)
    return vlad - a_sum[:, :, None] * centers.to(torch.float32), a_sum


def netvlad_core_plain_backward(act, x, num_frames, centers, dvlad,
                                need_dx: bool = True):
    """(dact [B, F, K], dx [B, F, D] or None) in f32 with the kernel's
    rounding points."""
    assign = masked_assignment(act, num_frames)
    dv = dvlad.to(torch.float32)
    cdot = torch.sum(centers.to(torch.float32)[None] * dv, dim=-1)
    dassign = torch.matmul(_bf(x), _bf(dv).transpose(1, 2)) - cdot[:, None, :]
    s = torch.sum(assign * dassign, dim=-1, keepdim=True)
    dact = assign * (dassign - s)
    dx = torch.matmul(_bf(assign), _bf(dv)) if need_dx else None
    return dact, dx


def _shapes(act, x, num_frames, centers):
    require(act.dim() == 3 and x.dim() == 3,
            f"act and x must be [B, F, K] and [B, F, D], got "
            f"{tuple(act.shape)} and {tuple(x.shape)}")
    b, f, k = act.shape
    d = x.shape[2]
    require(tuple(x.shape[:2]) == (b, f),
            f"x {tuple(x.shape)} does not match act {tuple(act.shape)}")
    require(tuple(num_frames.shape) == (b,),
            f"num_frames must be [{b}], got {tuple(num_frames.shape)}")
    require(tuple(centers.shape) == (k, d),
            f"centers must be [{k}, {d}], got {tuple(centers.shape)}")
    return b, f, k, d


def _require_kernel_operands(act, x, num_frames, centers, b, f, k, d):
    require(1 <= k <= MAX_CLUSTERS,
            f"netvlad_core takes 1 <= K <= {MAX_CLUSTERS}, got K={k}")
    require(1 <= b <= 65535 and f >= 1,
            f"B={b} must be in [1, 65535] and F={f} at least 1")
    require_cuda_operand("act", act, torch.float32, (b, f, k))
    require_cuda_operand("x", x, torch.float32, (b, f, d))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("centers", centers, torch.float32, (k, d))


def netvlad_core_forward(act, x, num_frames, centers):
    """(vlad, a_sum) as netvlad_core_plain_forward: the CUDA forward for
    CUDA tensors (act, x, centers f32, num_frames int32, K <= 512), the
    plain version for CPU tensors."""
    b, f, k, d = _shapes(act, x, num_frames, centers)
    if on_cpu(act, x, num_frames, centers):
        return netvlad_core_plain_forward(act, x, num_frames, centers)
    _require_kernel_operands(act, x, num_frames, centers, b, f, k, d)
    vlad = torch.empty((b, k, d), dtype=torch.float32, device=act.device)
    a_sum = torch.empty((b, k), dtype=torch.float32, device=act.device)
    code = _build.library().yt8m_netvlad_core_forward(
        _build.ptr(act), _build.ptr(x), _build.ptr(num_frames),
        _build.ptr(centers), _build.ptr(vlad), _build.ptr(a_sum), b, f, d, k,
        _build.current_stream(act.device),
    )
    _build.check_launch("netvlad_core_forward", code)
    netvlad_core_forward.launches += 1
    return vlad, a_sum


def netvlad_core_backward(act, x, num_frames, centers, dvlad,
                          need_dx: bool = True):
    """(dact, dx or None) as netvlad_core_plain_backward: the CUDA
    backward for CUDA tensors (dvlad f32 [B, K, D]), the plain version
    for CPU tensors."""
    b, f, k, d = _shapes(act, x, num_frames, centers)
    if on_cpu(act, x, num_frames, centers, dvlad):
        return netvlad_core_plain_backward(act, x, num_frames, centers, dvlad,
                                           need_dx)
    _require_kernel_operands(act, x, num_frames, centers, b, f, k, d)
    require_cuda_operand("dvlad", dvlad, torch.float32, (b, k, d))
    dev = act.device
    cdot = torch.empty((b, k), dtype=torch.float32, device=dev)
    dact = torch.empty((b, f, k), dtype=torch.float32, device=dev)
    dx = (torch.empty((b, f, d), dtype=torch.float32, device=dev) if need_dx
          else None)
    code = _build.library().yt8m_netvlad_core_backward(
        _build.ptr(act), _build.ptr(x), _build.ptr(num_frames),
        _build.ptr(centers), _build.ptr(dvlad), _build.ptr(cdot),
        _build.ptr(dact), _build.ptr(dx) if need_dx else None, b, f, d, k,
        int(bool(need_dx)), _build.current_stream(dev),
    )
    _build.check_launch("netvlad_core_backward", code)
    netvlad_core_backward.launches += 1
    return dact, dx


netvlad_core_forward.launches = 0
netvlad_core_backward.launches = 0


class NetVladCore(torch.autograd.Function):
    """vlad [B, K, D] f32; gradients for act, x (when it needs one) and
    centers. num_frames is integer data."""

    @staticmethod
    def forward(ctx, act, x, num_frames, centers):
        act32 = act.to(torch.float32).contiguous()
        x32 = x.to(torch.float32).contiguous()
        c32 = centers.to(torch.float32).contiguous()
        nf = num_frames.to(torch.int32).contiguous()
        vlad, a_sum = netvlad_core_forward(act32, x32, nf, c32)
        ctx.save_for_backward(act32, x32, nf, c32, a_sum)
        ctx.dtypes = (act.dtype, x.dtype, centers.dtype)
        return vlad

    @staticmethod
    def backward(ctx, dvlad):
        act, x, nf, centers, a_sum = ctx.saved_tensors
        need_act, need_x, _, need_centers = ctx.needs_input_grad
        dv = dvlad.to(torch.float32).contiguous()
        dact = dx = dcenters = None
        if need_act or need_x:
            dact, dx = netvlad_core_backward(act, x, nf, centers, dv, need_x)
        if need_centers:
            dcenters = -torch.einsum("bk,bkd->kd", a_sum, dv)
        act_dtype, x_dtype, c_dtype = ctx.dtypes
        return (None if not need_act else dact.to(act_dtype),
                None if dx is None else dx.to(x_dtype), None,
                None if dcenters is None else dcenters.to(c_dtype))


def netvlad_core(act, x, num_frames, centers):
    """Differentiable fused VLAD core: act [B, F, K] post-BN assignment
    logits, x [B, F, D] float frames, num_frames [B], centers [K, D] ->
    vlad [B, K, D] f32 (not normalised)."""
    return NetVladCore.apply(act, x, num_frames, centers)
