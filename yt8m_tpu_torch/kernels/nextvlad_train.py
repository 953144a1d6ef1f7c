"""Trainable NeXtVLAD aggregation: the serving kernel's forward and a CUDA
backward behind a torch.autograd.Function.

Replaces yt8m_tpu/kernels/nextvlad_train.py :: nextvlad_aggregate_train,
a custom VJP whose forward is the serving kernel and whose backward
(one pallas_call) recomputes each video and accumulates the five weight
gradients across its sequential grid. The contract is the JAX one:
gradients for the five weights, none for the frames and num_frames
(reader data). With `r` the cast to the compute dtype (bf16 on the
card), and the forward of kernels/nextvlad.py (xe, alpha, sm, assign,
a_sum, the pre-norm v and out = v / n, n = sqrt(max(sum_P v^2, 1e-12))),
per video:

    dv       = (dy - out * sum_P(out * dy)) / n   where sum_P v^2 > 1e-12,
               dy / n (the clamp branch) elsewhere
    cdot[k]  = sum_P centers[k] * dv[k]
    d_assign = xg @ r(dv)^T - cdot                      [F, G, K]
    d_alpha  = sum_K d_assign * sm * live,  d_sm = d_assign * alpha * live
    d_act    = sm * (d_sm - sum_K sm * d_sm)            (softmax VJP)
    d_pre    = d_alpha * alpha * (1 - alpha)            (sigmoid VJP)
    d_xg     = r(assign) @ r(dv)
    d_xe     = d_xg + r(d_act) @ r(Wc)^T + r(d_pre) @ r(Wa)^T
    dWc = sum xe^T r(d_act),  dWa = sum xe^T r(d_pre),  dab = sum d_pre,
    dWe = sum r(x)^T r(d_xe),  dcenters = -sum_b a_sum (x) dv

summed over every video's live frames, each product of rounded operands
summed in f32. `nextvlad_aggregate_train_plain_backward` recomputes the
forward and computes these at the same rounding points.

The CUDA backward (csrc/nextvlad_train.cu) reads residuals that the
forward keeps in its packed row layout (kernels/nextvlad.py ::
packed_layout; the JAX forward keeps none and recomputes): the bf16
frames and xe, the bf16 assignment, the f32 softmax and alpha, the
pre-norm v and a_sum; at B = 256, F = 300 and the reference widths that
is 177 + 354 + 157 + 315 + 2.5 + 38 MB, about 1.04 GB, for the packed
rows only. They are the forward's own values, so the gradients are
those of a recomputation. Every product runs on the TMA + wgmma mainloop
of csrc/hopper_gemm.cuh. Its launches: dv, cdot and dcenters; d_assign
over each video's (frame, group) rows with the softmax and sigmoid VJPs
in its epilogue; d_xg = r(assign) @ r(dv) over the same rows; d_xe, one
product [r(d_act) | r(d_pre)] @ [Wc | Wa]^T over the packed rows, plus
d_xg, rounded to bf16 once; the weight-gradient products [xe^T (d_act |
d_pre)] and xb^T d_xe as split-K products, each split an equal range of
packed rows writing f32 partials that a second pass adds in a fixed
order (no atomics: two runs give the same bits); and dab. It
materialises at B = 256: d_act 159 MB, d_xg 708 MB (f32), d_xe 354 MB at
most, the partials 8 x (9.5 + 10.6) MB.

`nextvlad_train_forward.launches` and `nextvlad_train_backward.launches`
count the kernel calls (one each way a training step).
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import on_cpu, require, require_cuda_operand
from yt8m_tpu_torch.kernels.nextvlad import (
    MAX_CLUSTERS,
    NORM_EPS_SQ,
    TILE,
    WGRAD_SPLITS,
    _live_rows,
    _r,
    _shapes,
    forward_plain,
    kernel_layout,
    launch_forward,
    nextvlad_aggregate_plain,
    packed_capacity,
    unpacked,
)


def plain_backward_steps(frames, num_frames, expand_w, attn_w, attn_b,
                         cluster_w, centers, dy, groups, dtype=torch.bfloat16,
                         fw=None) -> dict:
    """The plain backward's steps with the CUDA backward's rounding points
    (the forward recomputed, or `fw`, forward_plain's dict): dv, cdot,
    dvb = r(dv) [B, K, P]; d_assign (cdot subtracted), d_act [B, F, G, K]
    and d_pre [B, F, G] f32; d_xg and d_xe [B * F, De] f32 before the
    rounding; and the five weight gradients."""
    if fw is None:
        fw = forward_plain(frames, num_frames, expand_w, attn_w, attn_b,
                           cluster_w, centers, groups, dtype)
    b, f, d = frames.shape
    g = groups
    de = expand_w.shape[1]
    p = de // g
    k = cluster_w.shape[1] // g
    dy = dy.to(torch.float32)
    v, y, ss = fw["vlad"], fw["out"], fw["sum_sq"]
    n = torch.sqrt(torch.clamp_min(ss, NORM_EPS_SQ))
    ydotdy = torch.sum(y * dy, dim=2, keepdim=True)
    dv = torch.where(ss > NORM_EPS_SQ, (dy - y * ydotdy) / n, dy / n)
    c = centers.to(torch.float32)
    cdot = torch.sum(c[None] * dv, dim=2)                        # [B, K]
    dcenters = torch.sum(-fw["a_sum"][:, :, None] * dv, dim=0)
    dvb = _r(dv, dtype)
    xg = fw["xe"].reshape(b, f * g, p)
    d_assign = (torch.matmul(xg, dvb.transpose(1, 2)).reshape(b, f, g, k)
                - cdot[:, None, None, :])
    live = fw["live"].to(torch.float32)[:, :, None, None]
    sm, alpha = fw["sm"], fw["alpha"][..., None]
    d_alpha = torch.sum(d_assign * sm * live, dim=-1)          # [B, F, G]
    d_sm = d_assign * alpha * live
    d_act = sm * (d_sm - torch.sum(sm * d_sm, dim=-1, keepdim=True))
    d_pre = d_alpha * fw["alpha"] * (1.0 - fw["alpha"])
    d_xg = torch.matmul(_r(fw["assign"], dtype).reshape(b, f * g, k), dvb)
    d_actb = _r(d_act, dtype).reshape(b * f, g * k)
    d_preb = _r(d_pre, dtype).reshape(b * f, g)
    d_xe = (d_xg.reshape(b * f, de)
            + torch.matmul(d_actb, _r(cluster_w, dtype).t())
            + torch.matmul(d_preb, _r(attn_w, dtype).t()))
    xe = fw["xe"].reshape(b * f, de)
    return {
        "dv": dv, "cdot": cdot, "dvb": dvb, "d_assign": d_assign,
        "d_act": d_act, "d_pre": d_pre, "d_xg": d_xg.reshape(b * f, de),
        "d_xe": d_xe, "dWe": torch.matmul(_r(fw["x"], dtype).reshape(
            b * f, d).t(), _r(d_xe, dtype)),
        "dWa": torch.matmul(xe.t(), d_preb), "dab": torch.sum(d_pre, (0, 1)),
        "dWc": torch.matmul(xe.t(), d_actb), "dcenters": dcenters,
    }


def nextvlad_aggregate_train_plain_backward(frames, num_frames, expand_w,
                                            attn_w, attn_b, cluster_w,
                                            centers, dy, groups,
                                            dtype=torch.bfloat16):
    """(dWe, dWa, dab, dWc, dcenters) f32 with the CUDA backward's
    rounding points: the forward recomputed, then the VJP above."""
    s = plain_backward_steps(frames, num_frames, expand_w, attn_w, attn_b,
                             cluster_w, centers, dy, groups, dtype)
    return tuple(s[name] for name in ("dWe", "dWa", "dab", "dWc",
                                      "dcenters"))


def nextvlad_train_forward(frames, num_frames, layout):
    """The serving kernel with the backward's residuals kept: (out,
    scratch) as kernels/nextvlad.py :: launch_forward(residuals=True)."""
    out, s = launch_forward(frames, num_frames, layout, residuals=True)
    nextvlad_train_forward.launches += 1
    return out, s


def video_tiles(poff, groups: int):
    """toff [B + 1] int32: the prefix sums of each video's tiles of 128
    (frame, group) rows (the d_assign and d_xg launches' walk)."""
    runs = (poff[1:] - poff[:-1]).to(torch.int64) * groups
    toff = torch.zeros_like(poff)
    torch.cumsum((runs + TILE - 1) // TILE, 0, dtype=torch.int32,
                 out=toff[1:])
    return toff


def launch_backward(num_frames, scratch, layout, dy):
    """Launch the CUDA backward: (dwe [D8, G*Pp], dwext [G*Pp, Kx], dab,
    dcenters, its scratch) from the forward's residuals `scratch`, its
    `layout` (made with training=True) and dy [B, K, P] f32."""
    n = layout["dims"]
    g, k, p, pp, kp = n["G"], n["K"], n["P"], n["Pp"], n["Kp"]
    gp, kx, d8 = n["GP"], n["Kx"], n["D8"]
    cap = scratch["xe"].shape[0]
    b, f = scratch["a_sum"].shape[0], scratch["frames"]
    require(cap == packed_capacity(b, f, g),
            f"scratch of {cap} packed rows is not the forward's")
    require_cuda_operand("dy", dy, torch.float32, (b, k, p))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("wext", layout["wext"], torch.bfloat16, (kx, gp))
    dev = dy.device

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    t = {
        "toff": video_tiles(scratch["poff"], g),
        "dv": empty((b, k, p)), "dvb": empty((b, kp, pp), torch.bfloat16),
        "cdot": empty((b, kp)), "dact": empty((cap, kx), torch.bfloat16),
        "dpre": empty((cap, g)), "dxg": empty((cap, gp)),
        "dxe": empty((cap, gp), torch.bfloat16),
        "part_ext": empty((WGRAD_SPLITS, gp, kx)),
        "part_we": empty((WGRAD_SPLITS, d8, gp)),
    }
    if kp > MAX_CLUSTERS:
        t["dasg"] = empty((cap * g, kp))
    dwe = empty((d8, gp))
    dwext = empty((gp, kx))
    dab = empty((g,))
    dce = empty((k, p))
    r = scratch
    code = _build.library().yt8m_nextvlad_train_backward(
        _build.ptr(r["poff"]), _build.ptr(t["toff"]),
        *(_build.ptr(r[name]) for name in (
            "info", "xb", "xe", "assign", "sm", "alpha", "vlad", "a_sum")),
        _build.ptr(dy), _build.ptr(layout["centers"]),
        _build.ptr(layout["wext"]),
        *(_build.ptr(t[name]) for name in (
            "dv", "dvb", "cdot", "dact", "dpre", "dxg", "dxe", "part_ext",
            "part_we")),
        _build.ptr(t["dasg"]) if "dasg" in t else None,
        _build.ptr(dwe), _build.ptr(dwext), _build.ptr(dab),
        _build.ptr(dce), b, f, d8, g, k, p, cap, WGRAD_SPLITS,
        _build.current_stream(dev),
    )
    _build.check_launch("nextvlad_train_backward", code)
    return dwe, dwext, dab, dce, t


def weight_grads(layout, dwe, dwext, dab, dce):
    """(dWe, dWa, dab, dWc, dcenters) in the weights' shapes from the
    kernel's padded dwe and dwext."""
    n = layout["dims"]
    d, g, k, p, pp, kp = n["D"], n["G"], n["K"], n["P"], n["Pp"], n["Kp"]
    de = g * p
    ext = dwext.reshape(g, pp, -1)[:, :p].reshape(de, -1)
    return (dwe[:d].reshape(d, g, pp)[:, :, :p].reshape(d, de),
            ext[:, g * kp: g * kp + g].contiguous(), dab,
            ext[:, : g * kp].reshape(de, g, kp)[:, :, :k].reshape(de, g * k),
            dce)


def nextvlad_train_backward(num_frames, scratch, layout, dy):
    """The CUDA backward: (dWe, dWa, dab, dWc, dcenters) f32 in the
    weights' shapes (launch_backward's arguments)."""
    dwe, dwext, dab, dce, _ = launch_backward(num_frames, scratch, layout, dy)
    nextvlad_train_backward.launches += 1
    return weight_grads(layout, dwe, dwext, dab, dce)


def nextvlad_train_backward_with_scratch(num_frames, scratch, layout, dy):
    """launch_backward's outputs, for the card's rounding witness; counts
    as a launch."""
    out = launch_backward(num_frames, scratch, layout, dy)
    nextvlad_train_backward.launches += 1
    return out


def backward_on_stream(num_frames, res, layout, dy, dwe, dwext, t) -> dict:
    """The plain steps of the backward fed the kernel's own roundings
    (the forward's residuals `res`, the backward's scratch `t` and
    outputs), over the live frames: {name: (kernel value, plain f32
    value)} for dv, cdot and d_pre (f32), the rounded streams "dvb",
    "d_act" and "d_xe", and the weight-gradient products "dWext" and
    "dWe" on the kernel's bf16 operands."""
    n = layout["dims"]
    g, k, p, pp, kp = n["G"], n["K"], n["P"], n["Pp"], n["Kp"]
    b, f = res["a_sum"].shape[0], res["frames"]
    rows = _live_rows(num_frames, f)
    # The packed residuals and scratch as [B, F, ...] (zeros past n).
    res = {**res, **{name: unpacked(res[name], res, b, f)
                     for name in ("xb", "xe", "assign", "sm", "alpha")}}
    t = {**t, **{name: unpacked(t[name], res, b, f)
                 for name in ("dact", "dpre", "dxe")}}
    v = res["vlad"]
    ss = torch.sum(v * v, dim=2, keepdim=True)
    nrm = torch.sqrt(torch.clamp_min(ss, NORM_EPS_SQ))
    y = v / nrm
    dv = torch.where(ss > NORM_EPS_SQ,
                     (dy - y * torch.sum(y * dy, dim=2, keepdim=True)) / nrm,
                     dy / nrm)
    pairs = {"dv": (t["dv"], dv), "dvb": (t["dvb"][:, :k, :p], dv),
             "cdot": (t["cdot"][:, :k],
                      torch.sum(layout["centers"][None] * t["dv"], dim=2))}
    dvb = t["dvb"].float()
    da = (torch.bmm(res["xe"].reshape(b, f * g, pp).float(),
                    dvb.transpose(1, 2)).reshape(b * f, g, kp)[rows]
          - t["cdot"].repeat_interleave(f, dim=0)[rows][:, None, :])
    sm = res["sm"].reshape(b * f, g, kp)[rows]
    al = res["alpha"].reshape(b * f, g)[rows][..., None]
    d_alpha = torch.sum(da * sm, dim=-1, keepdim=True)
    dsm = da * al
    d_act = sm * (dsm - torch.sum(sm * dsm, dim=-1, keepdim=True))
    del da, dsm
    kd = t["dact"].reshape(b * f, -1)[rows]
    pairs["d_act"] = (kd[:, : g * kp].reshape(-1, g, kp)[..., :k],
                      d_act[..., :k])
    pairs["d_pre"] = (t["dpre"].reshape(b * f, g)[rows],
                      (d_alpha * al * (1.0 - al))[..., 0])
    del sm, d_act
    d_xg = torch.bmm(res["assign"].reshape(b, f * g, kp).float(), dvb)
    d_xe = (d_xg.reshape(b * f, g * pp)[rows]
            + torch.matmul(kd.float(), layout["wext"].float()))
    del d_xg
    kxe = t["dxe"].reshape(b * f, g * pp)[rows]
    pairs["d_xe"] = (kxe, d_xe)
    xe = res["xe"].reshape(b * f, g * pp)[rows].float()
    pairs["dWext"] = (dwext, torch.matmul(xe.t(), kd.float()))
    del xe
    xb = res["xb"].reshape(b * f, -1)[rows].float()
    pairs["dWe"] = (dwe, torch.matmul(xb.t(), kxe.float()))
    return pairs


nextvlad_train_forward.launches = 0
nextvlad_train_backward.launches = 0


class NextVladAggregateTrain(torch.autograd.Function):
    """Intra-normalised descriptors [B, K, P] f32; gradients for the five
    weights, None for frames and num_frames."""

    @staticmethod
    def forward(ctx, frames, num_frames, expand_w, attn_w, attn_b,
                cluster_w, centers, groups, dtype):
        ctx.groups, ctx.dtype = groups, dtype
        ctx.cpu = on_cpu(frames, num_frames, expand_w, attn_w, attn_b,
                         cluster_w, centers)
        if ctx.cpu:
            ctx.save_for_backward(frames, num_frames, expand_w, attn_w,
                                  attn_b, cluster_w, centers)
            return nextvlad_aggregate_plain(frames, num_frames, expand_w,
                                            attn_w, attn_b, cluster_w,
                                            centers, groups, dtype)
        require(dtype == torch.bfloat16,
                "the CUDA kernels compute in bf16; dtype must be bfloat16")
        ctx.layout = kernel_layout(expand_w, attn_w, attn_b, cluster_w,
                                   centers, groups, training=True)
        ctx.nf = num_frames.to(torch.int32).contiguous()
        out, ctx.scratch = nextvlad_train_forward(frames, ctx.nf, ctx.layout)
        return out

    @staticmethod
    def backward(ctx, dy):
        dy = dy.to(torch.float32).contiguous()
        if ctx.cpu:
            grads = nextvlad_aggregate_train_plain_backward(
                *ctx.saved_tensors, dy, ctx.groups, ctx.dtype)
        else:
            grads = nextvlad_train_backward(ctx.nf, ctx.scratch, ctx.layout,
                                            dy)
            ctx.scratch = ctx.layout = None
        return (None, None, *grads, None, None)


def nextvlad_aggregate_train(frames, num_frames, expand_w, attn_w, attn_b,
                             cluster_w, centers, groups,
                             dtype=torch.bfloat16):
    """Differentiable fused NeXtVLAD aggregation: the arguments and result
    of kernels/nextvlad.py :: nextvlad_aggregate, with gradients for the
    five weights. The frames and num_frames get none (reader data)."""
    _shapes(frames, num_frames, expand_w, attn_w, attn_b, cluster_w,
            centers, groups)
    return NextVladAggregateTrain.apply(frames, num_frames, expand_w, attn_w,
                                        attn_b, cluster_w, centers, groups,
                                        dtype)
