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

On the card (csrc/netvlad_train.cu; `plan` describes the launches) the
forward runs the softmax once per live frame into a bf16 assignment
buffer and a_sum, then a persistent TMA + wgmma product over (video, 256
clusters, 128 columns) tiles that rounds x to bf16 in shared memory; the
backward rounds dvlad to bf16 once (with cdot), then a persistent TMA +
wgmma product over (video, 64 frames) tiles whose epilogue is the
softmax VJP, and, with dx, a batched product on
csrc/hopper_product.cuh. The wrappers allocate the bf16 buffers. D must
be a multiple of 4 on the card (TMA reads x's rows). Any K runs on the
card up to what one block's shared memory holds of the forward's softmax
rows (`max_clusters()`: 19,285): above MAX_CLUSTERS the forward stages
fewer frames a chunk (`assign_rows`), and the backward's product stores
dassign into dact over tiles of 512 clusters while a second launch, a
warp a row, does the softmax VJP over the row's K (`plan`'s "wide").

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

MAX_CLUSTERS = 512  # K the backward's registers hold; above: "wide"

# csrc/netvlad_train.cu's tiles (yt8m_netvlad_core_plan reads the
# kernels' own).
FRAMES = 64            # frames a forward stage and a backward tile
FWD_CLUSTERS = 256     # clusters a forward tile (four m64 blocks)
FWD_COLS = 128         # columns a forward tile (64 a consumer warpgroup)
FWD_STAGES = 3
DEPTH = 64             # D a backward stage (64 bf16: the swizzle's row)
F32_BOX = (32, FRAMES, 1)   # x's boxes: [64 frames][32 columns] f32
B16_BOX = (64, FRAMES, 1)   # the assignment's: [64 frames][64 clusters]
V_BOX = (DEPTH, 256, 1)     # bf16(dvlad)'s: [256 clusters][64 deep]
ASSIGN_ROWS = 32       # frames a chunk of the assignment launch, at most
ASSIGN_SMEM = 232448 - 1024  # the assignment launch's dynamic shared memory
SMS = 132              # an H100's SMs: the persistent grids' cap


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pad8(n: int) -> int:
    return _ceil(n, 8) * 8


def assign_rows(k: int) -> int:
    """Frames a chunk of the assignment launch at K clusters: two chunk
    buffers of K floats and the column sums fit its shared memory (0: K
    is too wide for a block)."""
    return max(0, min(ASSIGN_ROWS, (ASSIGN_SMEM - 4 * k) // (8 * k)))


def max_clusters() -> int:
    """The widest K the card takes: assign_rows(K) >= 1, two rows and
    the column sums of K floats each."""
    return ASSIGN_SMEM // 12


def plan(b: int, f: int, k: int, d: int, sms: int = SMS) -> dict:
    """The card's launches for act [B, F, K], x [B, F, D]: the forward's
    tiles (video, cluster tile, column tile; the column tile fastest) and
    the backward's (video, frame tile and, above MAX_CLUSTERS, cluster
    tile of 512; the cluster tile fastest, then the frame tile), their
    persistent grids, the TMA boxes (innermost first), each map's global
    strides in bytes and the shared memory."""
    kp, dp = _pad8(k), _pad8(d)
    kh = 128 if k <= 256 else 256  # clusters a backward consumer warpgroup
    wide = k > MAX_CLUSTERS
    bwd_kt = _ceil(k, 2 * kh) if wide else 1
    rows = assign_rows(k)
    col_tiles, cluster_tiles = _ceil(d, FWD_COLS), _ceil(k, FWD_CLUSTERS)
    fwd_tiles = b * cluster_tiles * col_tiles
    fwd_stage = 4 * 64 * FRAMES * 2 + 4 * 32 * FRAMES * 4
    bwd_stages = 4 if kh == 128 else 2
    bwd_stage = 2 * 32 * FRAMES * 4 + 2 * kh * DEPTH * 2
    frame_tiles = _ceil(f, FRAMES)
    bwd_tiles = b * frame_tiles * bwd_kt
    return {
        "kp": kp, "dp": dp, "wide": wide, "assign_rows": rows,
        "assign_smem": (2 * rows + 1) * k * 4,
        "bwd_cluster_tiles": bwd_kt,
        "softmax_blocks": _ceil(b * f, 8) if wide else 0,
        "fwd_col_tiles": col_tiles, "fwd_cluster_tiles": cluster_tiles,
        "fwd_tiles": fwd_tiles, "fwd_grid": min(fwd_tiles, sms),
        "fwd_stage_bytes": fwd_stage,
        "fwd_smem": FWD_STAGES * fwd_stage + 2 * 2 * 64 * FRAMES * 2
        + 2 * FWD_STAGES * 8 + 1024,
        "box_assign": B16_BOX, "box_x": F32_BOX, "box_v": V_BOX,
        "strides_assign": (kp * 2, f * kp * 2),
        "strides_x": (d * 4, f * d * 4), "strides_v": (dp * 2, k * dp * 2),
        "kh": kh, "v_boxes": 2 * kh // V_BOX[1],
        "bwd_frame_tiles": frame_tiles, "bwd_tiles": bwd_tiles,
        "bwd_grid": min(bwd_tiles, sms), "bwd_k_steps": _ceil(d, DEPTH),
        "bwd_stages": bwd_stages, "bwd_stage_bytes": bwd_stage,
        "bwd_smem": bwd_stages * bwd_stage + 3 * 64 * FRAMES * 2
        + 2 * 3 * 2 * FRAMES * 4 + 2 * bwd_stages * 8 + 1024,
    }


def fwd_tile_of(t: int, p: dict):
    """Forward tile t: (video, clusters, columns), the ranges before
    clipping to K and D."""
    rest, ct = divmod(t, p["fwd_col_tiles"])
    video, kt = divmod(rest, p["fwd_cluster_tiles"])
    return (video, range(kt * FWD_CLUSTERS, (kt + 1) * FWD_CLUSTERS),
            range(ct * FWD_COLS, (ct + 1) * FWD_COLS))


def bwd_tile_of(t: int, p: dict):
    """Backward tile t: (video, frames) before clipping to F."""
    video, ft = divmod(t // p["bwd_cluster_tiles"], p["bwd_frame_tiles"])
    return video, range(ft * FRAMES, (ft + 1) * FRAMES)


def bwd_clusters_of(t: int, p: dict):
    """Backward tile t's clusters before clipping to K: all of them, or
    above MAX_CLUSTERS its tile of 2 Kh (the tile index's fastest part)."""
    if not p["wide"]:
        return range(p["kp"])
    span = 2 * p["kh"]
    kt = t % p["bwd_cluster_tiles"]
    return range(kt * span, (kt + 1) * span)


def kernel_plan() -> dict:
    """The compiled kernels' tiles and the card's SMs (card only)."""
    import ctypes

    out = (ctypes.c_int * 11)()
    _build.check_launch("yt8m_netvlad_core_plan",
                        _build.library().yt8m_netvlad_core_plan(out))
    return dict(zip(("frames", "fwd_clusters", "fwd_cols", "fwd_stages",
                     "fwd_smem", "bwd_stages_128", "bwd_smem_128",
                     "bwd_stages_256", "bwd_smem_256", "assign_rows", "sms"),
                    out))


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
    require(k >= 1 and assign_rows(k) >= 1,
            f"netvlad_core takes 1 <= K <= {max_clusters()} on the card "
            f"(a block's shared memory holds two of its softmax rows), "
            f"got K={k}")
    require(1 <= b <= 65535 and f >= 1,
            f"B={b} must be in [1, 65535] and F={f} at least 1")
    require(d % 4 == 0, f"D={d} must be a multiple of 4 (TMA reads x's rows)")
    require_cuda_operand("act", act, torch.float32, (b, f, k))
    require_cuda_operand("x", x, torch.float32, (b, f, d))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("centers", centers, torch.float32, (k, d))


def netvlad_core_forward(act, x, num_frames, centers):
    """(vlad, a_sum) as netvlad_core_plain_forward: the CUDA forward for
    CUDA tensors (act, x, centers f32, num_frames int32, D a multiple of
    4), the plain version for CPU tensors."""
    b, f, k, d = _shapes(act, x, num_frames, centers)
    if on_cpu(act, x, num_frames, centers):
        return netvlad_core_plain_forward(act, x, num_frames, centers)
    _require_kernel_operands(act, x, num_frames, centers, b, f, k, d)
    vlad = torch.empty((b, k, d), dtype=torch.float32, device=act.device)
    a_sum = torch.empty((b, k), dtype=torch.float32, device=act.device)
    assign = torch.empty((b, f, _pad8(k)), dtype=torch.bfloat16,
                         device=act.device)
    code = _build.library().yt8m_netvlad_core_forward(
        _build.ptr(act), _build.ptr(x), _build.ptr(num_frames),
        _build.ptr(centers), _build.ptr(assign), _build.ptr(vlad),
        _build.ptr(a_sum), b, f, d, k, _build.current_stream(act.device),
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
    dv16 = torch.empty((b, k, _pad8(d)), dtype=torch.bfloat16, device=dev)
    dact = torch.empty((b, f, k), dtype=torch.float32, device=dev)
    dx = p16 = None
    if need_dx:
        dx = torch.empty((b, f, d), dtype=torch.float32, device=dev)
        p16 = torch.empty((b, f, _pad8(k)), dtype=torch.bfloat16, device=dev)
    code = _build.library().yt8m_netvlad_core_backward(
        _build.ptr(act), _build.ptr(x), _build.ptr(num_frames),
        _build.ptr(centers), _build.ptr(dvlad), _build.ptr(cdot),
        _build.ptr(dv16), _build.ptr(p16) if need_dx else None,
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
