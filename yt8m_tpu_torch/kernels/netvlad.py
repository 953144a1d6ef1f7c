"""Fused NetVLAD aggregation for the serving path.

Replaces yt8m_tpu/kernels/netvlad.py :: netvlad_aggregate. For frames
x [B, F, D] (uint8, dequantized on the fly, or float32), per video:

    act    = round(x) @ round(Wc) * act_scale + act_bias   [F, K] (f32 sum)
    assign = softmax_K(act - max)  * (t < num_frames)       f32
    vlad   = round(assign)^T @ round(x) - colsum(assign) (x) centers
    vlad   = vlad / max(||vlad||_D, 1e-6)        (intra-normalisation)
    vlad   = vlad / max(||vlad||_KD, 1e-6)       (global L2)   [K, D] f32

`round` is the cast to Wc's dtype (bf16 on the card). The CUDA kernel
(csrc/netvlad.cu) is bound by device-memory bytes at the serving shapes
with float32 frames (the [B, K, D] f32 output alone is 604 MB at B=512);
both products run on the tensor cores inside it. The wrapper allocates
the kernel's scratch: the bf16 frames, the bf16 [B, F, K] assignment and
the partial column sums and sums of squares.

The kernel takes D a multiple of 128 and K a multiple of 8 up to 512;
`netvlad_aggregate` pads other shapes so that the result is exact.
Padded features are zero columns of the frames (uint8 frames are first
dequantized to float32, as the plain version does, since no byte
dequantizes to 0), of Wc and of the centers: their residual is 0 and
the norms do not change. Padded clusters get zero Wc columns and a bias
of -1e30, so their assignment is exactly 0 and their rows are zeros,
which the wrapper drops.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

NORM_EPS = 1e-6
FRAME_CHUNK = 64   # frames per block of the assignment launch
D_TILE = 128       # feature columns per block of the aggregation launch
MAX_CLUSTERS = 512  # K one assignment block holds for its softmax
K_MULTIPLE = 8      # clusters: 16-byte rows of Wc and the assignment
PAD_CLUSTER_BIAS = -1e30


def netvlad_assign_plain(frames, num_frames, cluster_w, act_scale,
                         act_bias):
    """(x, assign): the frames rounded to cluster_w.dtype and widened to
    f32 [B, F, D], and the masked f32 softmax assignment [B, F, K] (exact
    products summed in f32)."""
    f = frames.shape[1]
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x * DEQUANT_SCALE + DEQUANT_BIAS
    x = x.to(cluster_w.dtype).to(torch.float32)
    act = torch.matmul(x, cluster_w.to(torch.float32))
    act = act * act_scale + act_bias
    act = act - torch.amax(act, dim=-1, keepdim=True)
    e = torch.exp(act)
    assign = e / torch.sum(e, dim=-1, keepdim=True)
    t = torch.arange(f, device=frames.device)[None, :]
    live = t < num_frames.to(torch.int64)[:, None]
    return x, torch.where(live[:, :, None], assign, torch.zeros_like(assign))


def netvlad_residuals_plain(assign, a_sum, x, centers):
    """Both norms of assign^T @ x - a_sum (x) centers: assign [B, F, K]
    (already rounded), a_sum [B, K], x [B, F, D], all f32."""
    # Imported here: the models package imports this module.
    from yt8m_tpu_torch.models.frame_utils import l2_normalize

    vlad = torch.matmul(assign.transpose(1, 2), x)
    vlad = vlad - a_sum[:, :, None] * centers
    vlad = l2_normalize(vlad, dim=2, eps=NORM_EPS)
    return l2_normalize(vlad, dim=(1, 2), eps=NORM_EPS)


def netvlad_aggregate_plain(frames, num_frames, cluster_w, act_scale,
                            act_bias, centers):
    """Plain PyTorch version with the kernel's rounding points: frames and
    the assignment rounded to cluster_w.dtype, exact products summed in
    f32, softmax, column sums and norms in f32."""
    x, assign = netvlad_assign_plain(frames, num_frames, cluster_w,
                                     act_scale, act_bias)
    a_sum = torch.sum(assign, dim=1)
    assign = assign.to(cluster_w.dtype).to(torch.float32)
    return netvlad_residuals_plain(assign, a_sum, x, centers)


def pad_operands(frames, cluster_w, act_scale, act_bias, centers):
    """(frames, cluster_w, act_scale, act_bias, centers) padded to D a
    multiple of 128 and K a multiple of 8 (unchanged where they are)."""
    d, k = cluster_w.shape
    dp = -(-d // D_TILE) * D_TILE
    kp = -(-k // K_MULTIPLE) * K_MULTIPLE
    if (dp, kp) == (d, k):
        return frames, cluster_w, act_scale, act_bias, centers
    pad = torch.nn.functional.pad
    if dp != d:
        if frames.dtype == torch.uint8:
            frames = frames.to(torch.float32) * DEQUANT_SCALE + DEQUANT_BIAS
        frames = pad(frames, (0, dp - d)).contiguous()
    return (frames, pad(cluster_w, (0, kp - k, 0, dp - d)).contiguous(),
            pad(act_scale, (0, kp - k), value=1.0),
            pad(act_bias, (0, kp - k), value=PAD_CLUSTER_BIAS),
            pad(centers, (0, dp - d, 0, kp - k)).contiguous())


def netvlad_aggregate(frames, num_frames, cluster_w, act_scale, act_bias,
                      centers):
    """Normalised VLAD descriptors [B, K, D] f32.

    frames [B, F, D] uint8 or float32; num_frames [B] (int32 on the
    card); cluster_w [D, K] in the compute dtype (bf16 on the card);
    act_scale, act_bias [K] f32 (the folded BN, or ones and the cluster
    biases); centers [K, D] f32.
    """
    require(frames.dim() == 3,
            f"frames must be [B, F, D], got {tuple(frames.shape)}")
    d = frames.shape[2]
    require(cluster_w.dim() == 2 and cluster_w.shape[0] == d,
            f"cluster_w must be [{d}, K], got {tuple(cluster_w.shape)}")
    if on_cpu(frames, num_frames, cluster_w, act_scale, act_bias, centers):
        return netvlad_aggregate_plain(frames, num_frames, cluster_w,
                                       act_scale, act_bias, centers)
    k = cluster_w.shape[1]
    x, w, scale, bias, cen = pad_operands(frames, cluster_w, act_scale,
                                          act_bias, centers)
    out = netvlad_aggregate_with_scratch(x, num_frames, w, scale, bias,
                                         cen)[0]
    return out if out.shape[1:] == (k, d) else out[:, :k, :d].contiguous()


def netvlad_aggregate_with_scratch(frames, num_frames, cluster_w, act_scale,
                                   act_bias, centers):
    """Launch the CUDA kernel; (out, xb, assign, colsum): the descriptors
    [B, K, D] f32 and the kernel's intermediates, the bf16 frames
    [B, F, D], the bf16 assignment [B, 64*ceil(F/64), K] (zeros past F)
    and the f32 column sums of each 64-frame chunk [B, ceil(F/64), K]."""
    b, f, d = frames.shape
    k = cluster_w.shape[1]
    require(frames.dtype in (torch.uint8, torch.float32),
            f"frames: dtype {frames.dtype}, want uint8 or float32")
    require(cluster_w.dtype == torch.bfloat16,
            "the CUDA kernel computes in bf16; cluster_w must be bfloat16")
    require(f >= 1, "F must be at least 1")
    require(d % D_TILE == 0, f"D={d} must be a multiple of {D_TILE}")
    require(k % 8 == 0 and 8 <= k <= MAX_CLUSTERS,
            f"K={k} must be a multiple of 8 in [8, {MAX_CLUSTERS}]")
    require_cuda_operand("frames", frames, frames.dtype, (b, f, d))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("cluster_w", cluster_w, torch.bfloat16, (d, k))
    require_cuda_operand("act_scale", act_scale, torch.float32, (k,))
    require_cuda_operand("act_bias", act_bias, torch.float32, (k,))
    require_cuda_operand("centers", centers, torch.float32, (k, d))
    dev = frames.device
    chunks = -(-f // FRAME_CHUNK)
    out = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    xb = torch.empty((b, f, d), dtype=torch.bfloat16, device=dev)
    assign = torch.empty((b, chunks * FRAME_CHUNK, k), dtype=torch.bfloat16,
                         device=dev)
    colsum = torch.empty((b, chunks, k), dtype=torch.float32, device=dev)
    sumsq = torch.empty((b, d // D_TILE, k), dtype=torch.float32, device=dev)
    lib = _build.library()
    fn = (lib.yt8m_netvlad_aggregate_u8 if frames.dtype == torch.uint8
          else lib.yt8m_netvlad_aggregate_f32)
    code = fn(
        _build.ptr(frames), _build.ptr(num_frames), _build.ptr(cluster_w),
        _build.ptr(act_scale), _build.ptr(act_bias), _build.ptr(centers),
        _build.ptr(xb), _build.ptr(assign), _build.ptr(colsum),
        _build.ptr(sumsq), _build.ptr(out), b, f, d, k,
        _build.current_stream(dev),
    )
    _build.check_launch("netvlad_aggregate", code)
    netvlad_aggregate.launches += 1
    return out, xb, assign, colsum


netvlad_aggregate.launches = 0
