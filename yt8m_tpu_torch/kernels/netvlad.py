"""Fused NetVLAD aggregation for the serving path.

Replaces yt8m_tpu/kernels/netvlad.py :: netvlad_aggregate. For frames
x [B, F, D] (uint8, dequantized on the fly, or float32), per video:

    act    = round(x) @ round(Wc) * act_scale + act_bias   [F, K] (f32 sum)
    assign = softmax_K(act - max)  * (t < num_frames)       f32
    vlad   = round(assign)^T @ round(x) - colsum(assign) (x) centers
    vlad   = vlad / max(||vlad||_D, 1e-6)        (intra-normalisation)
    vlad   = vlad / max(||vlad||_KD, 1e-6)       (global L2)   [K, D] f32

`round` is the cast to Wc's dtype, which selects the route on the card.
At bf16 the CUDA kernel (csrc/netvlad.cu) is bound by device-memory
bytes at the serving shapes
with float32 frames (the [B, K, D] f32 output alone is 604 MB at B=512).
It touches only the live 64-frame chunks of each video (`live_items`):
the assignment product on TMA + wgmma with the softmax in its registers,
which also stores the chunks' frames in bf16, then the aggregation
product twice, first for the norms and then to write the normalised
output once (`plan`; the source has the design). Above MAX_CLUSTERS
clusters one block no longer holds a row's softmax: the assignment
product then stores the f32 logits of the live rows, tiled over K, and a
second launch normalises each live chunk's rows over all K (`plan`'s
"wide"). The wrapper allocates the kernel's scratch: the bf16 frames and
the bf16 [B, F, K] assignment (written on the live chunks' rows), the
chunks' column sums, the list of live chunks, the sums of squares and
norms, and above MAX_CLUSTERS the f32 [B, F, K] logits.

At f32 (--compute_dtype=float32) nothing is rounded, as in the TPU
kernel at dtype=float32: csrc/netvlad.cu's f32 route runs both products
on the TF32 tensor cores as 3xTF32 over the same live chunks (each
operand split into two TF32 halves, kernels/tf32.py), the assignment
product on Wc's K-major split copy (`tf32.split_weights`, a serving
constant: the `w_split` argument, which the card requires), then the
aggregation on wgmma, the frames transposed from registers against the
assignment's TF32 halves, which launch 1 writes cluster-major into a
[2, B, K, F rounded up to 4] scratch that this wrapper allocates, then
the norms and an in-place scale (`plan`'s "f32"). Above F32_CLUSTERS clusters it takes the wide path (f32 logits,
then the softmax launch). It pads D and K as the bf16 route does.

The bf16 kernel takes D a multiple of 128 and K a multiple of 8;
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
from yt8m_tpu_torch.kernels import _build, tf32
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

NORM_EPS = 1e-6
FRAME_CHUNK = 64   # frames a chunk: a warpgroup's rows, a product step
D_TILE = 128       # feature columns a tile of the aggregation launches
MAX_CLUSTERS = 512  # K one assignment block's softmax holds; above: "wide"
F32_CLUSTERS = 256  # the same on the f32 route
K_MULTIPLE = 8      # clusters: 16-byte rows of Wc and the assignment
PAD_CLUSTER_BIAS = -1e30

# csrc/netvlad.cu's tiles (yt8m_netvlad_plan reads the kernel's own).
DEPTH = 64            # features a stage of the assignment product
BOX = 64              # rows and columns of a bf16 box (128-byte rows)
B16_BOX = BOX * BOX * 2
F32_BOX = FRAME_CHUNK * 32 * 4  # [64 frames][32] f32 (128-byte rows)
U8_BOX = FRAME_CHUNK * DEPTH    # [64 frames][64 bytes], unswizzled
SMEM_LIMIT = 232448   # shared memory a block can use on an H100
MAX_STAGES = 4
AGG_CLUSTERS = 256    # clusters a tile of the aggregation launches
AGG_FRAMES = 32       # frames a stage of the aggregation launches
AGG_STAGES = 4
SMS = 132             # an H100's SMs: the persistent grids' cap
# The f32 route's: 32-deep assignment stages; aggregation stages of 32
# frames (both halves of the split assignment's [256][32] rows and the
# frames' [32][128] tile), two of them.
F32_DEPTH = 32
F32_AGG_FRAMES = 32
F32_AGG_STAGES = 2
TF32_A_BYTES = 128 * F32_DEPTH * 4  # both warpgroups' rows of one half
U8_TILE = FRAME_CHUNK * F32_DEPTH   # a raw uint8 x tile [64][32 bytes]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def assign_split(k: int):
    """(clusters a consumer warpgroup, split): an item a warpgroup for K
    <= 256 (its 64 frames x K in one chain of 128 or 256), one item
    shared by both warpgroups, K split in two halves of 256, above."""
    if k <= 128:
        return 128, False
    return 256, k > 256


def plan(b: int, f: int, d: int, k: int, x_dtype=torch.float32,
         sms: int = SMS, f32: bool = False) -> dict:
    """csrc/netvlad.cu's launches over frames [B, F, D] and K clusters
    (D a multiple of 128, K of 8): the assignment's items, stage and
    shared memory, the aggregation's tiles (the column tile fastest),
    TMA boxes (innermost first) and shared memory, the scratch. f32: the
    f32 route's (32-deep 3xTF32 stages of both halves of the x tiles and
    of the split Wc rows, never split; 32-frame aggregation stages of
    the split assignment's rows and the frames, no centers tile)."""
    chunks = _ceil(f, FRAME_CHUNK)
    wide = k > (F32_CLUSTERS if f32 else MAX_CLUSTERS)
    w, split = (256, False) if wide else assign_split(k)
    f32_x = x_dtype == torch.float32
    if f32:
        x_load = F32_BOX if f32_x else U8_TILE
        x_bytes, x_tiles, w_boxes = 0, 2, 0
        u8_off = 2 * TF32_A_BYTES + 2 * w * F32_DEPTH * 4
        stage = -(-(u8_off + (0 if f32_x else 2 * U8_TILE)) // 1024) * 1024
    else:
        x_load = 2 * F32_BOX if f32_x else U8_BOX
        # A stage's x tile is rounded to bf16 in place: room for both.
        x_bytes = max(x_load, B16_BOX)
        x_tiles = 1 if split else 2
        w_boxes = (2 if split else 1) * w // BOX
        stage = x_tiles * x_bytes + w_boxes * B16_BOX
    red_floats = 2 * 4 * w + (2 * 2 * 2 * FRAME_CHUNK if split else 0)
    fixed = (red_floats + 2 * MAX_CLUSTERS) * 4 + 2 * MAX_STAGES * 8
    stages = min(MAX_STAGES, (SMEM_LIMIT - 1024 - fixed) // stage)
    most = b * chunks if split else _ceil(b * chunks, 2)
    assign_kt = _ceil(k, w) if wide else 1  # the logits' cluster tiles
    most *= assign_kt
    n_kt, n_ct = _ceil(k, AGG_CLUSTERS), d // D_TILE
    combos = n_kt * n_ct
    per_combo = max(1, min(sms // combos, b))
    if f32:
        # Both halves of the assignment's rows, then the frames' tile; no
        # centers in shared memory; the warps' sums of squares [8][256].
        agg_stage = (2 * AGG_CLUSTERS * F32_DEPTH * 4
                     + F32_AGG_FRAMES * D_TILE * 4)
        agg_stages, centers_bytes = F32_AGG_STAGES, 0
        agg_fixed = 8 * AGG_CLUSTERS * 4 + 2 * F32_AGG_STAGES * 8
    else:
        agg_stage = (AGG_CLUSTERS // BOX + D_TILE // BOX) * AGG_FRAMES * BOX * 2
        agg_stages, centers_bytes = AGG_STAGES, AGG_CLUSTERS * D_TILE * 4
        agg_fixed = centers_bytes + (2 * AGG_STAGES + 1) * 8
    return {
        "chunks": chunks, "clusters_a_warpgroup": w, "split": split,
        "wide": wide, "assign_cluster_tiles": assign_kt,
        "logits_floats": b * f * k if wide else 0,
        "softmax_grid": min(b * chunks, 65535) if wide else 0,
        "items_a_tile": 1 if split else 2,
        "k_steps": d // (F32_DEPTH if f32 else DEPTH),
        "assign_grid": min(most, sms), "assign_stage_bytes": stage,
        "assign_stages": stages, "x_load_bytes": x_load,
        "x_bytes": x_bytes, "x_tiles": x_tiles,
        "assign_smem": stages * stage + fixed + 1024,
        "box_x": ((32, FRAME_CHUNK, 1) if f32_x
                  else ((F32_DEPTH if f32 else DEPTH), FRAME_CHUNK, 1)),
        "x_elem_bytes": 4 if f32_x else 1, "x_swizzled": f32_x,
        "box_w": (F32_DEPTH, w, 1) if f32 else (BOX, DEPTH),
        "w_boxes": w_boxes,
        "box_xb": (BOX, AGG_FRAMES, 1), "box_assign": (BOX, AGG_FRAMES, 1),
        "agg_frames": F32_AGG_FRAMES if f32 else AGG_FRAMES,
        "agg_cluster_tiles": n_kt, "agg_col_tiles": n_ct,
        "agg_combos": combos, "agg_per_combo": per_combo,
        "agg_tiles": b * combos, "agg_grid": per_combo * combos,
        "agg_stage_bytes": agg_stage, "agg_stages": agg_stages,
        "box_centers": (32, AGG_CLUSTERS, 1), "centers_bytes": centers_bytes,
        "agg_smem": agg_stages * agg_stage + agg_fixed + 1024,
        "assign_pitch": -(-f // 4) * 4,
        "items": 1 + b * chunks, "work": b * (n_ct + 2) * k + b,
    }


def agg_walk(blk: int, p: dict, b: int):
    """The aggregation tiles block blk walks: it keeps combination blk %
    C of (cluster tile, column tile), the column tile fastest, whose
    centers stay in its shared memory, and takes the videos blk // C,
    + P, ... (P blocks a combination). [(video, clusters, columns)] as
    ranges before clipping to K and D."""
    combos, per = p["agg_combos"], p["agg_per_combo"]
    kt, ct = divmod(blk % combos, p["agg_col_tiles"])
    return [(v, range(kt * AGG_CLUSTERS, (kt + 1) * AGG_CLUSTERS),
             range(ct * D_TILE, (ct + 1) * D_TILE))
            for v in range(blk // combos, b, per)]


def live_items(num_frames, f: int):
    """nv_serve_scan's list: b * ceil(F/64) + c for every chunk c of video
    b that holds a live frame (c < ceil(min(num_frames[b], F) / 64)),
    videos in order; int64 on num_frames' device."""
    chunks = _ceil(f, FRAME_CHUNK)
    n = torch.clamp(num_frames.to(torch.int64), 0, f)
    per = (n + FRAME_CHUNK - 1) // FRAME_CHUNK
    c = torch.arange(chunks, device=num_frames.device)
    live = c[None, :] < per[:, None]
    ids = torch.arange(num_frames.shape[0], device=num_frames.device)
    return (ids[:, None] * chunks + c[None, :])[live]


def kernel_plan() -> dict:
    """The compiled launches' tiles and the card's SMs (card only)."""
    import ctypes

    out = (ctypes.c_int * 21)()
    _build.check_launch("yt8m_netvlad_plan",
                        _build.library().yt8m_netvlad_plan(out))
    return dict(zip(("chunk", "assign_stages", "smem_f32_128",
                     "smem_f32_256", "smem_f32_split", "smem_u8_128",
                     "smem_u8_256", "smem_u8_split", "agg_clusters",
                     "agg_cols", "agg_stages", "agg_smem", "sms",
                     "f32_assign_stages", "f32_smem_f32_128",
                     "f32_smem_f32_256", "f32_smem_u8_128",
                     "f32_smem_u8_256", "f32_clusters",
                     "f32_agg_frames", "f32_agg_smem"), out))


def netvlad_assign_plain(frames, num_frames, cluster_w, act_scale,
                         act_bias):
    """(x, assign): the frames rounded to cluster_w.dtype and widened to
    f32 [B, F, D], and the masked f32 softmax assignment [B, F, K] (exact
    products summed in f32)."""
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x * DEQUANT_SCALE + DEQUANT_BIAS
    x = x.to(cluster_w.dtype).to(torch.float32)
    product = torch.matmul(x, cluster_w.to(torch.float32))
    return x, netvlad_softmax_plain(product, num_frames, act_scale, act_bias)


def netvlad_softmax_plain(product, num_frames, act_scale, act_bias):
    """The masked f32 softmax assignment [B, F, K] from the frames'
    cluster product [B, F, K] (before the per-cluster affine)."""
    act = product * act_scale + act_bias
    act = act - torch.amax(act, dim=-1, keepdim=True)
    e = torch.exp(act)
    assign = e / torch.sum(e, dim=-1, keepdim=True)
    t = torch.arange(product.shape[1], device=product.device)[None, :]
    live = t < num_frames.to(torch.int64)[:, None]
    return torch.where(live[:, :, None], assign, torch.zeros_like(assign))


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
                      centers, w_split=None):
    """Normalised VLAD descriptors [B, K, D] f32.

    frames [B, F, D] uint8 or float32; num_frames [B] (int32 on the
    card); cluster_w [D, K] in the compute dtype (bf16 or float32: the
    route on the card);
    act_scale, act_bias [K] f32 (the folded BN, or ones and the cluster
    biases); centers [K, D] f32. w_split: the f32 route's operand on the
    card, `tf32.split_weights(cluster_w)` (a serving constant); the plain
    version ignores it.
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
    if cluster_w.dtype == torch.float32:
        return _launch_f32(frames, num_frames, cluster_w, act_scale, act_bias,
                           centers, w_split)
    x, w, scale, bias, cen = pad_operands(frames, cluster_w, act_scale,
                                          act_bias, centers)
    out = _launch(x, num_frames, w, scale, bias, cen, torch.empty)[0]
    return out if out.shape[1:] == (k, d) else out[:, :k, :d].contiguous()


def netvlad_aggregate_with_scratch(frames, num_frames, cluster_w, act_scale,
                                   act_bias, centers):
    """Launch the CUDA kernel; (out, xb, assign, colsum): the descriptors
    [B, K, D] f32 and the kernel's intermediates, the bf16 frames
    [B, F, D], the bf16 assignment [B, F, K] (zeros past num_frames) and
    the f32 column sums of each 64-frame chunk [B, ceil(F/64), K]. The
    kernel writes these on the live chunks only; here they start as
    zeros, so every row it skips reads as 0 (the main path allocates them
    uninitialised)."""
    return _launch(frames, num_frames, cluster_w, act_scale, act_bias,
                   centers, torch.zeros)


def _launch(frames, num_frames, cluster_w, act_scale, act_bias, centers,
            alloc):
    b, f, d = frames.shape
    k = cluster_w.shape[1]
    require(frames.dtype in (torch.uint8, torch.float32),
            f"frames: dtype {frames.dtype}, want uint8 or float32")
    require(cluster_w.dtype == torch.bfloat16,
            "the CUDA kernel computes in bf16; cluster_w must be bfloat16")
    require(f >= 1, "F must be at least 1")
    require(d % D_TILE == 0, f"D={d} must be a multiple of {D_TILE}")
    require(k % 8 == 0 and k >= 8, f"K={k} must be a multiple of 8, >= 8")
    require_cuda_operand("frames", frames, frames.dtype, (b, f, d))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("cluster_w", cluster_w, torch.bfloat16, (d, k))
    require_cuda_operand("act_scale", act_scale, torch.float32, (k,))
    require_cuda_operand("act_bias", act_bias, torch.float32, (k,))
    require_cuda_operand("centers", centers, torch.float32, (k, d))
    dev = frames.device
    p = plan(b, f, d, k, frames.dtype)
    out = torch.empty((b, k, d), dtype=torch.float32, device=dev)
    xb = alloc((b, f, d), dtype=torch.bfloat16, device=dev)
    assign = alloc((b, f, k), dtype=torch.bfloat16, device=dev)
    colsum = alloc((b, p["chunks"], k), dtype=torch.float32, device=dev)
    items = torch.empty(p["items"], dtype=torch.int32, device=dev)
    work = torch.empty(p["work"], dtype=torch.float32, device=dev)
    logits = (torch.empty(p["logits_floats"], dtype=torch.float32, device=dev)
              if p["wide"] else None)
    lib = _build.library()
    fn = (lib.yt8m_netvlad_aggregate_u8 if frames.dtype == torch.uint8
          else lib.yt8m_netvlad_aggregate_f32)
    code = fn(
        _build.ptr(frames), _build.ptr(num_frames), _build.ptr(cluster_w),
        _build.ptr(act_scale), _build.ptr(act_bias), _build.ptr(centers),
        _build.ptr(xb), _build.ptr(assign), _build.ptr(colsum),
        _build.ptr(items), _build.ptr(work),
        _build.ptr(logits) if logits is not None else None,
        _build.ptr(out), b, f, d, k, _build.current_stream(dev),
    )
    _build.check_launch("netvlad_aggregate", code)
    netvlad_aggregate.launches += 1
    return out, xb, assign, colsum


def _launch_f32(frames, num_frames, cluster_w, act_scale, act_bias,
                centers, w_split):
    """The f32 route: csrc/netvlad.cu's 3xTF32 launches over the live
    chunks on Wc's split copy, D and K padded as the bf16 route pads
    them."""
    b, f, d = frames.shape
    k = cluster_w.shape[1]
    require(frames.dtype in (torch.uint8, torch.float32),
            f"frames: dtype {frames.dtype}, want uint8 or float32")
    require(f >= 1, "F must be at least 1")
    require(k >= 1, f"K={k} must be at least 1")
    tf32.check_split("netvlad_aggregate", w_split, d, k)
    require_cuda_operand("frames", frames, frames.dtype, (b, f, d))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("cluster_w", cluster_w, torch.float32, (d, k))
    require_cuda_operand("act_scale", act_scale, torch.float32, (k,))
    require_cuda_operand("act_bias", act_bias, torch.float32, (k,))
    require_cuda_operand("centers", centers, torch.float32, (k, d))
    x, _, scale, bias, cen = pad_operands(frames, cluster_w, act_scale,
                                          act_bias, centers)
    dp, kp = x.shape[2], scale.shape[0]
    dev = frames.device
    p = plan(b, f, dp, kp, x.dtype, f32=True)
    out = torch.empty((b, kp, dp), dtype=torch.float32, device=dev)
    # The assignment's TF32 halves, cluster-major (launch 1 writes the live
    # chunks' frames; launch 2 reads them in rows of 32 frames).
    assign = torch.empty((2, b, kp, p["assign_pitch"]), dtype=torch.float32,
                         device=dev)
    colsum = torch.empty((b, p["chunks"], kp), dtype=torch.float32,
                         device=dev)
    items = torch.empty(p["items"], dtype=torch.int32, device=dev)
    work = torch.empty(p["work"], dtype=torch.float32, device=dev)
    logits = (torch.empty(p["logits_floats"], dtype=torch.float32, device=dev)
              if p["wide"] else None)
    lib = _build.library()
    fn = (lib.yt8m_netvlad_aggregate_f32w_u8 if x.dtype == torch.uint8
          else lib.yt8m_netvlad_aggregate_f32w_f32)
    code = fn(
        _build.ptr(x), _build.ptr(num_frames), _build.ptr(w_split),
        _build.ptr(scale), _build.ptr(bias), _build.ptr(cen),
        _build.ptr(assign), _build.ptr(colsum), _build.ptr(items),
        _build.ptr(work), _build.ptr(logits) if logits is not None else None,
        _build.ptr(out), b, f, dp, kp, k, w_split.shape[2],
        _build.current_stream(dev),
    )
    _build.check_launch("netvlad_aggregate", code)
    netvlad_aggregate.launches += 1
    netvlad_aggregate.launches_f32 += 1
    return out if (kp, dp) == (k, d) else out[:, :k, :d].contiguous()


netvlad_aggregate.launches = 0
netvlad_aggregate.launches_f32 = 0  # the f32 route's, counted in both
