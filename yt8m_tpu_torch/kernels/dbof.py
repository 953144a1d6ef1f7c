"""Fused DBoF cluster + max-pool for the serving path.

Replaces the four DBoF kernels of yt8m_tpu/kernels/dbof.py. For sampled
frames x [B, S, D] (uint8, or float32):

    xa   = round_to(x * in_scale + in_bias, w.dtype)   (affine in f32)
    act  = xa @ w                                      (f32 accumulate)
    out  = max_s relu(act * act_scale + act_bias)      [B, K] f32

  * `dbof_cluster_maxpool_v2` (DbofModel's serving path): `w` already in
    the compute dtype, which selects the route on the card. At bf16 the
    CUDA kernel (csrc/dbof.cu)
    is bound by the bf16 tensor-core rate at the serving shapes; it never
    writes the [B*S, K] activations to device memory. It applies the
    input affine once, into a [B*S, D] bf16 buffer this wrapper
    allocates, then runs the product (TMA + wgmma, csrc/hopper_gemm.cuh)
    with the BN, ReLU and max over frames in its epilogue: 4 videos at a
    pitch of 32 rows x 256 clusters a tile, the rows past S read as
    zeros and masked out of the max (`plan`; the source has the design).
    The model folds dequantization and both BatchNorms into the two
    affines, and casts `w` to bf16 once. At f32 (--compute_dtype=float32)
    nothing is rounded to bf16, as in the TPU kernel at dtype=float32:
    the affine in f32 split into two TF32 halves (one launch, into a [2,
    B*S, D] buffer this wrapper allocates), then the same product launch
    on the TF32 tensor cores as a 3xTF32 product (kernels/tf32.py: three
    products of the halves summed in f32, about 2^-21 of each product
    from the f32 one; the tensor core sums one 32-deep stage, the stages
    add up on the FMA units) with the same pooling epilogue (`plan(...,
    f32=True)`). It reads W's split copy, [2, K, D] K-major
    (`tf32.split_weights`), which DbofModel builds once with its serving
    constants and passes as `w_split`.
  * `dbof_cluster_maxpool` (the TPU package's v1, which has no dtype: it
    computes in bf16 whatever the model's): the same function
    with an f32 `w` rounded to bf16 on every call (csrc/dbof.cu's
    yt8m_round_bf16 launch), as the TPU kernel does in its body. The
    TPU's two versions differ only in grid order and VMEM scratch, so on
    the card both run csrc/dbof.cu's two launches.
  * `dbof_sampled_cluster_maxpool`: the sampling gather fused in. It
    takes the full frames [B, F, D] uint8 and the sampled indices [B, S]
    (S <= 32); csrc/dbof.cu's gathering affine launch reads row idx[b, s]
    of video b, and a zero frame for an index outside [0, F) (the TPU
    kernel's one-hot select gives zero there), then the same product.
  * `dbof_cluster_maxpool_int8` (--dbof_int8_serving): raw uint8 frames
    against per-column int8 weights. `int8_serving_constants` folds the
    input affine into the weights,
        (x * s_in + b_in) @ W = (x - 128) @ (s_in . W) + 128 colsum + b_in @ W,
    and quantizes W' = s_in . W per column, symmetrically, to int8 (the
    only approximation). csrc/dbof_int8.cu multiplies the raw bytes by w8
    on the int8 tensor cores (wgmma u8 x s8, exact int32 sums) and takes
    128 * colsum(w8), which the wrapper sums, off once per (video,
    cluster); its epilogue pools the integer sums first (a max, or a min
    where a_col < 0: the affine and the ReLU are monotone) and applies
    f32(acc) * a_col + b_col and the ReLU to the pooled value only
    (`plan_int8`; the source has the design).

The kernels pool at most 32 frames a video; more are pooled in chunks of
32 frames, one launch each, whose outputs the wrapper reduces with an
elementwise max (a max of maxes is exact).
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels import tf32
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

MAX_FRAMES_PER_VIDEO = 32  # S one launch takes (a video's pitch of rows)

# csrc/dbof.cu's product tile (yt8m_dbof_plan reads the kernel's own).
TILE_VIDEOS = 4      # videos a tile: 128 rows at a pitch of 32
TILE_CLUSTERS = 256  # K clusters a tile: one m64n256k16 chain a warpgroup
DEPTH = 64           # D a ring stage (64 bf16, the 128-byte swizzle's row)
BOX_COLS = 64        # clusters of a W box
STAGES = 4
SMS = 132            # an H100's SMs: the persistent grid's cap
# The f32 route's ring: 32-deep stages (32 f32, the 128-byte swizzle's
# row) of both TF32 halves of the A tile and of W's 256 K-major rows.
F32_DEPTH = 32
F32_STAGES = 2
F32_GROUP = 8        # cluster tiles a group of the f32 walk (W's L2 share)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(b: int, s: int, d: int, k: int, sms: int = SMS,
         f32: bool = False) -> dict:
    """csrc/dbof.cu's product launch over xa [B, S <= 32, D] and W [D, K]
    (f32: their TF32 halves, [2, B, S, D] and W's K-major [2, K, D]): the
    tiles and their walk (`walk`), the persistent grid, the TMA boxes
    (innermost first), the wgmma chain and the shared memory."""
    row_tiles = _ceil(b, TILE_VIDEOS)
    cluster_tiles = _ceil(k, TILE_CLUSTERS)
    tiles = row_tiles * cluster_tiles
    rows = TILE_VIDEOS * MAX_FRAMES_PER_VIDEO
    if f32:
        depth, stages, group = F32_DEPTH, F32_STAGES, F32_GROUP
        w_boxes = 2
        stage = 2 * (rows + TILE_CLUSTERS) * F32_DEPTH * 4
        box_x = (F32_DEPTH, MAX_FRAMES_PER_VIDEO, TILE_VIDEOS, 1)
        box_w = (F32_DEPTH, TILE_CLUSTERS, 1)
    else:
        depth, stages, group = DEPTH, STAGES, cluster_tiles
        w_boxes = _ceil(TILE_CLUSTERS, BOX_COLS)
        stage = rows * DEPTH * 2 + w_boxes * DEPTH * BOX_COLS * 2
        box_x = (DEPTH, MAX_FRAMES_PER_VIDEO, TILE_VIDEOS)
        box_w = (BOX_COLS, DEPTH)
    return {
        "row_tiles": row_tiles, "cluster_tiles": cluster_tiles,
        "tiles": tiles, "grid": min(tiles, sms), "k_steps": _ceil(d, depth),
        "group": group,
        "rows": rows, "padded_rows": rows - TILE_VIDEOS * s,
        "box_x": box_x, "box_w": box_w, "chain": TILE_CLUSTERS,
        "w_boxes": w_boxes, "stages": stages, "stage_bytes": stage,
        "smem": stages * stage + 2 * TILE_VIDEOS * TILE_CLUSTERS * 4
        + 2 * stages * 8 + 1024,
    }


def walk(t: int, p: dict) -> tuple:
    """Tile t's (video tile, cluster tile) in the kernel's walk: groups of
    p["group"] cluster tiles, each group's video tiles in order, the
    cluster tile fastest within a group (csrc/dbof.cu :: tile_coords)."""
    n_ct, n_rt, group = p["cluster_tiles"], p["row_tiles"], p["group"]
    if group >= n_ct:  # one group
        return divmod(t, n_ct)
    g, rest = divmod(t, group * n_rt)
    width = min(group, n_ct - g * group)
    rt, c = divmod(rest, width)
    return rt, g * group + c


# csrc/dbof_int8.cu's product tile (yt8m_dbof_int8_plan reads the
# kernel's own): 4 videos x 256 clusters as DBoF v2's, 128 bytes of depth
# a stage (four k32 steps of the integer wgmma).
INT8_DEPTH = 128


def plan_int8(b: int, d: int, k: int, sms: int = SMS) -> dict:
    """csrc/dbof_int8.cu's launch over x [B, S <= 32, D] uint8 and w8t
    [K, D] int8: the tiles (the K tile fastest), the persistent grid, the
    TMA boxes (innermost first, both K-major: 128-byte rows), the stages
    and the shared memory."""
    row_tiles = _ceil(b, TILE_VIDEOS)
    cluster_tiles = _ceil(k, TILE_CLUSTERS)
    tiles = row_tiles * cluster_tiles
    rows = TILE_VIDEOS * MAX_FRAMES_PER_VIDEO
    stage = rows * INT8_DEPTH + TILE_CLUSTERS * INT8_DEPTH
    return {
        "row_tiles": row_tiles, "cluster_tiles": cluster_tiles,
        "tiles": tiles, "grid": min(tiles, sms), "group": cluster_tiles,
        "k_steps": _ceil(d, INT8_DEPTH), "rows": rows,
        "box_x": (INT8_DEPTH, MAX_FRAMES_PER_VIDEO, TILE_VIDEOS),
        "box_w": (INT8_DEPTH, TILE_CLUSTERS), "chain": TILE_CLUSTERS,
        "stages": STAGES, "stage_bytes": stage,
        "a_bytes": rows * INT8_DEPTH,
        "smem": STAGES * stage + 2 * TILE_VIDEOS * TILE_CLUSTERS * 4
        + 2 * STAGES * 8 + 1024,
    }


def kernel_plan_int8() -> dict:
    """The compiled int8 product's tile and the card's SMs (card only)."""
    import ctypes

    out = (ctypes.c_int * 7)()
    _build.check_launch("yt8m_dbof_int8_plan",
                        _build.library().yt8m_dbof_int8_plan(out))
    return dict(zip(("videos", "pitch", "tile_clusters", "depth", "stages",
                     "smem", "sms"), out))


def tile_of(t: int, p: dict):
    """Tile t of a plan: (videos, K clusters) as ranges before clipping
    to B and K."""
    rt, ct = walk(t, p)
    return (range(rt * TILE_VIDEOS, (rt + 1) * TILE_VIDEOS),
            range(ct * TILE_CLUSTERS, (ct + 1) * TILE_CLUSTERS))


def kernel_plan() -> dict:
    """The compiled product's tile and the card's SMs, and the f32
    route's ring and walk (card only)."""
    import ctypes

    out = (ctypes.c_int * 9)()
    _build.check_launch("yt8m_dbof_plan",
                        _build.library().yt8m_dbof_plan(out))
    return dict(zip(("videos", "pitch", "tile_clusters", "stages", "smem",
                     "sms", "f32_stages", "f32_smem", "f32_group"), out))


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


def dbof_cluster_maxpool_v1_plain(x, w, in_scale, in_bias, act_scale,
                                  act_bias):
    """Plain version of v1: `w` rounded to bf16, then as v2's."""
    return dbof_cluster_maxpool_plain(x, w.to(torch.bfloat16), in_scale,
                                      in_bias, act_scale, act_bias)


def sampled_frames_plain(x, idx):
    """x [B, F, D] and idx [B, S] -> x[b, idx[b, s]], a zero frame where
    the index is outside [0, F)."""
    f = x.shape[1]
    idx = idx.to(torch.int64)
    ok = (idx >= 0) & (idx < f)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    xs = x[rows, idx.clamp(0, f - 1)]
    return torch.where(ok[:, :, None], xs, torch.zeros_like(xs))


def dbof_sampled_cluster_maxpool_plain(x, idx, w, in_scale, in_bias,
                                       act_scale, act_bias):
    return dbof_cluster_maxpool_v1_plain(sampled_frames_plain(x, idx), w,
                                         in_scale, in_bias, act_scale,
                                         act_bias)


def int8_serving_constants(w, in_scale, in_bias, act_scale, act_bias):
    """(w8 [D, K] int8, a_col [K] f32, b_col [K] f32) of the int8 path,
    in the TPU wrapper's formulas and order (yt8m_tpu/kernels/dbof.py ::
    dbof_cluster_maxpool_int8): `w` is the f32 cluster kernel, the
    affines f32 with dequantization folded into the input one."""
    w = w.to(torch.float32)
    w_prime = in_scale.to(torch.float32)[:, None] * w
    gamma = torch.clamp_min(torch.amax(torch.abs(w_prime), dim=0),
                            1e-12) / 127.0
    w8 = torch.clamp(torch.round(w_prime / gamma[None, :]), -127, 127)
    colsum = torch.sum(w8, dim=0)  # exact: |sum| <= 127 D < 2^24
    c = torch.matmul(in_bias.to(torch.float32), w)
    a_col = gamma * act_scale
    b_col = (128.0 * colsum * gamma + c) * act_scale + act_bias
    # Stored cluster-major (w8.t() contiguous), the layout the kernel reads.
    return (w8.to(torch.int8).t().contiguous().t(), a_col.contiguous(),
            b_col.contiguous())


def dbof_cluster_maxpool_int8_plain(x, w8, a_col, b_col):
    """Plain version with the kernel's arithmetic: the exact integer
    product of (x - 128) and w8 (float64 is exact below 2^53; float32
    would round sums above 2^24 in its own order), one conversion to
    f32, then f32(acc) * a_col + b_col, ReLU and max over frames."""
    xi = x.to(torch.float64) - 128.0
    acc = torch.matmul(xi, w8.to(torch.float64)).to(torch.float32)
    return torch.amax(torch.relu(acc * a_col + b_col), dim=1)


def dbof_cluster_maxpool_v2(x, w, in_scale, in_bias, act_scale, act_bias,
                            w_split=None):
    """relu-activated cluster activations max-pooled over S: [B, K] f32.

    x [B, S, D] uint8 or float32; w [D, K] in the compute dtype (bf16 or
    float32: the route on the card); the affines are f32 vectors of D and
    K. `w_split`: on the card's f32 route, tf32.split_weights(w), made
    once per weight version; the CPU and the bf16 route ignore it.
    """
    _check_shapes(x, w)
    if on_cpu(x, w, in_scale, in_bias, act_scale, act_bias):
        return dbof_cluster_maxpool_plain(
            x, w, in_scale, in_bias, act_scale, act_bias
        )
    if w.dtype == torch.float32:
        tf32.check_split("w_split", w_split, *w.shape)
        w = w_split
    return _pooled_in_chunks(dbof_cluster_maxpool_v2, x, w, in_scale,
                             in_bias, act_scale, act_bias)


def dbof_cluster_maxpool(x, w, in_scale, in_bias, act_scale, act_bias):
    """The TPU package's v1: as v2, with an f32 `w` rounded to bf16 on
    every call."""
    _check_shapes(x, w)
    if on_cpu(x, w, in_scale, in_bias, act_scale, act_bias):
        return dbof_cluster_maxpool_v1_plain(
            x, w, in_scale, in_bias, act_scale, act_bias
        )
    return _pooled_in_chunks(dbof_cluster_maxpool, x, _bf16_on_card(w),
                             in_scale, in_bias, act_scale, act_bias)


def dbof_sampled_cluster_maxpool(x, idx, w, in_scale, in_bias, act_scale,
                                 act_bias):
    """Fused frame-sample gather + cluster + max-pool: [B, K] f32.

    x [B, F, D] uint8, the full frames; idx [B, S] the sampled frame
    indices, S <= 32, an index outside [0, F) selecting a zero frame;
    w [D, K] f32 (or bf16), rounded to bf16.
    """
    require(x.dim() == 3, f"x must be [B, F, D], got {tuple(x.shape)}")
    if x.dtype != torch.uint8:
        raise ValueError("dbof_sampled_cluster_maxpool requires uint8 x")
    b, f, d = x.shape
    require(idx.dim() == 2 and idx.shape[0] == b,
            f"idx must be [{b}, S], got {tuple(idx.shape)}")
    s = idx.shape[1]
    if s > MAX_FRAMES_PER_VIDEO:
        raise ValueError(
            f"num samples {s} > scratch rows {MAX_FRAMES_PER_VIDEO}")
    require(w.dim() == 2 and w.shape[0] == d,
            f"w must be [{d}, K], got {tuple(w.shape)}")
    k = w.shape[1]
    if on_cpu(x, idx, w, in_scale, in_bias, act_scale, act_bias):
        return dbof_sampled_cluster_maxpool_plain(
            x, idx, w, in_scale, in_bias, act_scale, act_bias)
    require(s >= 1 and f >= 1, "S and F must be at least 1")
    w = _bf16_on_card(w)
    idx = idx.to(torch.int32).contiguous()
    _check_operands(x, w, in_scale, in_bias, act_scale, act_bias)
    out = torch.empty((b, k), dtype=torch.float32, device=x.device)
    xa = torch.empty((b * s, d), dtype=torch.bfloat16, device=x.device)
    code = _build.library().yt8m_dbof_sampled_cluster_maxpool(
        _build.ptr(x), _build.ptr(idx), _build.ptr(in_scale),
        _build.ptr(in_bias), _build.ptr(w), _build.ptr(act_scale),
        _build.ptr(act_bias), _build.ptr(xa), _build.ptr(out), b, f, s, d,
        k, _build.current_stream(x.device),
    )
    _build.check_launch("dbof_sampled_cluster_maxpool", code)
    dbof_sampled_cluster_maxpool.launches += 1
    return out


def dbof_cluster_maxpool_int8(x, w8, a_col, b_col):
    """--dbof_int8_serving: [B, K] f32 from raw uint8 frames x [B, S, D]
    and the constants of `int8_serving_constants` (w8 [D, K] int8, a_col
    and b_col [K] f32)."""
    if x.dtype != torch.uint8:
        raise ValueError("int8 serving path requires uint8 features")
    _check_shapes(x, w8)
    if on_cpu(x, w8, a_col, b_col):
        return dbof_cluster_maxpool_int8_plain(x, w8, a_col, b_col)
    b, s, d = x.shape
    k = w8.shape[1]
    require(s >= 1, "S must be at least 1")
    require(d % 16 == 0, f"D={d} must be a multiple of 16")
    # The kernel reads w8 cluster-major: no copy for the layout that
    # int8_serving_constants returns.
    w8t = w8.t().contiguous()
    require_cuda_operand("x", x, torch.uint8, (b, s, d))
    require_cuda_operand("w8t", w8t, torch.int8, (k, d))
    require_cuda_operand("a_col", a_col, torch.float32, (k,))
    require_cuda_operand("b_col", b_col, torch.float32, (k,))
    # The kernel multiplies the raw bytes: x @ w8 = (x - 128) @ w8 + 128
    # colsum8, exact in int32.
    colsum8 = torch.sum(w8t, dim=1, dtype=torch.int32)
    return max_over_frame_chunks(_launch_int8, x, w8t, colsum8, a_col,
                                 b_col)


def max_over_frame_chunks(launch, x, *args):
    """launch(x[:, s0:s0 + 32], *args) for each chunk of 32 frames,
    reduced with an elementwise max."""
    out = None
    for s0 in range(0, x.shape[1], MAX_FRAMES_PER_VIDEO):
        part = launch(x[:, s0:s0 + MAX_FRAMES_PER_VIDEO].contiguous(), *args)
        out = part if out is None else torch.maximum(out, part)
    return out


def _check_shapes(x, w):
    require(x.dim() == 3, f"x must be [B, S, D], got {tuple(x.shape)}")
    d = x.shape[2]
    require(w.dim() == 2 and w.shape[0] == d,
            f"w must be [{d}, K], got {tuple(w.shape)}")


def _bf16_on_card(w):
    """w [D, K] as bf16: an f32 `w` rounded by csrc/dbof.cu's
    yt8m_round_bf16 launch (the TPU kernels round W in their body)."""
    if w.dtype == torch.bfloat16:
        return w.contiguous()
    d, k = w.shape
    w = w.contiguous()
    require_cuda_operand("w", w, torch.float32, (d, k))
    w16 = torch.empty((d, k), dtype=torch.bfloat16, device=w.device)
    code = _build.library().yt8m_round_bf16(
        _build.ptr(w), _build.ptr(w16), d, k, k,
        _build.current_stream(w.device))
    _build.check_launch("yt8m_round_bf16", code)
    return w16


def _check_operands(x, w, in_scale, in_bias, act_scale, act_bias):
    """The card's operands; `w` is [D, K] bf16 or, on the f32 route, W's
    split copy [2, K, D] f32."""
    split = w.dim() == 3
    d, k = (w.shape[2], w.shape[1]) if split else w.shape
    require(x.dtype in (torch.uint8, torch.float32),
            f"x: dtype {x.dtype}, want uint8 or float32")
    require(w.dtype == (torch.float32 if split else torch.bfloat16),
            f"w: dtype {w.dtype}; the CUDA kernels compute in bfloat16 or "
            "float32")
    require(d % 32 == 0, f"D={d} must be a multiple of 32")
    require(k % 8 == 0, f"K={k} must be a multiple of 8")
    require_cuda_operand("x", x, x.dtype, tuple(x.shape))
    if not split:
        require_cuda_operand("w", w, w.dtype, (d, k))
    for name, t, n in (("in_scale", in_scale, d), ("in_bias", in_bias, d),
                       ("act_scale", act_scale, k),
                       ("act_bias", act_bias, k)):
        require_cuda_operand(name, t, torch.float32, (n,))


def _pooled_in_chunks(owner, x, w, in_scale, in_bias, act_scale, act_bias):
    """csrc/dbof.cu over x in chunks of 32 frames, max of the chunks'
    outputs; each launch counts on `owner`."""
    require(x.shape[1] >= 1, "S must be at least 1")
    _check_operands(x, w, in_scale, in_bias, act_scale, act_bias)
    return max_over_frame_chunks(
        lambda xs, *a: _launch(owner, xs, *a), x, w, in_scale, in_bias,
        act_scale, act_bias)


def _launch(owner, x, w, in_scale, in_bias, act_scale, act_bias):
    """One launch of csrc/dbof.cu over x [B, S <= 32, D]: the affine into a
    work buffer, then the product; bf16 (w [D, K] bf16, the buffer bf16
    [B*S, D]) or, for W's split copy [2, K, D], the 3xTF32 route (the
    buffer the affine's two halves, [2, B*S, D] f32)."""
    b, s, d = x.shape
    f32 = w.dtype == torch.float32
    k = w.shape[1]  # [D, K] bf16 or [2, K, D] split
    out = torch.empty((b, k), dtype=torch.float32, device=x.device)
    lib = _build.library()
    u8 = x.dtype == torch.uint8
    if f32:
        fn = (lib.yt8m_dbof_cluster_maxpool_f32w_u8 if u8
              else lib.yt8m_dbof_cluster_maxpool_f32w_f32)
        work = torch.empty((2, b * s, d), dtype=torch.float32,
                           device=x.device)
    else:
        fn = (lib.yt8m_dbof_cluster_maxpool_u8 if u8
              else lib.yt8m_dbof_cluster_maxpool_f32)
        work = torch.empty((b * s, d), dtype=torch.bfloat16, device=x.device)
    code = fn(_build.ptr(x), _build.ptr(in_scale), _build.ptr(in_bias),
              _build.ptr(w), _build.ptr(act_scale), _build.ptr(act_bias),
              _build.ptr(work), _build.ptr(out), b, s, d, k,
              _build.current_stream(x.device))
    _build.check_launch(owner.__name__, code)
    owner.launches += 1
    if f32:
        owner.launches_f32 += 1
    return out


def _launch_int8(x, w8t, colsum8, a_col, b_col):
    """One launch of csrc/dbof_int8.cu over x [B, S <= 32, D]."""
    b, s, d = x.shape
    k = w8t.shape[0]
    out = torch.empty((b, k), dtype=torch.float32, device=x.device)
    code = _build.library().yt8m_dbof_cluster_maxpool_int8(
        _build.ptr(x), _build.ptr(w8t), _build.ptr(colsum8),
        _build.ptr(a_col), _build.ptr(b_col), _build.ptr(out), b, s, d, k,
        _build.current_stream(x.device),
    )
    _build.check_launch("dbof_cluster_maxpool_int8", code)
    dbof_cluster_maxpool_int8.launches += 1
    return out


for _fn in (dbof_cluster_maxpool_v2, dbof_cluster_maxpool,
            dbof_sampled_cluster_maxpool, dbof_cluster_maxpool_int8):
    _fn.launches = 0
# The f32 route's launches (--compute_dtype=float32), counted in
# `launches` too.
dbof_cluster_maxpool_v2.launches_f32 = 0
