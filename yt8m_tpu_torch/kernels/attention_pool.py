"""Masked attention pooling for the serving path.

Replaces yt8m_tpu/kernels/attention_pool.py :: attention_pool. Per
video, with x the frames (uint8 dequantized as u * 4/255 + (4/512 - 2),
float32 as they are):

    scores = round(x) @ round(Q)                 [F, H]  (f32 sums)
    scores = -1e9 where t >= num_frames
    attn   = softmax over t of scores            (f32)
    pooled = round(attn)^T @ round(x)            [H, D]  (f32 sums)

`round` is the cast to the compute dtype, Q's dtype (an f32 Q selects
the f32 route, any other is rounded to bf16). A video with num_frames =
0 takes the mean over its F rows (every score -1e9, a uniform softmax), as the JAX
package's attention_pool_reference and its model's graph do; its TPU
kernel pads F to a multiple of 8 and averages the padded rows as well.

At f32 (--compute_dtype=float32) nothing is rounded, as in the TPU
kernel at dtype=float32: the same kernel's f32 instance (the same grid,
ring and walk) runs both products on the TF32 tensor cores as 3xTF32
(mma.sync; each operand split into two TF32 halves, kernels/tf32.py) and
the softmax in f32, eight heads a launch, with the same padding of D and
the same split of heads past 16 a call.

The bf16 CUDA kernel (csrc/attention_pool.cu) is bound by the bytes of the
frames. A persistent grid (a block an SM) takes videos from a counter in
device memory; a producer thread streams a video's live rows into a ring
of 16-frame stages (a TMA load a stage, the 128-byte swizzle); pass 1
(the scores, a warp a tile) and pass 2 (the pooling, every warp its
columns of every tile) run on the tensor cores (mma.sync m16n8k16, bf16
in, f32 sums), the softmax between them in shared memory. The last tiles
of pass 1 stay in the ring for pass 2, which reads the rest again from L2
(`plan`, `video_loads`, `pass2_order`). `attention_pool.launches` counts
the launches. D that is no multiple of 128 bytes and 64 columns
(`padded_columns`) is padded with zero columns of Q (the scores do not
change; the padded output columns are dropped); up to 16 heads run in one
launch (8 a tile of the products), more than 16 heads 16 at a time: heads
are independent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yt8m_tpu_torch.data.quantize import dequantize
from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

MAX_HEADS = 16  # heads a launch (two n8 tiles of the products)
SMEM_LIMIT = 232448

# csrc/attention_pool.cu's block (yt8m_attention_pool_plan reads the
# kernel's own).
ROWS = 16          # frames a stage: pass 1's M, pass 2's K
WARPS = 12         # consumer warps; one producer warp more
CHUNK = 64         # columns a pass-1 step
LINE = 128         # bytes a swizzled line: D * esize is padded to a multiple
GROUP = 32         # columns a pass-2 group (two m16 tiles)
MAX_GROUPS = 6     # groups a consumer warp pools
MAX_STAGES = WARPS  # a stage's pass-1 tiles go to one warp
BARRIER_BYTES = 24 * MAX_STAGES
ALIGN = 1024       # the 128-byte swizzle's atom: the stages' alignment
SMS = 132          # an H100's SMs: the persistent grid's cap


def compute_dtype(query):
    """The route's compute dtype: float32 for an f32 query, else bf16."""
    return torch.float32 if query.dtype == torch.float32 else torch.bfloat16


def _round(t, dtype):
    return t.to(dtype).to(torch.float32)


def attention_pool_plain(frames, num_frames, query):
    """Plain PyTorch version with the kernel's rounding points (those of
    the JAX package's attention_pool_reference at the compute dtype,
    `compute_dtype(query)`): [B, H, D] f32."""
    dtype = compute_dtype(query)
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = dequantize(x)
    xb = _round(x, dtype)
    scores = torch.matmul(xb, _round(query, dtype))  # [B, F, H]
    f = frames.shape[1]
    live = (torch.arange(f, device=frames.device)[None, :]
            < num_frames.to(torch.int64)[:, None])
    scores = torch.where(live[:, :, None], scores, -1e9)
    attn = torch.softmax(scores, dim=1)
    return torch.matmul(_round(attn, dtype).transpose(1, 2), xb)


def _heads_padded(h: int, f32: bool = False) -> int:
    """The heads a launch computes for h <= 16: whole n8 tiles of the
    products (the heads past h get zero columns of Q); the f32 route
    computes 8 a launch."""
    return 8 if h <= 8 or f32 else 16


def padded_columns(d: int, x_dtype=torch.uint8) -> int:
    """D as the kernel takes it: a multiple of 64 columns and of 128
    bytes."""
    unit = LINE if x_dtype == torch.uint8 else CHUNK
    return -(-d // unit) * unit


def plan(f: int, d: int, h: int, x_dtype=torch.uint8, b: int = 1,
         sms: int = SMS, f32: bool = False) -> dict:
    """csrc/attention_pool.cu's launch over frames [B, F, D] (D as
    padded_columns gives it) and H <= 16 heads: the stages (16 rows of an
    odd number of 128-byte swizzled lines, the TMA box), Q in fragment
    order, the scores, the attention (bf16; f32: its two f32 halves) and
    the barriers in shared memory, and the block's walk. f32: the f32
    route's launches, 8 heads each (Q f32, 32 bytes a column and head
    tile)."""
    esize = 1 if x_dtype == torch.uint8 else 4
    heads = _heads_padded(h, f32)
    nt = heads // 8
    lines = (d * esize // LINE) | 1
    stage = ROWS * lines * LINE
    f16 = -(-f // 16) * 16
    if f32:
        attn_pitch = f16 + (4 - f16 % 32) % 32
        q_bytes, attn_bytes = 32 * d * nt, 8 * heads * attn_pitch
    else:
        attn_pitch = f16 + (8 - f16 % 64) % 64
        q_bytes, attn_bytes = 16 * d * nt, 2 * heads * attn_pitch
    fixed = q_bytes + 4 * heads * f16 + attn_bytes + 8 + BARRIER_BYTES
    stages = min(MAX_STAGES, (SMEM_LIMIT - ALIGN - fixed) // stage)
    q_off = stages * stage
    attn_off = q_off + q_bytes + 4 * heads * f16
    bar_off = -(-(attn_off + attn_bytes) // 8) * 8
    return {
        "rows": ROWS, "lines": lines, "stage_bytes": stage, "f16": f16,
        "attn_pitch": attn_pitch, "q_bytes": q_bytes,
        "scores_bytes": 4 * heads * f16, "attn_bytes": attn_bytes,
        "box": (LINE // esize, lines, ROWS, 1), "stages": stages,
        "q_off": q_off, "bar_off": bar_off,
        "smem": bar_off + BARRIER_BYTES + ALIGN, "n_tiles": nt,
        "launches": -(-h // 8) if f32 else 1,
        "warps": WARPS, "threads": 32 * (WARPS + 1),
        "groups_a_warp": -(-(d // GROUP) // WARPS),
        "grid": min(b, sms), "resident_frames": ROWS * stages,
    }


def video_loads(n: int, f: int, stages: int):
    """The producer's loads for one video with num_frames n: [(pass,
    tile)] in order, pass 1's tiles and then the tiles pass 2 does not
    find in the ring (the first ones). n <= 0 skips pass 1 and pools all
    F rows."""
    rows = f if n <= 0 else min(n, f)
    tiles = -(-rows // ROWS)
    p1 = tiles if n > 0 else 0
    kept = min(tiles, stages) if n > 0 else 0
    return ([(1, t) for t in range(p1)]
            + [(2, t) for t in range(tiles - kept)])


def pass2_order(n: int, f: int, stages: int):
    """Pass 2's tiles in the order the consumers pool them, each with the
    index of its load among video_loads': the kept tiles of pass 1 (the
    last ones, still in their stages) first, then the reloaded ones."""
    rows = f if n <= 0 else min(n, f)
    tiles = -(-rows // ROWS)
    p1 = tiles if n > 0 else 0
    kept = min(tiles, stages) if n > 0 else 0
    return ([(t, t) for t in range(tiles - kept, tiles)]
            + [(t, p1 + t) for t in range(tiles - kept)])


def kernel_plan(f: int, d: int, h: int, x_dtype=torch.uint8,
                f32: bool = False) -> dict:
    """The compiled kernel's layout for frames [*, F, D] and H heads (f32:
    the f32 route's), and the card's SMs (card only)."""
    import ctypes

    out = (ctypes.c_int * 12)()
    esize = 1 if x_dtype == torch.uint8 else 4
    _build.check_launch("yt8m_attention_pool_plan",
                        _build.library().yt8m_attention_pool_plan(
                            f, d, h, esize, int(f32), out))
    return dict(zip(("rows", "lines", "stage_bytes", "stages", "smem",
                     "f16", "attn_pitch", "warps", "max_groups",
                     "max_stages", "n_tiles", "sms"), out))


_counters = {}


def _counter(device):
    """Two zeros in device memory for the kernel's video counter, one
    pair a (device, stream): each launch leaves them at zero."""
    stream = torch.cuda.current_stream(device)
    key = (device, stream.cuda_stream)
    if key not in _counters:
        _counters[key] = torch.zeros(2, dtype=torch.int32, device=device)
    return _counters[key]


def attention_pool(frames, num_frames, query):
    """[B, H, D] f32: the CUDA kernel for CUDA tensors (frames uint8 or
    float32 [B, F, D], num_frames int32 [B], query [D, H] float: f32 for
    the f32 route, bf16 (or another dtype, rounded to bf16) for the bf16
    one), the plain version for CPU tensors."""
    require(frames.dim() == 3, f"frames must be [B, F, D], got "
            f"{tuple(frames.shape)}")
    b, f, d = frames.shape
    require(query.dim() == 2 and query.shape[0] == d,
            f"query must be [{d}, H], got {tuple(query.shape)}")
    h = query.shape[1]
    if on_cpu(frames, num_frames, query):
        return attention_pool_plain(frames, num_frames, query)
    require(frames.dtype in (torch.uint8, torch.float32),
            f"frames: dtype {frames.dtype}, want uint8 or float32")
    if padded_columns(d, frames.dtype) != d:
        pad = padded_columns(d, frames.dtype) - d
        frames = torch.nn.functional.pad(frames, (0, pad))
        query = torch.nn.functional.pad(query, (0, 0, 0, pad))
        return attention_pool(frames, num_frames, query)[..., :d].contiguous()
    if h > MAX_HEADS:
        return torch.cat([attention_pool(frames, num_frames, q) for q in
                          torch.split(query, MAX_HEADS, dim=1)], dim=1)
    f32 = query.dtype == torch.float32
    q = query if f32 or query.dtype == torch.bfloat16 else query.to(
        torch.bfloat16)
    q = q.contiguous()
    require(f >= 1, "F must be at least 1")
    p = plan(f, d, h, frames.dtype, f32=f32)
    require(p["stages"] >= 2 and p["groups_a_warp"] <= MAX_GROUPS,
            f"F={f} and D={d} do not fit the kernel's shared memory and "
            f"registers")
    require_cuda_operand("frames", frames, frames.dtype, (b, f, d))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    out = torch.empty((b, h, d), dtype=torch.float32, device=frames.device)
    lib = _build.library()
    u8 = frames.dtype == torch.uint8
    if f32:
        entry = (lib.yt8m_attention_pool_f32q_u8 if u8
                 else lib.yt8m_attention_pool_f32q_f32)
    else:
        entry = (lib.yt8m_attention_pool_u8 if u8
                 else lib.yt8m_attention_pool_f32)
    code = entry(_build.ptr(frames), _build.ptr(num_frames), _build.ptr(q),
                 _build.ptr(out), _build.ptr(_counter(frames.device)), b, f,
                 d, h, _build.current_stream(frames.device))
    _build.check_launch("attention_pool", code)
    attention_pool.launches += 1
    if f32:
        attention_pool.launches_f32 += 1
    return out


attention_pool.launches = 0
attention_pool.launches_f32 = 0  # the f32 route's, counted in both


class RoundingLimit(NamedTuple):
    """What rounding_limit reads from one draw."""
    limit: torch.Tensor  # [B, H, D] the limit of |kernel - plain|
    explained: bool      # (a): the kernel's weights explain its output
    explain_err: float   # max|plain product with those weights - kernel|
    flips: int           # weights one bf16 step from the plain version's
    away: int            # weights that differ away from a boundary: (b) fails
    unresolved: int      # weights below the solve's resolution
    near: int            # plain weights within 2^-14 of a boundary
    weights: int         # positive weights of the frames read
    worst: float         # the largest flip's distance from its boundary


def rounding_limit(frames, num_frames, query, got, want) -> RoundingLimit:
    """The limit of |kernel - plain| that the bf16 rounding of the
    attention weights explains, for one draw, from the kernel's output
    `got` and the plain version's `want` on the same inputs.

    The kernel's own bf16 weights are recovered from its output (a
    video's pooled rows are w^T x over its frames: a least-squares solve
    in f64 over the frames it reads, rounded back to bf16) and held to
    two facts: (a) the plain product with the kernel's weights gives the
    kernel's output within the f32 sums' bound, 2 (n - 1) 2^-24 sum_t
    |w_t x_t| over a video's n frames; (b) a weight differs from the
    plain version's bf16(attn) only where the plain f32 attn lies within
    2^-14 of its size of a bf16 rounding boundary, and then by one bf16
    step (the two compute attn in f32 in different orders). Weights the
    solve cannot resolve from the plain output either (16 times its
    recovery error there) are counted apart. From (a) and (b), the limit
    per element: one bf16 step times |x| summed over the weights at a
    boundary, plus both sums' bound. A weight in [0.5, 1) one step apart
    moves the output 2^-9 |x|, above a fixed 1e-3 max|ref|."""

    def bf(t):
        return t.to(torch.bfloat16).to(torch.float32)

    def step(t, k):  # the bf16 value k steps from t (t > 0)
        return (t.to(torch.bfloat16).view(torch.int16) + k).view(
            torch.bfloat16).to(torch.float32)

    x, nf = frames, num_frames
    f = x.shape[1]
    xb = x.to(torch.float32)
    xb = bf(dequantize(xb) if x.dtype == torch.uint8 else xb)
    live = torch.arange(f, device=x.device)[None, :] < nf[:, None]
    scores = torch.where(live[..., None], torch.matmul(xb, bf(query)), -1e9)
    attn = torch.softmax(scores, dim=1)  # the plain version's f32 weights
    plain_w = bf(attn)
    read = live | (nf <= 0)[:, None]  # the frames the kernel reads
    xm = torch.where(read[..., None], xb, 0.0)
    a64 = xm.double()
    gram = a64 @ a64.transpose(1, 2) + torch.diag_embed((~read).double())

    def recover(out):
        return torch.linalg.solve(gram, a64 @ out.double().transpose(1, 2))

    w = recover(got)
    noise = 16 * (recover(want) - plain_w.double()).abs().amax(
        dim=(1, 2), keepdim=True)
    del a64, gram
    kern_w = torch.where(read[..., None], bf(w.float()), 0.0)
    rows = read.sum(1).to(torch.float32)[:, None, None]
    # (a) the kernel's weights explain its output
    sums = 2 * (rows - 1).clamp(min=0) * 2.0 ** -24
    mine = torch.matmul(kern_w.transpose(1, 2), xm)
    a_err = (mine - got).abs()
    a_lim = sums * torch.matmul(kern_w.abs().transpose(1, 2), xm.abs())
    # (b) the weights differ only at rounding boundaries, by one step
    pos = read[..., None] & (attn > 0)
    up, down = step(plain_w, 1), step(plain_w, -1)
    to_up = (attn.double() - (plain_w.double() + up.double()) / 2).abs()
    to_down = (attn.double() - (plain_w.double() + down.double()) / 2).abs()
    near = pos & (torch.minimum(to_up, to_down) <= 2.0 ** -14 * attn.double())
    differ = kern_w != plain_w
    unresolved = differ & ((w - plain_w.double()).abs() <= noise)
    flips = differ & ~unresolved
    one_step = (kern_w == up) | (kern_w == down)
    away = flips & ~(one_step & near)
    across = torch.where(to_up < to_down, up, down)
    steps = torch.where(near, (across - plain_w).abs(), 0.0)
    limit = (torch.matmul(steps.transpose(1, 2), xm.abs())
             + sums * torch.matmul(plain_w.abs().transpose(1, 2), xm.abs())
             + a_lim)
    worst = ((torch.minimum(to_up, to_down) / attn.double())[flips].max()
             .item() if bool(flips.any()) else 0.0)
    return RoundingLimit(limit, bool(torch.all(a_err <= a_lim)),
                         a_err.max().item(), int(flips.sum()),
                         int(away.sum()), int(unresolved.sum()),
                         int(near.sum()), int(pos.sum()), worst)
