"""Masked attention pooling for the serving path.

Replaces yt8m_tpu/kernels/attention_pool.py :: attention_pool. Per
video, with x the frames (uint8 dequantized as u * 4/255 + (4/512 - 2),
float32 as they are):

    scores = round(x) @ round(Q)                 [F, H]  (f32 sums)
    scores = -1e9 where t >= num_frames
    attn   = softmax over t of scores            (f32)
    pooled = round(attn)^T @ round(x)            [H, D]  (f32 sums)

`round` is the cast to bf16. A video with num_frames = 0 takes the mean
over its F rows (every score -1e9, a uniform softmax), as the JAX
package's attention_pool_reference and its model's graph do; its TPU
kernel pads F to a multiple of 8 and averages the padded rows as well.

The CUDA kernel (csrc/attention_pool.cu) is bound by the bytes of the
frames: a block a video, two passes over its live frames (the scores
and the softmax, then the pooling). `attention_pool.launches` counts its
launches. D that is no multiple of 4 is padded with zero columns of Q
(the scores do not change; the padded output columns are dropped). H
is padded to 1, 2, 4, 8 or 16 heads with zero columns of Q, and more
than 16 heads run 16 at a time: heads are independent.
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

MAX_HEADS = 16  # heads a launch; H is padded to a power of two up to it
SMEM_LIMIT = 232448


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def attention_pool_plain(frames, num_frames, query):
    """Plain PyTorch version with the kernel's rounding points (those of
    the JAX package's attention_pool_reference): [B, H, D] f32."""
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = dequantize(x)
    xb = _bf(x)
    scores = torch.matmul(xb, _bf(query))  # [B, F, H]
    f = frames.shape[1]
    live = (torch.arange(f, device=frames.device)[None, :]
            < num_frames.to(torch.int64)[:, None])
    scores = torch.where(live[:, :, None], scores, -1e9)
    attn = torch.softmax(scores, dim=1)
    return torch.matmul(_bf(attn).transpose(1, 2), xb)


def _heads_padded(h: int) -> int:
    p = 1
    while p < h:
        p *= 2
    return p


def attention_pool(frames, num_frames, query):
    """[B, H, D] f32: the CUDA kernel for CUDA tensors (frames uint8 or
    float32 [B, F, D], num_frames int32 [B], query [D, H] float), the
    plain version for CPU tensors."""
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
    if d % 4:
        frames = torch.nn.functional.pad(frames, (0, 4 - d % 4))
        query = torch.nn.functional.pad(query, (0, 0, 0, 4 - d % 4))
        return attention_pool(frames, num_frames, query)[..., :d].contiguous()
    if h > MAX_HEADS:
        return torch.cat([attention_pool(frames, num_frames, q) for q in
                          torch.split(query, MAX_HEADS, dim=1)], dim=1)
    hp = _heads_padded(h)
    q = torch.nn.functional.pad(query, (0, hp - h)).to(
        torch.bfloat16).contiguous()
    require(f >= 1, "F must be at least 1")
    require((hp * d + f * hp) * 4 <= SMEM_LIMIT,
            f"F={f} and D={d} do not fit the kernel's shared memory")
    require_cuda_operand("frames", frames, frames.dtype, (b, f, d))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    out = torch.empty((b, hp, d), dtype=torch.float32, device=frames.device)
    entry = (_build.library().yt8m_attention_pool_u8
             if frames.dtype == torch.uint8
             else _build.library().yt8m_attention_pool_f32)
    code = entry(_build.ptr(frames), _build.ptr(num_frames), _build.ptr(q),
                 _build.ptr(out), b, f, d, hp,
                 _build.current_stream(frames.device))
    _build.check_launch("attention_pool", code)
    attention_pool.launches += 1
    return out[:, :h] if hp != h else out


attention_pool.launches = 0


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
