"""LSTM recurrence for the serving path.

Replaces yt8m_tpu/kernels/lstm.py :: lstm_recurrence. Given the input
projection x_proj = X @ W_x [F, B, 4H] (time-major, computed outside),
every step t computes, in TF gate order i, j, f, o with forget bias 1:

    z      = round(h) @ round(W_h) + round(x_proj[t]) + bias     (f32)
    c'     = c * sigmoid(f + 1) + sigmoid(i) * tanh(j)
    h'     = tanh(c') * sigmoid(o)
    (c, h) = (c', h') where num_frames > orig_t, else unchanged
    out[t] = round(h)

`round` is the cast to bf16; orig_t = F-1-t when `reverse` (x_proj comes
already flipped in time and the outputs keep that order, as in the JAX
package). The CUDA kernel (csrc/lstm.cu) is bound by the bf16
tensor-core rate; it is one persistent launch a call
(csrc/recurrence_persist.cuh: W_h resident in shared memory, a barrier
between steps, only the live rows of each step multiplied, by the
schedule of kernels/_schedule.py), and `lstm_recurrence.launches`
counts those launches. H that is no multiple of 64 is padded with units whose W_h columns and rows,
x_proj columns and bias are zero: such a unit keeps c = 0 and h = 0
(z = 0 gives c' = c * sigmoid(1) + sigmoid(0) * tanh(0)), so the real
units see nothing of it.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._schedule import (
    BARRIER_WORDS,
    launch_plan,
    live_schedule,
)
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

H_MULTIPLE = 64  # the units the CUDA kernels take a multiple of


def pad_units(hp: int, x_proj, wh, bias):
    """(x_proj, wh, bias) with hp units: every gate block padded with
    zero columns, and W_h with zero rows."""
    hd = wh.shape[0]

    def gates(t):
        t = t.reshape(*t.shape[:-1], 4, hd)
        t = torch.nn.functional.pad(t, (0, hp - hd))
        return t.reshape(*t.shape[:-2], 4 * hp).contiguous()

    wh = torch.nn.functional.pad(gates(wh), (0, 0, 0, hp - hd))
    return gates(x_proj), wh.contiguous(), gates(bias)


def lstm_cell(z, c, hd: int):
    """The cell on pre-activations z [B, 4H] (f32, TF order i, j, f, o):
    (gates (sigmoid i, tanh j, sigmoid(f + 1), sigmoid o), c', h')."""
    zi, zj, zf, zo = torch.split(z, hd, dim=-1)
    si, tj = torch.sigmoid(zi), torch.tanh(zj)
    sf, so = torch.sigmoid(zf + 1.0), torch.sigmoid(zo)
    c1 = c * sf + si * tj
    return (si, tj, sf, so), c1, torch.tanh(c1) * so


def lstm_recurrence_plain(x_proj, num_frames, wh, bias, reverse=False):
    """Plain PyTorch version with the kernel's rounding points: h, W_h and
    x_proj rounded to bf16, exact products summed in f32."""
    f, b, g = x_proj.shape
    hd = g // 4
    w = wh.to(torch.bfloat16).to(torch.float32)
    xs = x_proj.to(torch.bfloat16).to(torch.float32)
    nf = num_frames.to(torch.int64)[:, None]
    h = torch.zeros((b, hd), dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    outs = []
    for t in range(f):
        z = torch.matmul(h.to(torch.bfloat16).to(torch.float32), w) + xs[t]
        _, c1, h1 = lstm_cell(z + bias, c, hd)
        live = nf > ((f - 1 - t) if reverse else t)
        c = torch.where(live, c1, c)
        h = torch.where(live, h1, h)
        outs.append(h.to(torch.bfloat16))
    return torch.stack(outs).to(torch.float32), (c, h)


def lstm_recurrence(x_proj, num_frames, wh, bias, reverse=False):
    """(outputs [F, B, H] f32 (bf16 values), (final_c, final_h) [B, H]
    f32).

    x_proj [F, B, 4H] (bf16 on the card); num_frames [B] (int32 on the
    card); wh [H, 4H] (bf16 on the card); bias [4H] f32.
    """
    require(x_proj.dim() == 3 and x_proj.shape[2] % 4 == 0,
            f"x_proj must be [F, B, 4H], got {tuple(x_proj.shape)}")
    f, b, g = x_proj.shape
    hd = g // 4
    require(tuple(wh.shape) == (hd, g),
            f"wh must be [{hd}, {g}], got {tuple(wh.shape)}")
    if on_cpu(x_proj, num_frames, wh, bias):
        return lstm_recurrence_plain(x_proj, num_frames, wh, bias, reverse)
    if hd % H_MULTIPLE:
        hp = -(-hd // H_MULTIPLE) * H_MULTIPLE
        xp, whp, bp = pad_units(hp, x_proj, wh, bias)
        out, (c, h) = lstm_recurrence(xp, num_frames, whp, bp, reverse)
        return out[..., :hd].contiguous(), (c[:, :hd], h[:, :hd])
    out, c, h = _launch(x_proj, num_frames, wh, bias, reverse)
    lstm_recurrence.launches += 1
    return out.to(torch.float32), (c, h)


def _launch(x_proj, num_frames, wh, bias, reverse, skip_work=False,
            residuals=False):
    """The C call on CUDA tensors with H a multiple of 64: (out [F, B, H]
    bf16, c, h [B, H] f32) and, with `residuals` (the trainable forward,
    the same kernel's Residuals instance), also (gates [F, B, 4H], cs
    [F, B, H]) bf16. skip_work runs the kernel's schedule and barriers
    alone (their share of a call, for measurement)."""
    f, b, g = x_proj.shape
    hd = g // 4
    require(f >= 1, "F must be at least 1")
    require_cuda_operand("x_proj", x_proj, torch.bfloat16, (f, b, g))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("wh", wh, torch.bfloat16, (hd, g))
    require_cuda_operand("bias", bias, torch.float32, (g,))
    dev = x_proj.device
    order, live = live_schedule(num_frames, f, reverse)
    h0 = torch.zeros((b, hd), dtype=torch.bfloat16, device=dev)
    c = torch.zeros((b, hd), dtype=torch.float32, device=dev)
    h = torch.zeros((b, hd), dtype=torch.float32, device=dev)
    out = torch.empty((f, b, hd), dtype=torch.bfloat16, device=dev)
    barrier = torch.zeros(BARRIER_WORDS, dtype=torch.int32, device=dev)
    lib = _build.library()
    head = [x_proj, num_frames, order, live, wh, bias, h0, c, h, out]
    if residuals:
        gates = torch.empty((f, b, g), dtype=torch.bfloat16, device=dev)
        cs = torch.empty((f, b, hd), dtype=torch.bfloat16, device=dev)
        fn, name, ts = (lib.yt8m_lstm_train_forward, "lstm_train_forward",
                        head + [gates, cs, barrier])
    else:
        fn, name, ts = lib.yt8m_lstm_recurrence, "lstm_recurrence", head + [
            barrier]
    code = fn(*(_build.ptr(t) for t in ts), f, b, hd, int(bool(reverse)),
              int(skip_work), _build.current_stream(dev))
    _build.check_launch(name, code)
    return (out, c, h, gates, cs) if residuals else (out, c, h)


def barriers_only(x_proj, num_frames, wh, bias, reverse=False,
                  residuals=False):
    """The kernel (the serving instance, or with `residuals` the
    trainable forward's) with its products and cell updates skipped: its
    schedule and F - 1 barriers alone (not counted in `launches`)."""
    _launch(x_proj, num_frames, wh, bias, reverse, skip_work=True,
            residuals=residuals)


def plan(b: int, hd: int) -> dict:
    """The kernel's launch plan at B rows and H units (H a multiple of
    64): see kernels/_schedule.py :: launch_plan."""
    return launch_plan(_build.library().yt8m_lstm_plan, b, hd)


lstm_recurrence.launches = 0
