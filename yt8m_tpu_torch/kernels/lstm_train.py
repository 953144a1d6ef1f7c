"""Trainable LSTM recurrence: a CUDA forward that streams residuals and a
reverse-time CUDA backward that emits dZ, as a torch.autograd.Function.

Replaces yt8m_tpu/kernels/lstm_train.py :: lstm_recurrence_trainable, a
custom VJP over two pallas_calls (the forward at :119, the backward at
:272), with its contract: the recurrence of kernels/lstm.py, gradients
for x_proj, W_h and the bias (num_frames is integer data).

Forward (csrc/lstm.cu, the serving kernel's Residuals instance): the
serving recurrence, which also writes the post-activation gates
(sigmoid i, tanh j, sigmoid(f + 1), sigmoid o) as bf16 [F, B, 4H] and
the cell sequence bf16(c_t) [F, B, H]; the outputs are bf16(h_t). The
kernel computes live rows only: at a row's frozen steps its gates are 0
and c_t is the frozen carry (the plain version computes gates there
too; nothing reads them, every use is masked).

Backward (csrc/lstm_train.cu), t = F-1 first, with the dh and dc carries
in f32, emitting only dZ, bf16 [F, B, 4H]:

    dh   = dh_carry + bf16(dout_t)          dc = dc_carry
    do   = dh * tanh(c_t) * o (1 - o)
    dc  += dh * o * (1 - tanh(c_t)^2)
    di   = dc * j * i (1 - i);  dj = dc * i (1 - j^2);  df = dc * c_{t-1} * f (1 - f)
    dZ_t = bf16([di, dj, df, do]) where live, else 0
    dh_carry = dZ_t @ W_h^T where live, else dh;  dc_carry = dc * f where live, else dc

with c_{-1} = 0 and live = num_frames > orig_t (orig_t = F-1-t under
`reverse`). Outside the kernel, as the JAX package does: dW_h = H_prev^T
dZ as one bf16 product with f32 output, db = sum dZ in f32, dx_proj =
dZ.

Both directions are one persistent launch a call
(csrc/recurrence_persist.cuh: the weights resident in shared memory, a
barrier between steps, live rows only, by the schedule of
kernels/_schedule.py); lstm_train_backward_by_schedule is the backward's
decomposition in plain PyTorch. `lstm_train_forward.launches` and
`lstm_train_backward.launches` count the launches. H that is no
multiple of 64 is padded as kernels/lstm.py pads it; a padded unit's dZ
is 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels import lstm as _lstm
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)
from yt8m_tpu_torch.kernels._schedule import (
    BARRIER_WORDS,
    launch_plan,
    live_schedule,
    product_rows,
)
from yt8m_tpu_torch.kernels.lstm import H_MULTIPLE, lstm_cell, pad_units


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _bptt(dh, dc, gates_t, c_t, c_p, hd: int):
    """One step of the backward on f32 values: (dZ_t before the mask and
    the rounding, dc before the forget gate, sigmoid f)."""
    si, tj, sf, so = torch.split(gates_t, hd, dim=-1)
    tc = torch.tanh(c_t)
    d_o = dh * tc * so * (1.0 - so)
    dcf = dc + dh * so * (1.0 - tc * tc)
    d_i = dcf * tj * si * (1.0 - si)
    d_j = dcf * si * (1.0 - tj * tj)
    d_f = dcf * c_p * sf * (1.0 - sf)
    return torch.cat([d_i, d_j, d_f, d_o], -1), dcf, sf


def _live(nf, f: int, t: int, reverse: bool):
    return nf > ((f - 1 - t) if reverse else t)


def lstm_train_forward_plain(x_proj, num_frames, wh, bias, reverse=False):
    """Plain PyTorch forward with the kernel's rounding points: (outs
    [F, B, H], gates [F, B, 4H], cs [F, B, H], all bf16; final c, h [B, H]
    f32)."""
    f, b, g = x_proj.shape
    hd = g // 4
    w = _bf(wh)
    xs = _bf(x_proj)
    nf = num_frames.to(torch.int64)[:, None]
    h = torch.zeros((b, hd), dtype=torch.float32, device=x_proj.device)
    c = torch.zeros_like(h)
    outs, gates, cs = [], [], []
    for t in range(f):
        z = torch.matmul(_bf(h), w) + xs[t]
        g, c1, h1 = lstm_cell(z + bias, c, hd)
        live = _live(nf, f, t, reverse)
        c = torch.where(live, c1, c)
        h = torch.where(live, h1, h)
        outs.append(h.to(torch.bfloat16))
        gates.append(torch.cat(g, -1).to(torch.bfloat16))
        cs.append(c.to(torch.bfloat16))
    return (torch.stack(outs), torch.stack(gates), torch.stack(cs), c, h)


def lstm_train_backward_plain(douts, dfc, dfh, gates, cs, num_frames, wh,
                              reverse=False):
    """Plain PyTorch backward with the kernel's rounding points: dZ
    [F, B, 4H] bf16 from the cotangents of the outputs (rounded to bf16)
    and of the final c and h, and the forward's bf16 residuals."""
    f, b, g = gates.shape
    hd = g // 4
    wt = _bf(wh).t()
    dout = _bf(douts)
    nf = num_frames.to(torch.int64)[:, None]
    dh_c = dfh.to(torch.float32)
    dc_c = dfc.to(torch.float32)
    dz_all = [None] * f
    for t in range(f - 1, -1, -1):
        dh = dh_c + dout[t]
        c_t = cs[t].to(torch.float32)
        c_p = (cs[t - 1].to(torch.float32) if t > 0
               else torch.zeros_like(c_t))
        dz, dcf, sf = _bptt(dh, dc_c, gates[t].to(torch.float32), c_t, c_p,
                            hd)
        live = _live(nf, f, t, reverse)
        dz = torch.where(live, dz, 0.0).to(torch.bfloat16)
        dh_c = torch.where(live, torch.matmul(dz.to(torch.float32), wt), dh)
        dc_c = torch.where(live, dcf * sf, dc_c)
        dz_all[t] = dz
    return torch.stack(dz_all)


def lstm_train_backward_by_schedule(douts, dfc, dfh, gates, cs, num_frames,
                                    wh, reverse=False):
    """lstm_train_backward_plain as the CUDA backward decomposes it, in
    plain PyTorch: the rows in the live-row order; step t computes only
    the prefix of rows live at t, and multiplies only its first
    product_rows[t] (live at t+1 too); a row's frozen steps emit dZ = 0
    and, forward, add their bf16(dout_t) to its dh carry one at a time,
    t = F-1 down, before the row turns live. dZ [F, B, 4H] bf16."""
    f, b, g = gates.shape
    hd = g // 4
    order, live = live_schedule(num_frames, f, reverse)
    prod = product_rows(live).tolist()
    order, live = order.long(), live.tolist()
    wt = _bf(wh).t()
    dout = _bf(douts)
    nf = num_frames.to(torch.int64)[:, None]
    dh = dfh.to(torch.float32).clone()
    dc = dfc.to(torch.float32).clone()
    dz = torch.zeros((f, b, g), dtype=torch.bfloat16, device=gates.device)
    if not reverse:  # the frozen steps come first in the backward
        for t in range(f - 1, -1, -1):
            dh = torch.where(nf <= t, dh + dout[t], dh)
    for t in range(f - 1, -1, -1):
        rows = order[:live[t]]
        dh_t = dh[rows]
        if prod[t]:
            dh_t[:prod[t]] = torch.matmul(
                dz[t + 1, rows[:prod[t]]].to(torch.float32), wt)
        dh_t = dh_t + dout[t, rows]
        c_t = cs[t, rows].to(torch.float32)
        c_p = (cs[t - 1, rows].to(torch.float32) if t > 0
               else torch.zeros_like(c_t))
        d, dcf, sf = _bptt(dh_t, dc[rows], gates[t, rows].to(torch.float32),
                           c_t, c_p, hd)
        dz[t, rows] = d.to(torch.bfloat16)
        dh[rows] = dh_t
        dc[rows] = dcf * sf
    return dz


def lstm_train_forward(x_proj, num_frames, wh, bias, reverse=False):
    """(outs, gates, cs, c, h) as lstm_train_forward_plain: the CUDA
    forward for CUDA tensors (x_proj, wh bf16, num_frames int32, bias
    f32, H a multiple of 64), the plain version for CPU tensors."""
    require(x_proj.dim() == 3 and x_proj.shape[2] % 4 == 0,
            f"x_proj must be [F, B, 4H], got {tuple(x_proj.shape)}")
    f, b, g = x_proj.shape
    hd = g // 4
    require(tuple(wh.shape) == (hd, g),
            f"wh must be [{hd}, {g}], got {tuple(wh.shape)}")
    if on_cpu(x_proj, num_frames, wh, bias):
        return lstm_train_forward_plain(x_proj, num_frames, wh, bias, reverse)
    require(hd % H_MULTIPLE == 0, f"H={hd} must be a multiple of "
            f"{H_MULTIPLE} (lstm_recurrence_trainable pads it)")
    require(f >= 1, "F must be at least 1")
    out, c, h, gates, cs = _lstm._launch(x_proj, num_frames, wh, bias,
                                         reverse, residuals=True)
    lstm_train_forward.launches += 1
    return out, gates, cs, c, h


def lstm_train_backward(douts, dfc, dfh, gates, cs, num_frames, wh,
                        reverse=False):
    """dZ [F, B, 4H] bf16 as lstm_train_backward_plain: the CUDA backward
    for CUDA tensors (douts rounded to bf16 here), the plain version for
    CPU tensors."""
    require(gates.dim() == 3 and gates.shape[2] % 4 == 0,
            f"gates must be [F, B, 4H], got {tuple(gates.shape)}")
    f, b, g = gates.shape
    hd = g // 4
    if on_cpu(douts, dfc, dfh, gates, cs, num_frames, wh):
        return lstm_train_backward_plain(douts, dfc, dfh, gates, cs,
                                         num_frames, wh, reverse)
    require(hd % H_MULTIPLE == 0, f"H={hd} must be a multiple of "
            f"{H_MULTIPLE} (lstm_recurrence_trainable pads it)")
    dz = _backward(douts, dfc, dfh, gates, cs, num_frames, wh, reverse)
    lstm_train_backward.launches += 1
    return dz


def _backward(douts, dfc, dfh, gates, cs, num_frames, wh, reverse,
              skip_work=False):
    """The C call of the CUDA backward on CUDA tensors: dZ [F, B, 4H]
    bf16. skip_work runs the kernel's schedule and barriers alone."""
    f, b, g = gates.shape
    hd = g // 4
    dout = douts.to(torch.bfloat16).contiguous()
    require_cuda_operand("douts", dout, torch.bfloat16, (f, b, hd))
    require_cuda_operand("gates", gates, torch.bfloat16, (f, b, g))
    require_cuda_operand("cs", cs, torch.bfloat16, (f, b, hd))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("wh", wh, torch.bfloat16, (hd, g))
    dev = gates.device
    # The carries, seeded with the final state's cotangents.
    dh = dfh.to(torch.float32).contiguous().clone()
    dc = dfc.to(torch.float32).contiguous().clone()
    require_cuda_operand("dfh", dh, torch.float32, (b, hd))
    require_cuda_operand("dfc", dc, torch.float32, (b, hd))
    order, live = live_schedule(num_frames, f, reverse)
    dz = torch.empty((f, b, g), dtype=torch.bfloat16, device=dev)
    barrier = torch.zeros(BARRIER_WORDS, dtype=torch.int32, device=dev)
    code = _build.library().yt8m_lstm_train_backward(
        *(_build.ptr(t) for t in (dout, gates, cs, num_frames, order, live,
                                  wh, dh, dc, dz, barrier)),
        f, b, hd, int(bool(reverse)), int(skip_work),
        _build.current_stream(dev),
    )
    _build.check_launch("lstm_train_backward", code)
    return dz


def barriers_only_forward(x_proj, num_frames, wh, bias, reverse=False):
    """The forward with its products and cell updates skipped: its
    schedule and F - 1 barriers alone (not counted in `launches`)."""
    _lstm.barriers_only(x_proj, num_frames, wh, bias, reverse,
                        residuals=True)


def barriers_only_backward(douts, dfc, dfh, gates, cs, num_frames, wh,
                           reverse=False):
    """The backward with its products and cell updates skipped: its
    schedule and F - 1 barriers alone (not counted in `launches`)."""
    _backward(douts, dfc, dfh, gates, cs, num_frames, wh, reverse,
              skip_work=True)


def plan(b: int, hd: int) -> dict:
    """The backward's launch plan at B rows and H units (H a multiple of
    64), its ring included: see kernels/_schedule.py :: launch_plan. The
    forward's is kernels/lstm.py :: plan."""
    return launch_plan(_build.library().yt8m_lstm_train_plan, b, hd,
                       backward=True)


lstm_train_forward.launches = 0
lstm_train_backward.launches = 0


def weight_grads(outs, dz):
    """(dW_h [H, 4H], db [4H]) in f32 from the bf16 outputs (h_{t-1} =
    outs[t-1], 0 at t = 0) and dZ: one bf16 product with f32 output and
    an f32 sum."""
    hd, g = outs.shape[2], dz.shape[2]
    a = outs[:-1].reshape(-1, hd).t()
    z = dz[1:].reshape(-1, g)
    if dz.is_cuda:
        dwh = torch.mm(a, z, out_dtype=torch.float32)
    else:
        dwh = torch.mm(a.to(torch.float32), z.to(torch.float32))
    return dwh, torch.sum(dz, dim=(0, 1), dtype=torch.float32)


def _unpad(t, hd: int):
    """[..., 4 * hp] -> [..., 4 * hd]: the first hd units of each gate."""
    hp = t.shape[-1] // 4
    return t.reshape(*t.shape[:-1], 4, hp)[..., :hd].reshape(
        *t.shape[:-1], 4 * hd)


class LstmRecurrenceTrainable(torch.autograd.Function):
    """(outs [F, B, H] f32 holding bf16 values, c, h [B, H] f32); the
    gradients of x_proj (dZ), wh (dW_h, f32) and bias (db)."""

    @staticmethod
    def forward(ctx, x_proj, num_frames, wh, bias, reverse):
        hd = wh.shape[0]
        whb = wh.to(torch.bfloat16).contiguous()
        xp = x_proj.contiguous()
        b32 = bias.to(torch.float32).contiguous()
        if x_proj.is_cuda:
            xp = xp.to(torch.bfloat16)
            num_frames = num_frames.to(torch.int32).contiguous()
            if hd % H_MULTIPLE:
                hp = -(-hd // H_MULTIPLE) * H_MULTIPLE
                xp, whb, b32 = pad_units(hp, xp, whb, b32)
        outs, gates, cs, c, h = lstm_train_forward(xp, num_frames, whb, b32,
                                                   reverse)
        ctx.save_for_backward(outs, gates, cs, num_frames, whb)
        ctx.reverse = reverse
        ctx.dtypes = (x_proj.dtype, wh.dtype, bias.dtype)
        ctx.hd = hd
        return (outs[..., :hd].to(torch.float32), c[:, :hd].contiguous(),
                h[:, :hd].contiguous())

    @staticmethod
    def backward(ctx, douts, dfc, dfh):
        outs, gates, cs, num_frames, whb = ctx.saved_tensors
        hd, hp = ctx.hd, whb.shape[0]
        if hp != hd:
            pad = torch.nn.functional.pad
            douts, dfc, dfh = (pad(t, (0, hp - hd)) for t in (douts, dfc, dfh))
        dz = lstm_train_backward(douts, dfc, dfh, gates, cs, num_frames, whb,
                                 ctx.reverse)
        dwh, db = weight_grads(outs, dz)
        if hp != hd:
            dz, db = _unpad(dz, hd), _unpad(db, hd)
            dwh = _unpad(dwh[:hd], hd)
        x_dtype, w_dtype, b_dtype = ctx.dtypes
        return (dz.to(x_dtype), None, dwh.to(w_dtype), db.to(b_dtype), None)


def lstm_recurrence_trainable(x_proj, num_frames, wh, bias, reverse=False):
    """(outputs [F, B, H] f32 (bf16 values), (final_c, final_h) [B, H]
    f32), differentiable in x_proj, wh and bias.

    x_proj [F, B, 4H] time-major (flipped in time when `reverse`);
    num_frames [B]; wh [H, 4H] and bias [4H], rounded to bf16 (wh) inside.
    """
    outs, c, h = LstmRecurrenceTrainable.apply(x_proj, num_frames, wh, bias,
                                               bool(reverse))
    return outs, (c, h)


# ---------------------------------------------------------------------------
# The card tolerance's witness: each kernel's own bf16 stream through the
# plain cell one step at a time.
# ---------------------------------------------------------------------------


def forward_on_stream(outs, x_proj, num_frames, wh, bias, reverse=False):
    """The plain forward fed the kernel's own h stream: step t's product
    takes bf16 h_{t-1} = outs[t-1] (all F products in one matmul), the
    cell runs in f32. (h [F, B, H], gates [F, B, 4H], c [F, B, H]) in f32
    before any rounding, and the final (c, h)."""
    f, b, hd = outs.shape
    nf = num_frames.to(torch.int64)[:, None]
    h_prev = torch.cat([torch.zeros_like(outs[:1]), outs[:-1]]).to(
        torch.float32)
    z = torch.matmul(h_prev, _bf(wh)) + _bf(x_proj)
    c = torch.zeros((b, hd), dtype=torch.float32, device=outs.device)
    h = torch.zeros_like(c)
    hs, gs, cs = [], [], []
    for t in range(f):
        g, c1, h1 = lstm_cell(z[t] + bias, c, hd)
        live = _live(nf, f, t, reverse)
        c = torch.where(live, c1, c)
        h = torch.where(live, h1, h)
        hs.append(h)
        gs.append(torch.cat(g, -1))
        cs.append(c)
    return torch.stack(hs), torch.stack(gs), torch.stack(cs), (c, h)


def backward_on_stream(dz, douts, dfc, dfh, gates, cs, num_frames, wh,
                       reverse=False):
    """The plain backward fed the kernel's own dZ stream: step t's carry
    takes dZ_{t+1} @ W_h^T from the kernel's bf16 dZ (all F products in
    one matmul), the rest runs in f32 on the same residuals. dZ [F, B, 4H]
    in f32 before the rounding."""
    f, b, g = dz.shape
    hd = g // 4
    nf = num_frames.to(torch.int64)[:, None]
    p = torch.matmul(dz[1:].to(torch.float32), _bf(wh).t())
    dout = _bf(douts)
    dh_c = dfh.to(torch.float32)
    dc_c = dfc.to(torch.float32)
    out = [None] * f
    for t in range(f - 1, -1, -1):
        if t < f - 1:
            dh_c = torch.where(_live(nf, f, t + 1, reverse), p[t], dh_c)
        dh = dh_c + dout[t]
        c_t = cs[t].to(torch.float32)
        c_p = (cs[t - 1].to(torch.float32) if t > 0
               else torch.zeros_like(c_t))
        d, dcf, sf = _bptt(dh, dc_c, gates[t].to(torch.float32), c_t, c_p, hd)
        live = _live(nf, f, t, reverse)
        out[t] = torch.where(live, d, 0.0)
        dh_c = dh
        dc_c = torch.where(live, dcf * sf, dc_c)
    return torch.stack(out)


class RoundingReport(NamedTuple):
    """How a kernel's bf16 stream differs from the plain cell's f32 values
    on that stream (rounding_report)."""
    n: int              # elements whose bf16 value is not bf16(plain)
    median: float       # median distance of plain from the midpoint
    excess: float       # max remainder beyond one bf16 step, of max|plain|
    n_far: int          # elements more than one bf16 step from bf16(plain)
    far_value: float    # largest |plain| among those, of max|plain|
    far_steps: int      # the most bf16 steps apart


def _bf16_order(t):
    """bf16 values as integers in their order: adjacent values differ by
    1, and +0 and -0 are both 0."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def rounding_report(kernel_bf16, plain_f32) -> RoundingReport:
    """How the kernel's bf16 values differ from the plain f32 ones computed
    on the kernel's own stream.

    n: the elements where the kernel's value is not bf16 of the plain
    one. median: over those of them not tiny (|value| >= 2^-6 max|plain|),
    the median distance of the plain f32 value from the midpoint between
    the two bf16 values, relative to the value; a value at random lies
    ~2^-10 from it, one on a rounding boundary within the f32 noise.
    excess: max over all elements of |kernel - plain| less one bf16 step
    of the value (2^-8 |plain|), relative to max|plain|: what no rounding
    of an f32 value explains. n_far, far_value, far_steps: the elements
    whose bf16 values lie more than one bf16 step apart, the largest
    |plain| among them relative to max|plain|, and the most steps apart;
    where f32 sums nearly cancel, the two orders of summation differ by
    more than one step of the small result."""
    ref = plain_f32.abs().max().item() or 1.0
    excess = ((kernel_bf16.to(torch.float32) - plain_f32).abs()
              - 2.0 ** -8 * plain_f32.abs()).max().item() / ref
    rounded_plain = plain_f32.to(torch.bfloat16)
    steps = (_bf16_order(kernel_bf16) - _bf16_order(rounded_plain)).abs()
    far = steps > 1
    n_far = int(far.sum())
    far_value = (plain_f32.abs()[far].max().item() / ref) if n_far else 0.0
    differ = kernel_bf16 != rounded_plain
    n = int(differ.sum())
    differ &= plain_f32.abs() >= 2.0 ** -6 * ref
    median = 0.0
    if bool(differ.any()):
        k = kernel_bf16[differ].to(torch.float32)
        r = rounded_plain[differ].to(torch.float32)
        mid = (k + r) / 2
        dist = (plain_f32[differ] - mid).abs() / torch.maximum(k.abs(),
                                                               r.abs())
        median = dist.median().item()
    return RoundingReport(n, median, max(excess, 0.0), n_far, far_value,
                          int(steps.max()))
