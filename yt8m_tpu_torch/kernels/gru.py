"""GRU recurrence for the serving path.

Replaces yt8m_tpu/kernels/gru.py :: gru_recurrence. Given the input
projections xg = X @ W_xg [F, B, 2H] and xc = X @ W_xc [F, B, H]
(time-major, computed outside), every step t computes the TF1 GRUCell:

    r, u   = split(sigmoid(round(h) @ round(W_hg) + round(xg[t]) + bg))
    c      = tanh(round(r * h) @ round(W_hc) + round(xc[t]) + bc)
    h'     = u * h + (1 - u) * c                                  (f32)
    h      = h' where num_frames > orig_t, else unchanged
    out[t] = round(h)

`round` is the cast to bf16, and the exact products are summed in f32;
r * h is formed in f32 before its rounding. orig_t = F-1-t when
`reverse` (xg and xc come already flipped in time and the outputs keep
that order, as in the JAX package). The CUDA kernel (csrc/gru.cu) is
bound by the bf16 tensor-core rate; it is one persistent launch a call
(csrc/recurrence_persist.cuh: W_hg and W_hc resident in shared memory,
barriers between the gate and the candidate product, which needs r over
all H units, and between steps; only the live rows of each step
multiplied, by the schedule of kernels/_schedule.py), and
`gru_recurrence.launches` counts those launches. H that is no multiple
of 64 is padded with
units whose W_h rows and columns, xg and xc columns and biases are
zero: such a unit has u = 0.5, r * h = 0 and c = tanh(0) = 0, so its
h stays 0, and the real units see nothing of it (its W_h rows are zero).
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


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def pad_units(hp: int, xg, xc, whg, whc, bg, bc):
    """(xg, xc, whg, whc, bg, bc) with hp units: both gate blocks of xg,
    W_hg and bg padded with zero columns, xc, W_hc and bc likewise, and
    both W_h with zero rows."""
    hd = whc.shape[0]
    pad = torch.nn.functional.pad

    def gates(t):
        t = t.reshape(*t.shape[:-1], 2, hd)
        t = pad(t, (0, hp - hd))
        return t.reshape(*t.shape[:-2], 2 * hp).contiguous()

    whg = pad(gates(whg), (0, 0, 0, hp - hd)).contiguous()
    whc = pad(whc, (0, hp - hd, 0, hp - hd)).contiguous()
    return (gates(xg), pad(xc, (0, hp - hd)).contiguous(), whg, whc,
            gates(bg), pad(bc, (0, hp - hd)).contiguous())


def gru_gates(zg, hd: int):
    """(r, u) = split(sigmoid(zg)) for gate pre-activations zg [B, 2H]."""
    g = torch.sigmoid(zg)
    return g[:, :hd], g[:, hd:]


def gru_recurrence_plain(xg, xc, num_frames, whg, whc, bg, bc,
                         reverse=False):
    """Plain PyTorch version with the kernel's rounding points (those of
    the JAX package's gru_recurrence_reference): (outputs [F, B, H] f32
    holding bf16 values, final h [B, H] f32)."""
    f, b, g2 = xg.shape
    hd = g2 // 2
    wg, wc = _bf(whg), _bf(whc)
    xgs, xcs = _bf(xg), _bf(xc)
    nf = num_frames.to(torch.int64)[:, None]
    h = torch.zeros((b, hd), dtype=torch.float32, device=xg.device)
    outs = []
    for t in range(f):
        r, u = gru_gates(torch.matmul(_bf(h), wg) + xgs[t] + bg, hd)
        c = torch.tanh(torch.matmul(_bf(r * h), wc) + xcs[t] + bc)
        h1 = u * h + (1.0 - u) * c
        live = nf > ((f - 1 - t) if reverse else t)
        h = torch.where(live, h1, h)
        outs.append(h.to(torch.bfloat16))
    return torch.stack(outs).to(torch.float32), h


def gru_recurrence(xg, xc, num_frames, whg, whc, bg, bc, reverse=False):
    """(outputs [F, B, H] f32 (bf16 values), final h [B, H] f32).

    xg [F, B, 2H] and xc [F, B, H] (bf16 on the card); num_frames [B]
    (int32 on the card); whg [H, 2H] and whc [H, H] (bf16 on the card);
    bg [2H] and bc [H] f32.
    """
    require(xg.dim() == 3 and xg.shape[2] % 2 == 0,
            f"xg must be [F, B, 2H], got {tuple(xg.shape)}")
    f, b, g2 = xg.shape
    hd = g2 // 2
    require(tuple(xc.shape) == (f, b, hd),
            f"xc must be [{f}, {b}, {hd}], got {tuple(xc.shape)}")
    require(tuple(whg.shape) == (hd, g2) and tuple(whc.shape) == (hd, hd),
            f"whg, whc must be [{hd}, {g2}], [{hd}, {hd}], got "
            f"{tuple(whg.shape)}, {tuple(whc.shape)}")
    if on_cpu(xg, xc, num_frames, whg, whc, bg, bc):
        return gru_recurrence_plain(xg, xc, num_frames, whg, whc, bg, bc,
                                    reverse)
    if hd % H_MULTIPLE:
        hp = -(-hd // H_MULTIPLE) * H_MULTIPLE
        xg, xc, whg, whc, bg, bc = pad_units(hp, xg, xc, whg, whc, bg, bc)
        out, h = gru_recurrence(xg, xc, num_frames, whg, whc, bg, bc,
                                reverse)
        return out[..., :hd].contiguous(), h[:, :hd].contiguous()
    out, h, _, _, _, _ = forward_kernel(xg, xc, num_frames, whg, whc, bg, bc,
                                        reverse)
    gru_recurrence.launches += 1
    return out.to(torch.float32), h


def forward_kernel(xg, xc, num_frames, whg, whc, bg, bc, reverse=False,
                   h0=None, h=None, residuals=False, skip_work=False):
    """The C call of the CUDA forward (csrc/gru.cu, one launch), serving
    or with `residuals` (the trainable forward, the same kernel's
    Residuals instance), on CUDA tensors with H a multiple of 64: (out
    [F, B, H] bf16, h [B, H] f32, and the last step's u [B, H] f32 and
    bf16(r * h) [B, H], gates [F, B, 2H] and cand [F, B, H] bf16 or
    None). The kernel writes u and bf16(r * h) of the live rows only. h0
    (bf16) and h (f32, updated in place) give the state before the first
    step; zeros by default. skip_work runs the kernel's schedule and
    barriers alone (their share of a call, for measurement)."""
    f, b, g2 = xg.shape
    hd = g2 // 2
    require(hd % H_MULTIPLE == 0, f"H={hd} must be a multiple of "
            f"{H_MULTIPLE} (gru_recurrence pads it)")
    require(f >= 1, "F must be at least 1")
    require_cuda_operand("xg", xg, torch.bfloat16, (f, b, g2))
    require_cuda_operand("xc", xc, torch.bfloat16, (f, b, hd))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("whg", whg, torch.bfloat16, (hd, g2))
    require_cuda_operand("whc", whc, torch.bfloat16, (hd, hd))
    require_cuda_operand("bg", bg, torch.float32, (g2,))
    require_cuda_operand("bc", bc, torch.float32, (hd,))
    dev = xg.device
    if h0 is None:
        h0 = torch.zeros((b, hd), dtype=torch.bfloat16, device=dev)
    if h is None:
        h = torch.zeros((b, hd), dtype=torch.float32, device=dev)
    require_cuda_operand("h0", h0, torch.bfloat16, (b, hd))
    require_cuda_operand("h", h, torch.float32, (b, hd))
    u = torch.empty((b, hd), dtype=torch.float32, device=dev)
    rh = torch.empty((b, hd), dtype=torch.bfloat16, device=dev)
    out = torch.empty((f, b, hd), dtype=torch.bfloat16, device=dev)
    order, live = live_schedule(num_frames, f, reverse)
    barrier = torch.zeros(BARRIER_WORDS, dtype=torch.int32, device=dev)
    ts = [xg, xc, num_frames, order, live, whg, whc, bg, bc, h0, h, u, rh,
          out]
    gates = cand = None
    lib = _build.library()
    if residuals:
        gates = torch.empty((f, b, g2), dtype=torch.bfloat16, device=dev)
        cand = torch.empty((f, b, hd), dtype=torch.bfloat16, device=dev)
        fn, name, ts = (lib.yt8m_gru_train_forward, "gru_train_forward",
                        ts + [gates, cand])
    else:
        fn, name = lib.yt8m_gru_recurrence, "gru_recurrence"
    code = fn(*(_build.ptr(t) for t in ts + [barrier]), f, b, hd,
              int(bool(reverse)), int(skip_work), _build.current_stream(dev))
    _build.check_launch(name, code)
    return out, h, u, rh, gates, cand


def barriers_only(xg, xc, num_frames, whg, whc, bg, bc, reverse=False,
                  residuals=False):
    """The kernel (the serving instance, or with `residuals` the
    trainable forward's) with its products and cell updates skipped: its
    schedule and 2F - 1 barriers alone (not counted in `launches`)."""
    forward_kernel(xg, xc, num_frames, whg, whc, bg, bc, reverse,
                   residuals=residuals, skip_work=True)


def plan(b: int, hd: int) -> dict:
    """The serving kernel's launch plan at B rows and H units (H a
    multiple of 64): see kernels/_schedule.py :: launch_plan."""
    return launch_plan(_build.library().yt8m_gru_plan, b, hd)


gru_recurrence.launches = 0
