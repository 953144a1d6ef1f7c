"""Trainable GRU recurrence: a CUDA forward that streams residuals and a
reverse-time CUDA backward that emits dA_g and dA_c, as a
torch.autograd.Function.

Replaces yt8m_tpu/kernels/gru_train.py :: gru_recurrence_trainable, a
custom VJP over two pallas_calls (the forward at :104, the backward at
:235), with its contract: the recurrence of kernels/gru.py, gradients
for xg, xc, W_hg, W_hc, bg and bc (num_frames is integer data).

Forward (csrc/gru.cu, the serving kernel's Residuals instance): the
serving recurrence, which also writes the post-sigmoid gates bf16([r, u])
[F, B, 2H] and the candidate bf16(c) [F, B, H]; the outputs are
bf16(h_t). The kernel computes live rows only: at a row's frozen steps
its gates and candidate are 0 (the plain version computes them there
too; nothing reads them, every use is masked).

Backward (csrc/gru_train.cu), t = F-1 first, with the dh carry in f32
and hprev = outs[t-1] (bf16, 0 at t = 0), emitting the gradients of the
gate and candidate pre-activations in bf16:

    dh    = dh_carry + bf16(dout_t)
    da_u  = dh (hprev - c) u (1 - u);   da_c = dh (1 - u) (1 - c^2)
    drh   = bf16(da_c) @ W_hc^T;        da_r = drh hprev r (1 - r)
    dA_g  = bf16([da_r, da_u]),  dA_c = bf16(da_c)     (0 where frozen)
    dh_carry = dh u + drh r + dA_g @ W_hg^T where live, else dh

with live = num_frames > orig_t (orig_t = F-1-t under `reverse`).
Outside the kernel, as the JAX package's _bwd_rule: dW_hg = hprev^T
dA_g and dW_hc = bf16(bf16(r) hprev)^T dA_c as bf16 products with f32
output, dbg and dbc the f32 sums of dA_g and dA_c, dxg = dA_g and dxc =
dA_c.

Both directions are one persistent launch a call
(csrc/recurrence_persist.cuh: the weights resident in shared memory,
barriers between each step's two dependent products, live rows only, by
the schedule of kernels/_schedule.py); gru_train_backward_by_schedule is
the backward's decomposition in plain PyTorch.
`gru_train_forward.launches` and `gru_train_backward.launches` count the
launches. H that is no multiple of 64 is padded as kernels/gru.py pads
it; a padded unit's dA is 0.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels import gru as _gru
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
from yt8m_tpu_torch.kernels.gru import (
    H_MULTIPLE,
    _bf,
    forward_kernel,
    gru_gates,
    pad_units,
)


def _live(nf, f: int, t: int, reverse: bool):
    return nf > ((f - 1 - t) if reverse else t)


def gru_train_forward_plain(xg, xc, num_frames, whg, whc, bg, bc,
                            reverse=False):
    """Plain PyTorch forward with the kernel's rounding points: (outs
    [F, B, H], gates [F, B, 2H], cand [F, B, H], all bf16; final h [B, H]
    f32)."""
    f, b, g2 = xg.shape
    hd = g2 // 2
    wg, wc = _bf(whg), _bf(whc)
    xgs, xcs = _bf(xg), _bf(xc)
    nf = num_frames.to(torch.int64)[:, None]
    h = torch.zeros((b, hd), dtype=torch.float32, device=xg.device)
    outs, gates, cands = [], [], []
    for t in range(f):
        r, u = gru_gates(torch.matmul(_bf(h), wg) + xgs[t] + bg, hd)
        c = torch.tanh(torch.matmul(_bf(r * h), wc) + xcs[t] + bc)
        h = torch.where(_live(nf, f, t, reverse), u * h + (1.0 - u) * c, h)
        outs.append(h.to(torch.bfloat16))
        gates.append(torch.cat([r, u], -1).to(torch.bfloat16))
        cands.append(c.to(torch.bfloat16))
    return torch.stack(outs), torch.stack(gates), torch.stack(cands), h


def hprev_of(outs):
    """h_{t-1} for every step: outs shifted one step, zeros first."""
    return torch.cat([torch.zeros_like(outs[:1]), outs[:-1]])


def _bptt(dh, gates_t, cand_t, hp, hd: int):
    """(da_u, da_c, r, u) of one step on f32 values, before the mask."""
    r, u = gates_t[:, :hd], gates_t[:, hd:]
    da_u = dh * (hp - cand_t) * u * (1.0 - u)
    da_c = dh * (1.0 - u) * (1.0 - cand_t * cand_t)
    return da_u, da_c, r, u


def gru_train_backward_plain(douts, dfh, gates, cand, outs, num_frames,
                             whg, whc, reverse=False):
    """Plain PyTorch backward with the kernel's rounding points: (dA_g
    [F, B, 2H], dA_c [F, B, H]) bf16 from the cotangents of the outputs
    (rounded to bf16) and of the final h, and the forward's bf16 outputs
    and residuals. drh is formed from da_c before its mask, as in JAX."""
    f, b, g2 = gates.shape
    hd = g2 // 2
    wgt, wct = _bf(whg).t(), _bf(whc).t()
    dout = _bf(douts)
    hprev = hprev_of(outs).to(torch.float32)
    nf = num_frames.to(torch.int64)[:, None]
    dh_c = dfh.to(torch.float32)
    dag_all, dac_all = [None] * f, [None] * f
    for t in range(f - 1, -1, -1):
        dh = dh_c + dout[t]
        da_u, da_c, r, u = _bptt(dh, gates[t].to(torch.float32),
                                 cand[t].to(torch.float32), hprev[t], hd)
        drh = torch.matmul(_bf(da_c), wct)
        da_r = drh * hprev[t] * r * (1.0 - r)
        live = _live(nf, f, t, reverse)
        dag = torch.where(live, torch.cat([da_r, da_u], -1), 0.0).to(
            torch.bfloat16)
        dac = torch.where(live, da_c, 0.0).to(torch.bfloat16)
        dh_prev = dh * u + drh * r + torch.matmul(dag.to(torch.float32), wgt)
        dh_c = torch.where(live, dh_prev, dh)
        dag_all[t], dac_all[t] = dag, dac
    return torch.stack(dag_all), torch.stack(dac_all)


def gru_train_backward_by_schedule(douts, dfh, gates, cand, outs,
                                   num_frames, whg, whc, reverse=False):
    """gru_train_backward_plain as the CUDA backward decomposes it, in
    plain PyTorch: the rows in the live-row order; step t computes only
    the prefix of rows live at t, and takes the carry's product
    (dA_g[t+1] @ W_hg^T) for only its first product_rows[t] (live at t+1
    too); drh is formed from the masked dA_c of the live rows; a row's
    frozen steps emit dA = 0 and, forward, add their bf16(dout_t) to its
    dh carry one at a time, t = F-1 down. (dA_g [F, B, 2H], dA_c
    [F, B, H]) bf16."""
    f, b, g2 = gates.shape
    hd = g2 // 2
    order, live = live_schedule(num_frames, f, reverse)
    prod = product_rows(live).tolist()
    order, live = order.long(), live.tolist()
    wgt, wct = _bf(whg).t(), _bf(whc).t()
    dout = _bf(douts)
    hprev = hprev_of(outs).to(torch.float32)
    nf = num_frames.to(torch.int64)[:, None]
    dh = dfh.to(torch.float32).clone()
    drh = torch.zeros_like(dh)
    dag = torch.zeros((f, b, g2), dtype=torch.bfloat16, device=gates.device)
    dac = torch.zeros((f, b, hd), dtype=torch.bfloat16, device=gates.device)
    if not reverse:  # the frozen steps come first in the backward
        for t in range(f - 1, -1, -1):
            dh = torch.where(nf <= t, dh + dout[t], dh)
    for t in range(f - 1, -1, -1):
        rows = order[:live[t]]
        dh_t = dh[rows]
        if prod[t]:
            pr = rows[:prod[t]]
            g1 = gates[t + 1, pr].to(torch.float32)
            p_t = torch.matmul(dag[t + 1, pr].to(torch.float32), wgt)
            dh_t[:prod[t]] = (dh_t[:prod[t]] * g1[:, hd:]
                              + drh[pr] * g1[:, :hd] + p_t)
        dh_t = dh_t + dout[t, rows]
        da_u, da_c, r, _ = _bptt(dh_t, gates[t, rows].to(torch.float32),
                                 cand[t, rows].to(torch.float32),
                                 hprev[t, rows], hd)
        dac[t, rows] = da_c.to(torch.bfloat16)
        drh_t = torch.matmul(dac[t, rows].to(torch.float32), wct)
        da_r = drh_t * hprev[t, rows] * r * (1.0 - r)
        dag[t, rows] = torch.cat([da_r, da_u], -1).to(torch.bfloat16)
        dh[rows] = dh_t
        drh[rows] = drh_t
    return dag, dac


def gru_train_forward(xg, xc, num_frames, whg, whc, bg, bc, reverse=False):
    """(outs, gates, cand, h) as gru_train_forward_plain: the CUDA forward
    for CUDA tensors (xg, xc, whg, whc bf16, num_frames int32, bg, bc
    f32, H a multiple of 64), the plain version for CPU tensors."""
    require(xg.dim() == 3 and xg.shape[2] % 2 == 0,
            f"xg must be [F, B, 2H], got {tuple(xg.shape)}")
    if on_cpu(xg, xc, num_frames, whg, whc, bg, bc):
        return gru_train_forward_plain(xg, xc, num_frames, whg, whc, bg, bc,
                                       reverse)
    out, h, _, _, gates, cand = forward_kernel(
        xg, xc, num_frames, whg, whc, bg, bc, reverse, residuals=True)
    gru_train_forward.launches += 1
    return out, gates, cand, h


def gru_train_backward(douts, dfh, gates, cand, outs, num_frames, whg, whc,
                       reverse=False):
    """(dA_g, dA_c) bf16 as gru_train_backward_plain: the CUDA backward
    for CUDA tensors (douts rounded to bf16 here), the plain version for
    CPU tensors."""
    require(gates.dim() == 3 and gates.shape[2] % 2 == 0,
            f"gates must be [F, B, 2H], got {tuple(gates.shape)}")
    f, b, g2 = gates.shape
    hd = g2 // 2
    if on_cpu(douts, dfh, gates, cand, outs, num_frames, whg, whc):
        return gru_train_backward_plain(douts, dfh, gates, cand, outs,
                                        num_frames, whg, whc, reverse)
    require(hd % H_MULTIPLE == 0, f"H={hd} must be a multiple of "
            f"{H_MULTIPLE} (gru_recurrence_trainable pads it)")
    dag, dac = _backward(douts, dfh, gates, cand, outs, num_frames, whg, whc,
                         reverse)
    gru_train_backward.launches += 1
    return dag, dac


def _backward(douts, dfh, gates, cand, outs, num_frames, whg, whc, reverse,
              skip_work=False):
    """The C call of the CUDA backward on CUDA tensors: (dA_g, dA_c)
    bf16. skip_work runs the kernel's schedule and barriers alone."""
    f, b, g2 = gates.shape
    hd = g2 // 2
    dout = douts.to(torch.bfloat16).contiguous()
    require_cuda_operand("douts", dout, torch.bfloat16, (f, b, hd))
    require_cuda_operand("gates", gates, torch.bfloat16, (f, b, g2))
    require_cuda_operand("cand", cand, torch.bfloat16, (f, b, hd))
    require_cuda_operand("outs", outs, torch.bfloat16, (f, b, hd))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("whg", whg, torch.bfloat16, (hd, g2))
    require_cuda_operand("whc", whc, torch.bfloat16, (hd, hd))
    dev = gates.device
    dh = dfh.to(torch.float32).contiguous().clone()  # the carry, seeded
    require_cuda_operand("dfh", dh, torch.float32, (b, hd))
    drh = torch.empty((b, hd), dtype=torch.float32, device=dev)
    dag = torch.empty((f, b, g2), dtype=torch.bfloat16, device=dev)
    dac = torch.empty((f, b, hd), dtype=torch.bfloat16, device=dev)
    order, live = live_schedule(num_frames, f, reverse)
    barrier = torch.zeros(BARRIER_WORDS, dtype=torch.int32, device=dev)
    code = _build.library().yt8m_gru_train_backward(
        *(_build.ptr(t) for t in (dout, gates, cand, outs, num_frames, order,
                                  live, whg, whc, dh, drh, dag, dac,
                                  barrier)),
        f, b, hd, int(bool(reverse)), int(skip_work),
        _build.current_stream(dev),
    )
    _build.check_launch("gru_train_backward", code)
    return dag, dac


def barriers_only_forward(xg, xc, num_frames, whg, whc, bg, bc,
                          reverse=False):
    """The forward with its products and cell updates skipped: its
    schedule and 2F - 1 barriers alone (not counted in `launches`)."""
    _gru.barriers_only(xg, xc, num_frames, whg, whc, bg, bc, reverse,
                       residuals=True)


def barriers_only_backward(douts, dfh, gates, cand, outs, num_frames, whg,
                           whc, reverse=False):
    """The backward with its products and cell updates skipped: its
    schedule and 2F - 1 barriers alone (not counted in `launches`)."""
    _backward(douts, dfh, gates, cand, outs, num_frames, whg, whc, reverse,
              skip_work=True)


def plan(b: int, hd: int) -> dict:
    """The backward's launch plan at B rows and H units (H a multiple of
    64), its ring included: see kernels/_schedule.py :: launch_plan. The
    forward's is kernels/gru.py :: plan."""
    return launch_plan(_build.library().yt8m_gru_train_plan, b, hd,
                       backward=True)


gru_train_forward.launches = 0
gru_train_backward.launches = 0


def _mm_f32(a, b):
    """a @ b of bf16 operands with f32 output."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.to(torch.float32), b.to(torch.float32))


def weight_grads(outs, gates, dag, dac):
    """(dW_hg [H, 2H], dW_hc [H, H], dbg [2H], dbc [H]) in f32 from the
    bf16 outputs, gates and dA, as the JAX package's _bwd_rule: hprev =
    outs[t-1] (0 at t = 0, so step 0 adds nothing to the products), and
    r * hprev formed in f32 from the bf16 values and rounded to bf16."""
    hd = outs.shape[2]
    hprev = outs[:-1].reshape(-1, hd)
    r = gates[1:, :, :hd].reshape(-1, hd)
    rh = (r.to(torch.float32) * hprev.to(torch.float32)).to(torch.bfloat16)
    dwhg = _mm_f32(hprev.t(), dag[1:].reshape(-1, 2 * hd))
    dwhc = _mm_f32(rh.t(), dac[1:].reshape(-1, hd))
    return (dwhg, dwhc, torch.sum(dag, dim=(0, 1), dtype=torch.float32),
            torch.sum(dac, dim=(0, 1), dtype=torch.float32))


def _unpad_gates(t, hd: int):
    """[..., 2 * hp] -> [..., 2 * hd]: the first hd units of each gate."""
    hp = t.shape[-1] // 2
    return t.reshape(*t.shape[:-1], 2, hp)[..., :hd].reshape(
        *t.shape[:-1], 2 * hd)


class GruRecurrenceTrainable(torch.autograd.Function):
    """(outs [F, B, H] f32 holding bf16 values, h [B, H] f32); the
    gradients of xg (dA_g), xc (dA_c), whg, whc (f32) and bg, bc."""

    @staticmethod
    def forward(ctx, xg, xc, num_frames, whg, whc, bg, bc, reverse):
        hd = whc.shape[0]
        whgb = whg.to(torch.bfloat16).contiguous()
        whcb = whc.to(torch.bfloat16).contiguous()
        xgp, xcp = xg.contiguous(), xc.contiguous()
        bg32 = bg.to(torch.float32).contiguous()
        bc32 = bc.to(torch.float32).contiguous()
        if xg.is_cuda:
            xgp, xcp = xgp.to(torch.bfloat16), xcp.to(torch.bfloat16)
            num_frames = num_frames.to(torch.int32).contiguous()
            if hd % H_MULTIPLE:
                hp = -(-hd // H_MULTIPLE) * H_MULTIPLE
                xgp, xcp, whgb, whcb, bg32, bc32 = pad_units(
                    hp, xgp, xcp, whgb, whcb, bg32, bc32)
        outs, gates, cand, h = gru_train_forward(xgp, xcp, num_frames, whgb,
                                                 whcb, bg32, bc32, reverse)
        ctx.save_for_backward(outs, gates, cand, num_frames, whgb, whcb)
        ctx.reverse = reverse
        ctx.dtypes = (xg.dtype, xc.dtype, whg.dtype, whc.dtype, bg.dtype,
                      bc.dtype)
        ctx.hd = hd
        return outs[..., :hd].to(torch.float32), h[:, :hd].contiguous()

    @staticmethod
    def backward(ctx, douts, dfh):
        outs, gates, cand, num_frames, whgb, whcb = ctx.saved_tensors
        hd, hp = ctx.hd, whcb.shape[0]
        if hp != hd:
            pad = torch.nn.functional.pad
            douts, dfh = pad(douts, (0, hp - hd)), pad(dfh, (0, hp - hd))
        dag, dac = gru_train_backward(douts, dfh, gates, cand, outs,
                                      num_frames, whgb, whcb, ctx.reverse)
        dwhg, dwhc, dbg, dbc = weight_grads(outs, gates, dag, dac)
        if hp != hd:
            dag, dbg = _unpad_gates(dag, hd), _unpad_gates(dbg, hd)
            dwhg = _unpad_gates(dwhg[:hd], hd)
            dac, dbc, dwhc = dac[..., :hd], dbc[:hd], dwhc[:hd, :hd]
        grads = (dag, dac, dwhg, dwhc, dbg, dbc)
        dxg, dxc, dwg, dwc, dbg, dbc = (g.to(d) for g, d in
                                        zip(grads, ctx.dtypes))
        return dxg, dxc, None, dwg, dwc, dbg, dbc, None


def gru_recurrence_trainable(xg, xc, num_frames, whg, whc, bg, bc,
                             reverse=False):
    """(outputs [F, B, H] f32 (bf16 values), final h [B, H] f32),
    differentiable in xg, xc, whg, whc, bg and bc.

    xg [F, B, 2H] and xc [F, B, H] time-major (flipped in time when
    `reverse`); num_frames [B]; whg [H, 2H] and whc [H, H], rounded to
    bf16 inside; bg [2H] and bc [H].
    """
    return GruRecurrenceTrainable.apply(xg, xc, num_frames, whg, whc, bg, bc,
                                        bool(reverse))


# ---------------------------------------------------------------------------
# The card tolerance's witness: the plain cell fed the kernels' own state
# and bf16 streams (rounding_report in kernels/lstm_train.py reads the
# results).
# ---------------------------------------------------------------------------


def forward_steps_on_card(xg, xc, num_frames, whg, whc, bg, bc,
                          reverse=False):
    """The serving kernel run one step at a time (C calls of F = 1 on
    CUDA tensors, the state carried from call to call) and, at each step,
    the plain cell fed the kernel's own state: the gate product from the
    kernel's bf16 h, the candidate product from the kernel's bf16(r * h),
    the update from the kernel's u and f32 h. Each call takes every row
    as live (the kernel computes no row past its live prefix, and the
    witness reads u and bf16(r * h) of every row); the freeze past
    num_frames is applied to the kernel's state here, as the plain cell
    applies it. Stacked [F, B, H]: the kernel's (u f32, bf16(r * h), h
    f32, out bf16) and the plain (u, r * h before its rounding, h), all
    f32."""
    f, b, g2 = xg.shape
    hd = g2 // 2
    wg, wc = _bf(whg), _bf(whc)
    h0 = torch.zeros((b, hd), dtype=torch.bfloat16, device=xg.device)
    h = torch.zeros((b, hd), dtype=torch.float32, device=xg.device)
    every_row = torch.ones_like(num_frames)
    kernel = {k: [] for k in ("u", "rh", "h", "out")}
    plain = {k: [] for k in ("u", "rh", "h")}
    for t in range(f):
        orig = (f - 1 - t) if reverse else t
        live = (num_frames.to(torch.int64) > orig)[:, None]
        h_before = h.clone()
        out, h, u, rh, _, _ = forward_kernel(
            xg[t:t + 1], xc[t:t + 1], every_row, whg, whc, bg, bc, h0=h0,
            h=h)
        h = torch.where(live, h, h_before)
        out = torch.where(live, out, h_before.to(torch.bfloat16))
        r_p, u_p = gru_gates(torch.matmul(h0.to(torch.float32), wg)
                             + _bf(xg[t]) + bg, hd)
        c_p = torch.tanh(torch.matmul(rh.to(torch.float32), wc) + _bf(xc[t])
                         + bc)
        h_p = torch.where(live, u * h_before + (1.0 - u) * c_p, h_before)
        for k, v in (("u", u), ("rh", rh), ("h", h.clone()), ("out", out[0])):
            kernel[k].append(v)
        for k, v in (("u", u_p), ("rh", r_p * h_before), ("h", h_p)):
            plain[k].append(v)
        h0 = out[0]
    return ({k: torch.stack(v) for k, v in kernel.items()},
            {k: torch.stack(v) for k, v in plain.items()})


def residuals_on_stream(outs, rh, xg, xc, whg, whc, bg, bc):
    """The plain gates and candidate fed a forward's own bf16 streams: the
    gate product of step t from outs[t-1], the candidate's from the
    kernel's bf16(r * h) of step t (all F products in one matmul each).
    (gates [F, B, 2H], cand [F, B, H]) f32 before the rounding."""
    gates = torch.sigmoid(torch.matmul(hprev_of(outs).to(torch.float32),
                                       _bf(whg)) + _bf(xg) + bg)
    cand = torch.tanh(torch.matmul(rh.to(torch.float32), _bf(whc)) + _bf(xc)
                      + bc)
    return gates, cand


def backward_on_stream(dag, dac, douts, dfh, gates, cand, outs, num_frames,
                       whg, whc, reverse=False):
    """The plain backward fed the kernel's own dA streams: step t's
    products take dA_g[t+1] and dA_c[t] from the kernel's bf16 output
    (all F products in one matmul each; dA_c masked, as the kernel takes
    it), the rest runs in f32 on the same residuals. (dA_g [F, B, 2H],
    dA_c [F, B, H]) in f32 before the rounding, 0 where frozen."""
    f, b, g2 = gates.shape
    hd = g2 // 2
    p_carry = torch.matmul(dag[1:].to(torch.float32), _bf(whg).t())
    p_drh = torch.matmul(dac.to(torch.float32), _bf(whc).t())
    dout = _bf(douts)
    hprev = hprev_of(outs).to(torch.float32)
    nf = num_frames.to(torch.int64)[:, None]
    dh = dfh.to(torch.float32)
    out_g, out_c = [None] * f, [None] * f
    for t in range(f - 1, -1, -1):
        if t < f - 1:
            carry = dh * u + p_drh[t + 1] * r + p_carry[t]
            dh = torch.where(_live(nf, f, t + 1, reverse), carry, dh)
        dh = dh + dout[t]
        da_u, da_c, r, u = _bptt(dh, gates[t].to(torch.float32),
                                 cand[t].to(torch.float32), hprev[t], hd)
        da_r = p_drh[t] * hprev[t] * r * (1.0 - r)
        live = _live(nf, f, t, reverse)
        out_g[t] = torch.where(live, torch.cat([da_r, da_u], -1), 0.0)
        out_c[t] = torch.where(live, da_c, 0.0)
    return torch.stack(out_g), torch.stack(out_c)
