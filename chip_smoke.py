#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (yt8m_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each with the elapsed seconds:
  1. the card (nvidia-smi name and power limit); raises without CUDA;
  2. the build of every kernel (one nvcc call);
  3. each kernel against its plain PyTorch version on the card at the
     serving shapes of its paths (DBoF at DbofModel's B=2048; MoE and
     top-k at DbofModel's B=2048, H=1024 and at the flagship's B=512,
     H=2048; NetVLAD and the LSTM at the flagship's B=512) plus small
     edge cases and planted hazards, with its median time (CUDA events),
     the plain version's time, the time of one PyTorch yardstick for the
     same function, and the bound of the work;
  4. serving end to end through the inference CLI over synthetic
     frame-level TFRecords, for each path with the launch counts set to
     0 just before it and read just after: DbofModel at the reference
     width (K=8192, H=1024, 30 frames, MoE M=2 over 4716 classes, bf16),
     then the flagship NetVladLstmModel at the JAX defaults (all 300
     frames masked by num_frames, D=1152, VLAD K=256 with hidden 1024,
     BN and context gating, LSTM 2 x 1024 with last pooling, MoE M=2 over
     4716 classes, bf16); CSV checks, and 8 videos compared with the same
     model on the CPU;
  5. each serving step alone on frames already on the card (DbofModel at
     B=2048, the flagship at B=512): median step time of 5, and device
     time by kernel from torch.profiler;
  6. training: the trainable LSTM recurrence (forward with residuals and
     the reverse-time backward) against its plain version at the
     flagship's training shape (B=256, F=300, H=1024, both directions)
     with planted hazards, its rounding witness, times and bounds beside
     one cuDNN LSTM layer's forward and backward; then the flagship
     trained at full width through make_train_step (B=256 as
     bench_train.py, bf16, Adam at the config defaults, per-variable
     clip 1.0) for 10 steps on one repeated synthetic batch, with its
     launch counts set to 0 just before and read just after, a falling
     loss, the median step time of 5, a torch.profiler breakdown of one
     step and the peak memory; DbofModel trained at B=512, K=8192; one
     flagship training step on 8 videos on the card and on the CPU.
Then a `{"kernels": [...]}` line, the nvidia-smi line, and as the last
line `{"ok": true, "device": {...}}`. Any failed check raises: the exit
code is not 0 and no `ok` line is printed. Nothing of JAX is imported.

Tolerances, max|kernel - plain| on the same inputs:
  * DBoF, MoE: <= 1e-3 * max|ref| + 1e-5. Both round the same operands
    to bf16 at the same points (elementwise, in the same order); only the
    summation order of the products differs.
  * top-k: exactly equal.
  * NetVLAD: <= 2^-8 * max|ref| + 1e-6. The assignment is rounded to
    bf16 after a softmax whose f32 max and sum run in another order in
    the two versions; where a value lies within their last-bit
    difference of a bf16 rounding boundary, the two round one bf16 step
    (2^-8 relative) apart, and that moves one frame's term of one
    cluster row, which the intra-normalisation carries into the row.
    1e-3 * max|ref| does not hold (2.2e-5 against 1.0e-5 was read on
    the card). The witness shows the cause: the assignments differ only
    by one bf16 step at rounding boundaries, and on the kernel's own
    assignment the plain remainder meets 1e-3 * max|ref| + 1e-6.
  * LSTM, serving and trainable (outputs, final state, gates, c_t, dZ,
    dx_proj, dW_h, db): <= 2e-2 * max(1, max|ref|). Both round h (and
    dZ) to bf16 before every step's product; where the f32 sums differ
    in their last bits a rounding can land one bf16 step apart, and the
    recurrence carries that step into the following steps. 2e-2 is the
    JAX package's own bound for its kernel against its scan
    (tests/test_kernels.py). The witness shows the cause on the card:
    the plain cell fed each kernel's own bf16 stream one step at a time
    (h for the forwards, dZ for the backward) rounds to the kernel's
    value but for a few in 1e4, which sit at bf16 rounding boundaries
    (median distance from the midpoint <= 2^-14 of the value); what one
    bf16 step does not explain stays under 1e-3 * max|ref|, and the f32
    final state meets 1e-3 * max|ref| + 1e-6. Values more than one bf16
    step apart are counted and printed, with the largest |value| among
    them: small results of nearly cancelling f32 sums, whose order of
    summation moves them by more than one of their steps. They are held
    by the 1e-3 remainder alone.
  * planted hazards: the kernel's output with large values in the frames
    or steps past num_frames equals its output with zeros there.
  * card vs CPU end to end (8 videos): probabilities within 2e-3.
  * card vs CPU, one flagship training step (8 videos, bf16): the loss
    within 2e-3 relative, each parameter's gradient norm within 2e-2
    relative (the LSTM bound: the recurrence carries one-step bf16
    rounding differences into the gradients).
"""

from __future__ import annotations

import csv
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM datasheet peaks (dense): bf16 tensor cores, f32 outside them,
# device memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

BATCH = 2048          # bench.py's serving batch (DbofModel)
FRAMES = 30           # iterations (sampled frames per video)
FEATURE_DIM = 1152    # rgb 1024 + audio 128
CLUSTERS = 8192
HIDDEN = 1024
CLASSES = 4716
MIXTURES = 2
TOP_K = 20
E2E_VIDEOS = 256
E2E_BATCH = 128
# The flagship NetVladLstmModel at the JAX package's defaults.
FLAG_BATCH = 512
FLAG_FRAMES = 300     # every frame, masked by num_frames (no sampling)
VLAD_CLUSTERS = 256
VLAD_HIDDEN = 1024
LSTM_CELLS = 1024
LSTM_LAYERS = 2
VLAD_REL = 2.0 ** -8
LSTM_TOL = 2e-2
TRAIN_BATCH = 256      # bench_train.py's NetVladLstmModel batch
TRAIN_STEPS = 10
DBOF_TRAIN_BATCH = 512  # bench_train.py's DbofModel batch


class SmokeFailure(RuntimeError):
    pass


def say(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(flops: float, nbytes: float, peak_flops: float):
    """(bound_ms, bound_by): the larger of the operations and the bytes
    over the card's peak rates."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(torch, fn, reps: int, flush) -> float:
    """Median CUDA-event time of fn over reps launches, L2 flushed before
    each (the serving step streams other weights between launches)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_check(name, got, want, rel=1e-3, abs_=1e-5) -> float:
    """max|got - want| <= rel * max|want| + abs_; returns the max error."""
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    check(math.isfinite(err) and err <= rel * scale + abs_,
          f"{name}: max|diff| {err:.3e} > {rel} * {scale:.3e} + {abs_}")
    return err


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def dbof_inputs(torch, gen, b, s, d, k, x_dtype, dev):
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE

    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, s, d), generator=gen,
                          dtype=torch.uint8)
        s_in = DEQUANT_SCALE * (0.5 + torch.rand(d, generator=gen))
        b_in = DEQUANT_BIAS * s_in + 0.1 * torch.randn(d, generator=gen)
    else:
        x = torch.randn(b, s, d, generator=gen)
        s_in = 0.5 + torch.rand(d, generator=gen)
        b_in = 0.1 * torch.randn(d, generator=gen)
    w = (torch.randn(d, k, generator=gen) * d ** -0.5).to(torch.bfloat16)
    s_act = 0.5 + torch.rand(k, generator=gen)
    b_act = 0.1 * torch.randn(k, generator=gen)
    return [t.to(dev) for t in (x, w, s_in, b_in, s_act, b_act)]


def check_dbof(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool_plain,
        dbof_cluster_maxpool_v2,
    )

    # Edge cases: ragged B and K, S < 32, float input, and the padded-row
    # hazard (every real row negative before the ReLU, a zero row would
    # give relu(act_bias) = 3).
    for b, s, d, k, dt in ((7, 5, 64, 200, torch.uint8),
                           (9, 32, 96, 136, torch.float32),
                           (5, 30, 1152, 8192, torch.uint8)):
        args = dbof_inputs(torch, gen, b, s, d, k, dt, dev)
        rel_check(f"dbof edge B={b} S={s} D={d} K={k} {dt}",
                  dbof_cluster_maxpool_v2(*args),
                  dbof_cluster_maxpool_plain(*args))
    x, w, s_in, b_in, s_act, b_act = dbof_inputs(
        torch, gen, 6, 30, 64, 64, torch.uint8, dev)
    w = torch.full_like(w, -1.0)
    s_in = torch.ones_like(s_in)
    b_in = torch.full_like(b_in, 1.0)
    b_act = torch.full_like(b_act, 3.0)
    got = dbof_cluster_maxpool_v2(x, w, s_in, b_in, s_act, b_act)
    want = dbof_cluster_maxpool_plain(x, w, s_in, b_in, s_act, b_act)
    check(bool(torch.all(want == 0)), "dbof hazard case: plain not all 0")
    check(bool(torch.all(got == 0)),
          "dbof: padded frame rows leaked into the max")

    args = dbof_inputs(torch, gen, BATCH, FRAMES, FEATURE_DIM, CLUSTERS,
                       torch.uint8, dev)
    got = dbof_cluster_maxpool_v2(*args)
    want = dbof_cluster_maxpool_plain(*args)
    torch.cuda.synchronize()
    err = rel_check("dbof_cluster_maxpool_v2", got, want)
    del want
    x, w, s_in, b_in, s_act, b_act = args

    def library():
        xa = (x.to(torch.float32) * s_in + b_in).to(torch.bfloat16)
        act = torch.matmul(xa, w).to(torch.float32)
        return torch.amax(torch.relu(act * s_act + b_act), dim=1)

    ms = time_ms(torch, lambda: dbof_cluster_maxpool_v2(*args), 10, flush)
    plain_ms = time_ms(torch, lambda: dbof_cluster_maxpool_plain(*args), 3,
                       flush)
    library_ms = time_ms(torch, library, 5, flush)
    flops = 2.0 * BATCH * FRAMES * FEATURE_DIM * CLUSTERS
    nbytes = (BATCH * FRAMES * FEATURE_DIM + FEATURE_DIM * CLUSTERS * 2
              + 4 * (2 * FEATURE_DIM + 2 * CLUSTERS) + BATCH * CLUSTERS * 4)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    return {
        "name": "dbof_cluster_maxpool_v2", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/dbof.cu",
        "replaces": "yt8m_tpu/kernels/dbof.py:177",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def moe_inputs(torch, gen, b, h, c, m, dev):
    x = torch.randn(b, h, generator=gen).abs()
    wg = (torch.randn(h, c * (m + 1), generator=gen) * h ** -0.5)
    we = (torch.randn(h, c * m, generator=gen) * h ** -0.5)
    be = 0.1 * torch.randn(c * m, generator=gen)
    return [x.to(dev), wg.to(torch.bfloat16).to(dev),
            we.to(torch.bfloat16).to(dev), be.to(dev)]


def moe_at(torch, gen, dev, flush, b, h) -> dict:
    """moe_head_serving against its plain version at [B, H] -> [B, 4716]
    (M=2): the error, times and bound of one serving shape."""
    from yt8m_tpu_torch.kernels.moe_head import (
        moe_head_plain,
        moe_head_serving,
    )

    args = moe_inputs(torch, gen, b, h, CLASSES, MIXTURES, dev)
    got = moe_head_serving(*args, MIXTURES)
    want = moe_head_plain(*args, MIXTURES)
    torch.cuda.synchronize()
    err = rel_check(f"moe_head_serving B={b} H={h}", got, want)
    x, wg, we, be = args

    def library():
        xa = x.to(torch.bfloat16)
        g = torch.matmul(xa, wg).to(torch.float32)
        e = torch.matmul(xa, we).to(torch.float32) + be
        gating = torch.softmax(g.reshape(b, CLASSES, MIXTURES + 1), -1)
        experts = torch.sigmoid(e.reshape(b, CLASSES, MIXTURES))
        return torch.sum(gating[..., :MIXTURES] * experts, -1)

    ms = time_ms(torch, lambda: moe_head_serving(*args, MIXTURES), 10, flush)
    plain_ms = time_ms(torch, lambda: moe_head_plain(*args, MIXTURES), 5,
                       flush)
    library_ms = time_ms(torch, library, 5, flush)
    cols = CLASSES * (2 * MIXTURES + 1)
    flops = 2.0 * b * h * cols
    nbytes = (b * h * 4 + h * cols * 2 + CLASSES * MIXTURES * 4
              + b * CLASSES * 4)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    return {
        "name": "moe_head_serving", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/moe_head.cu",
        "replaces": "yt8m_tpu/kernels/moe_head.py:88",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def say_row(shape: str, row: dict) -> None:
    say("kernel", f"{row['name']} {shape}: ok, max|diff| "
                  f"{row['max_abs_err']:.3e}; {row['ms']:.4f} ms (plain "
                  f"{row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
                  f"bound {row['bound_ms']:.4f} by {row['bound_by']})")


def check_moe(torch, gen, dev, flush) -> dict:
    """Edge cases, then both serving shapes: DbofModel's (B=2048, H=1024)
    is printed; the flagship's (B=512, H = VLAD hidden + LSTM cells =
    2048), whose path the kernels line takes the launches from, is the
    row."""
    from yt8m_tpu_torch.kernels.moe_head import (
        moe_head_plain,
        moe_head_serving,
    )

    for b, h, c, m in ((37, 64, 83, 1), (70, 96, 45, 2), (5, 32, 33, 4),
                       (E2E_BATCH, VLAD_HIDDEN + LSTM_CELLS, CLASSES,
                        MIXTURES)):
        args = moe_inputs(torch, gen, b, h, c, m, dev)
        rel_check(f"moe edge B={b} H={h} C={c} M={m}",
                  moe_head_serving(*args, m), moe_head_plain(*args, m))
    # Logits far outside [-80, 80]: the clamp must keep every ratio finite.
    x, wg, we, be = moe_inputs(torch, gen, 16, 64, 40, 2, dev)
    wg = (wg.to(torch.float32) * 400).to(torch.bfloat16)
    got = moe_head_serving(x, wg, we, be, 2)
    check(bool(torch.isfinite(got).all()), "moe: non-finite with big logits")
    rel_check("moe clamp case", got, moe_head_plain(x, wg, we, be, 2))

    say_row(f"DbofModel B={BATCH} H={HIDDEN}",
            moe_at(torch, gen, dev, flush, BATCH, HIDDEN))
    return moe_at(torch, gen, dev, flush, FLAG_BATCH,
                  VLAD_HIDDEN + LSTM_CELLS)


def topk_at(torch, gen, dev, flush, b) -> dict:
    """exact_topk against its plain version on [B, 4716] scores with NaN,
    -inf, ties and -3.4e38 rows planted: equality, times, bound."""
    from yt8m_tpu_torch.kernels.topk import exact_topk, exact_topk_plain

    x = torch.rand(b, CLASSES, generator=gen)
    x[0] = torch.repeat_interleave(torch.rand(CLASSES // 3 + 1,
                                              generator=gen), 3)[:CLASSES]
    x[1, ::7] = float("nan")
    x[1, 5] = float("nan")
    x[2, ::3] = float("-inf")
    x[3] = -3.4e38
    x[3, 100:110] = float("nan")
    x[4] = 0.25
    x[5, :30] = float("-inf")
    x[5, 30:] = -3.0e38
    x = x.to(dev)
    gv, gi = exact_topk(x, TOP_K)
    pv, pi = exact_topk_plain(x, TOP_K)
    torch.cuda.synchronize()
    check(torch.equal(gv, pv), f"exact_topk B={b} values differ from plain")
    check(torch.equal(gi, pi), f"exact_topk B={b} indices differ from plain")
    check(int(gi.min()) >= 0 and int(gi.max()) < CLASSES,
          "exact_topk index out of range")
    ms = time_ms(torch, lambda: exact_topk(x, TOP_K), 20, flush)
    plain_ms = time_ms(torch, lambda: exact_topk_plain(x, TOP_K), 5, flush)
    library_ms = time_ms(torch, lambda: torch.topk(x, TOP_K, dim=1), 20,
                         flush)
    nbytes = b * CLASSES * 4 + b * TOP_K * 8
    bound_ms, bound_by = bound(b * CLASSES, nbytes, PEAK_F32_FLOPS)
    return {
        "name": "exact_topk", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/topk.cu",
        "replaces": "yt8m_tpu/kernels/topk.py:75",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_topk(torch, gen, dev, flush) -> dict:
    """Edge cases, then DbofModel's B=2048 (printed) and the flagship's
    B=512 (the row), as for the MoE head."""
    from yt8m_tpu_torch.kernels.topk import exact_topk, exact_topk_plain

    for b, c, k in ((3, 20, 20), (37, 301, 20), (5, 4716, 128), (8, 7, 1)):
        xs = torch.rand(b, c, generator=gen).to(dev)
        xs[0, : c // 2] = xs[0, 0]
        gv, gi = exact_topk(xs, k)
        pv, pi = exact_topk_plain(xs, k)
        check(torch.equal(gv, pv) and torch.equal(gi, pi),
              f"exact_topk edge B={b} C={c} k={k} differs from plain")
    say_row(f"DbofModel B={BATCH}", topk_at(torch, gen, dev, flush, BATCH))
    return topk_at(torch, gen, dev, flush, FLAG_BATCH)


def vlad_inputs(torch, gen, b, f, d, k, x_dtype, dev):
    """Frames, num_frames (with 0, 1 and f planted), bf16 Wc, the folded
    affine and the centers. The ragged and empty videos are the hazards."""
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=gen,
                          dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=gen)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    wc = (torch.randn(d, k, generator=gen) * d ** -0.5).to(torch.bfloat16)
    scale = 0.5 + torch.rand(k, generator=gen)
    bias = 0.3 * torch.randn(k, generator=gen)
    centers = torch.randn(k, d, generator=gen) * d ** -0.5
    return [t.to(dev) for t in (x, nf, wc, scale, bias, centers)]


def pad_hazard(torch, x, past, loud):
    """(clean, noisy): x with zeros, and with `loud`, where the boolean
    mask `past` over x's two leading dims marks what lies past
    num_frames."""
    past = past[..., None]
    loud = torch.as_tensor(loud, dtype=x.dtype, device=x.device)
    return x.masked_fill(past, 0), torch.where(past, loud, x)


def vlad_rounding_witness(torch, name, args) -> None:
    """Why the NetVLAD bound is 2^-8 and not 1e-3: the kernel and its
    plain version part only where the assignment rounds to bf16.
    (a) Where the kernel's bf16 assignment differs from bf16 of the plain
    f32 assignment, the two are one bf16 step apart and the plain f32
    value lies at the rounding boundary between them: the median distance
    to the midpoint is <= 2^-14 of the value, where a value at random
    lies ~2^-10 from it. (b) The plain residuals and norms on the
    kernel's own bf16 frames, assignment and column sums meet the 1e-3 *
    max|ref| + 1e-6 bound against the kernel's output."""
    from yt8m_tpu_torch.kernels.netvlad import (
        netvlad_aggregate_with_scratch,
        netvlad_assign_plain,
        netvlad_residuals_plain,
    )

    f = args[0].shape[1]
    out, xb, ka, colsum = netvlad_aggregate_with_scratch(*args)
    ka = ka[:, :f]
    _, pa = netvlad_assign_plain(*args[:5])
    differ = ka != pa.to(torch.bfloat16)
    n = int(differ.sum())
    kd = ka[differ].float()
    pd = pa[differ].to(torch.bfloat16).float()
    lo, hi = torch.minimum(kd, pd), torch.maximum(kd, pd)
    check(bool(torch.all((lo > 0) & (hi - lo <= 2.0 ** -7 * lo))),
          f"{name}: kernel and plain assignments more than one bf16 step "
          f"apart")
    dist = (pa[differ] - (lo + hi) / 2).abs() / hi
    med = dist.median().item() if n else 0.0
    check(med <= 2.0 ** -14,
          f"{name}: differing assignments not at a bf16 rounding boundary "
          f"(median distance {med:.3e} of the value)")
    del pa, differ
    tail = netvlad_residuals_plain(ka.float(), colsum.sum(1), xb.float(),
                                   args[5])
    err = rel_check(f"{name} on the kernel's own assignment", out, tail,
                    rel=1e-3, abs_=1e-6)
    say("kernel", f"{name} witness: {n} of {ka.numel()} bf16 assignments "
                  f"differ from plain's, each one bf16 step, the plain f32 "
                  f"value {med:.3e} (median; max "
                  f"{dist.max().item() if n else 0.0:.3e}) of itself from "
                  f"the rounding midpoint; plain residuals and norms on "
                  f"the kernel's assignment: max|diff| {err:.3e} (1e-3 "
                  f"bound {1e-3 * tail.abs().max().item() + 1e-6:.3e})")


def check_netvlad(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.netvlad import (
        netvlad_aggregate,
        netvlad_aggregate_plain,
    )

    for b, f, d, k, dt in ((5, 13, 128, 8, torch.uint8),
                           (4, 70, 256, 136, torch.float32),
                           (2, 1, 128, 64, torch.uint8)):
        args = vlad_inputs(torch, gen, b, f, d, k, dt, dev)
        rel_check(f"netvlad edge B={b} F={f} D={d} K={k} {dt}",
                  netvlad_aggregate(*args), netvlad_aggregate_plain(*args),
                  rel=VLAD_REL, abs_=1e-6)
    shape = (FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM, VLAD_CLUSTERS)
    errs, times = {}, {}
    for dt, loud in ((torch.uint8, 255), (torch.float32, 1e4)):
        x, nf, wc, scale, bias, centers = vlad_inputs(torch, gen, *shape, dt,
                                                      dev)
        bias[7] = -1e4  # cluster 7: assignment exactly 0 for every frame
        past = (torch.arange(FLAG_FRAMES, device=dev)[None, :]
                >= nf[:, None])
        clean, x = pad_hazard(torch, x, past, loud)
        args = (x, nf, wc, scale, bias, centers)
        got = netvlad_aggregate(*args)
        check(torch.equal(got, netvlad_aggregate(clean, *args[1:])),
              f"netvlad {dt}: frames past num_frames leaked")
        check(bool(torch.isfinite(got).all()), f"netvlad {dt}: non-finite")
        check(bool(torch.all(got[1] == 0)),
              f"netvlad {dt}: num_frames=0 is not exact zeros")
        check(bool(torch.all(got[:, 7] == 0)),
              f"netvlad {dt}: an unassigned cluster is not a zero row")
        want = netvlad_aggregate_plain(*args)
        torch.cuda.synchronize()
        errs[dt] = rel_check(f"netvlad_aggregate {dt}", got, want,
                             rel=VLAD_REL, abs_=1e-6)
        del got, want, clean
        vlad_rounding_witness(torch, f"netvlad_aggregate {dt}", args)
        times[dt] = time_ms(torch, lambda: netvlad_aggregate(*args), 10,
                            flush)
    # The flagship feeds float32 frames: time and bound that case.
    plain_ms = time_ms(torch, lambda: netvlad_aggregate_plain(*args), 3, flush)

    def library():
        xb = x.to(torch.bfloat16)
        act = torch.matmul(xb, wc).to(torch.float32) * scale + bias
        mask = (torch.arange(FLAG_FRAMES, device=dev)[None, :]
                < nf[:, None])[:, :, None]
        a = torch.softmax(act, -1) * mask
        vlad = torch.matmul(a.to(torch.bfloat16).transpose(1, 2),
                            xb).to(torch.float32)
        vlad = vlad - a.sum(1)[:, :, None] * centers
        vlad = torch.nn.functional.normalize(vlad, dim=2, eps=1e-6)
        return torch.nn.functional.normalize(vlad.flatten(1), dim=1,
                                             eps=1e-6)

    library_ms = time_ms(torch, library, 5, flush)
    b, f, d, k = shape

    def vlad_bound(frames, frame_bytes):
        """Both products over `frames` real frames (those past num_frames
        need neither work nor reading), the f32 output, the weights."""
        flops = 4.0 * frames * d * k
        nbytes = (frames * d * frame_bytes + b * k * d * 4 + d * k * 2
                  + k * d * 4 + 8 * k + 4 * b)
        return bound(flops, nbytes, PEAK_BF16_FLOPS)

    real = int(nf.sum())  # this run's frames to aggregate
    bound_ms, bound_by = vlad_bound(real, 4)
    say("kernel", f"netvlad_aggregate bounds: {bound_ms:.4f} ms by "
                  f"{bound_by} for this run's {real} real frames (f32); "
                  f"{vlad_bound(b * f, 4)[0]:.4f} ms for all {b * f} "
                  f"(f32), {vlad_bound(b * f, 1)[0]:.4f} ms (uint8)")
    say("kernel", f"netvlad_aggregate uint8 frames: {times[torch.uint8]:.4f}"
                  f" ms, max|diff| {errs[torch.uint8]:.3e}")
    return {
        "name": "netvlad_aggregate", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/netvlad.cu",
        "replaces": "yt8m_tpu/kernels/netvlad.py:91",
        "max_abs_err": max(errs.values()), "ms": times[torch.float32],
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def lstm_inputs(torch, gen, f, b, h, dev):
    xp = (0.5 * torch.randn(f, b, 4 * h, generator=gen)).to(torch.bfloat16)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    wh = (torch.randn(h, 4 * h, generator=gen) * h ** -0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(4 * h, generator=gen)
    return [t.to(dev) for t in (xp, nf, wh, bias)]


def lstm_check(torch, name, got, want) -> float:
    err = 0.0
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        e = (g - w).abs().max().item()
        bound_ = LSTM_TOL * max(1.0, w.abs().max().item())
        check(math.isfinite(e) and e <= bound_,
              f"{name}: max|diff| {e:.3e} > {bound_:.3e}")
        err = max(err, e)
    return err


def check_lstm(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.lstm import (
        lstm_recurrence,
        lstm_recurrence_plain,
    )

    for f, b, h in ((13, 5, 64), (40, 130, 192), (1, 1, 64)):
        for rev in (False, True):
            args = lstm_inputs(torch, gen, f, b, h, dev)
            lstm_check(torch, f"lstm edge F={f} B={b} H={h} reverse={rev}",
                       lstm_recurrence(*args, reverse=rev),
                       lstm_recurrence_plain(*args, reverse=rev))
    err = 0.0
    for rev in (False, True):
        xp, nf, wh, bias = lstm_inputs(torch, gen, FLAG_FRAMES, FLAG_BATCH,
                                       LSTM_CELLS, dev)
        sign = torch.where(torch.arange(4 * LSTM_CELLS, device=dev) % 2 == 0,
                           1e4, -1e4).to(torch.bfloat16)
        # x_proj is time-major, and flipped in time when reversed
        past = (torch.arange(FLAG_FRAMES, device=dev)[:, None]
                >= nf[None, :])
        clean, xp = pad_hazard(torch, xp, past.flip(0) if rev else past,
                               sign)
        got = lstm_recurrence(xp, nf, wh, bias, reverse=rev)
        ref = lstm_recurrence(clean, nf, wh, bias, reverse=rev)
        check(all(torch.equal(a, c) for a, c in
                  zip((got[0], *got[1]), (ref[0], *ref[1]))),
              f"lstm reverse={rev}: steps past num_frames moved the carry")
        check(bool(torch.all(got[0][:, 1] == 0))
              and bool(torch.all(got[1][0][1] == 0)),
              f"lstm reverse={rev}: num_frames=0 moved the carry")
        want = lstm_recurrence_plain(xp, nf, wh, bias, reverse=rev)
        torch.cuda.synchronize()
        err = max(err, lstm_check(torch, f"lstm_recurrence reverse={rev}",
                                  got, want))
        del got, ref, want, clean
    args = (xp, nf, wh, bias)
    ms = time_ms(torch, lambda: lstm_recurrence(*args), 5, flush)
    plain_ms = time_ms(torch, lambda: lstm_recurrence_plain(*args), 2, flush)

    # Yardstick: one cuDNN LSTM layer over the packed sequence, the input
    # projection included (gates reordered to i, f, g, o; the forget bias
    # folded into bias_hh). The port's equivalent is the bf16 input
    # projection (torch.matmul) plus this kernel.
    d, h = FEATURE_DIM, LSTM_CELLS
    frames = torch.randn(FLAG_FRAMES, FLAG_BATCH, d, device=dev,
                         dtype=torch.bfloat16)
    wx = (torch.randn(d, 4 * h, device=dev) * d ** -0.5).to(torch.bfloat16)
    order = torch.cat([torch.arange(0, h), torch.arange(2 * h, 3 * h),
                       torch.arange(h, 2 * h), torch.arange(3 * h, 4 * h)])
    cudnn = torch.nn.LSTM(d, h, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(wx.t()[order.to(dev)])
        cudnn.weight_hh_l0.copy_(wh.t()[order.to(dev)])
        cudnn.bias_ih_l0.copy_(bias[order.to(dev)])
        cudnn.bias_hh_l0.copy_(torch.cat([torch.zeros(h), torch.ones(h),
                                          torch.zeros(2 * h)]).to(dev))
    cudnn.flatten_parameters()
    lengths = torch.clamp(nf, min=1).cpu()

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            frames, lengths, enforce_sorted=False)
        with torch.no_grad():
            return cudnn(packed)

    def port_with_projection():
        xpp = torch.matmul(frames, wx)
        return lstm_recurrence(xpp, nf, wh, bias)

    library_ms = time_ms(torch, library, 5, flush)
    port_ms = time_ms(torch, port_with_projection, 5, flush)
    say("kernel", f"lstm: input projection + kernel {port_ms:.4f} ms vs one "
                  f"cuDNN LSTM layer (projection included) {library_ms:.4f}"
                  f" ms")
    # What the launch per step costs: the call's time on the card against
    # the time its step kernels ran (torch.profiler).
    busy_us = device_us(torch, lambda: lstm_recurrence(*args), "lstm_step")
    say("kernel", f"lstm: {FLAG_FRAMES} step launches per call, "
                  f"{ms / FLAG_FRAMES * 1e3:.2f} us a step, of which the "
                  f"step kernel runs {busy_us / FLAG_FRAMES:.2f} us; "
                  f"{ms / FLAG_FRAMES * 1e3 - busy_us / FLAG_FRAMES:.2f} us "
                  f"a step between launches")
    f, b = FLAG_FRAMES, FLAG_BATCH

    def lstm_bound(steps):
        """The h @ W_h products and the X' reads of `steps` live (video,
        step) pairs (a frozen step needs neither), every output written,
        W_h, bias and the final state."""
        flops = 2.0 * steps * h * 4 * h
        nbytes = (steps * 4 * h * 2 + f * b * h * 2 + h * 4 * h * 2
                  + 4 * h * 4 + 4 * b + 2 * b * h * 4)
        return bound(flops, nbytes, PEAK_BF16_FLOPS)

    live = int(nf.sum())  # this run's live (video, step) pairs
    bound_ms, bound_by = lstm_bound(live)
    say("kernel", f"lstm_recurrence bounds: {bound_ms:.4f} ms by {bound_by} "
                  f"for this run's {live} live steps; "
                  f"{lstm_bound(b * f)[0]:.4f} ms for all {b * f}")
    return {
        "name": "lstm_recurrence", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/lstm.cu",
        "replaces": "yt8m_tpu/kernels/lstm.py:103",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_repaired_shapes(torch, gen, dev) -> None:
    """Shapes each kernel took only on the CPU before: MoE with 3, 8 and
    16 mixtures, DBoF over 64 frames, NetVLAD with K=100, K=512 and
    D=1000, the LSTM with H=96. Each runs its kernel (its launch count
    moves) and meets its plain version at its tolerance. Top-k above the
    kernel's k <= 128: exact_topk raises, serving_topk takes its library
    op (a stable sort) and launches nothing."""
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool_plain,
        dbof_cluster_maxpool_v2,
    )
    from yt8m_tpu_torch.kernels.lstm import (
        lstm_recurrence,
        lstm_recurrence_plain,
    )
    from yt8m_tpu_torch.kernels.moe_head import (
        moe_head_plain,
        moe_head_serving,
    )
    from yt8m_tpu_torch.kernels.netvlad import (
        netvlad_aggregate,
        netvlad_aggregate_plain,
    )
    from yt8m_tpu_torch.kernels.topk import (
        exact_topk,
        exact_topk_plain,
        serving_topk,
    )

    def launched(fn, call, n=1):
        before = fn.launches
        out = call()
        check(fn.launches == before + n, f"{fn.__name__} did not launch")
        return out

    x = torch.rand(E2E_BATCH, CLASSES, generator=gen).to(dev)
    try:
        exact_topk(x, 129)
        raised = False
    except ValueError:
        raised = True
    check(raised, "exact_topk did not refuse k=129")
    before = exact_topk.launches
    got = serving_topk(x, 200)
    want = exact_topk_plain(x.cpu(), 200)
    check(exact_topk.launches == before
          and all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
          "serving_topk k=200 differs from the stable sort or launched")
    say("repair", "exact_topk k=129 raises; serving_topk k=200 [128, 4716] "
                  "equals the stable sort, no launch")
    for m in (3, 8, 16):
        args = moe_inputs(torch, gen, E2E_BATCH, HIDDEN, CLASSES, m, dev)
        err = rel_check(f"moe M={m}", launched(
            moe_head_serving, lambda: moe_head_serving(*args, m)),
            moe_head_plain(*args, m))
        say("repair", f"moe_head_serving M={m} [128, 1024] -> 4716: "
                      f"max|diff| {err:.3e}")
    args = dbof_inputs(torch, gen, 64, 64, FEATURE_DIM, CLUSTERS,
                       torch.uint8, dev)
    err = rel_check("dbof 64 frames", launched(
        dbof_cluster_maxpool_v2, lambda: dbof_cluster_maxpool_v2(*args), 2),
        dbof_cluster_maxpool_plain(*args))
    say("repair", f"dbof_cluster_maxpool_v2 iterations=64 (2 launches): "
                  f"max|diff| {err:.3e}")
    for d, k in ((FEATURE_DIM, 100), (FEATURE_DIM, 512), (1000, 256)):
        for dt in (torch.uint8, torch.float32):
            args = vlad_inputs(torch, gen, 16, FLAG_FRAMES, d, k, dt, dev)
            got = launched(netvlad_aggregate, lambda: netvlad_aggregate(*args))
            check(got.shape == (16, k, d) and bool(torch.all(got[1] == 0)),
                  f"netvlad D={d} K={k}: shape or empty video")
            err = rel_check(f"netvlad D={d} K={k} {dt}", got,
                            netvlad_aggregate_plain(*args), rel=VLAD_REL,
                            abs_=1e-6)
            say("repair", f"netvlad_aggregate D={d} K={k} {dt}: max|diff| "
                          f"{err:.3e}")
    for rev in (False, True):
        args = lstm_inputs(torch, gen, FLAG_FRAMES, 128, 96, dev)
        err = lstm_check(torch, f"lstm H=96 reverse={rev}", launched(
            lstm_recurrence, lambda: lstm_recurrence(*args, reverse=rev)),
            lstm_recurrence_plain(*args, reverse=rev))
        say("repair", f"lstm_recurrence H=96 reverse={rev}: max|diff| "
                      f"{err:.3e}")


def lstm_witness(torch, name, args, reverse) -> None:
    """Why the LSTM bounds are 2e-2 and not 1e-3. Fed each kernel's own
    bf16 stream one step at a time, the plain cell rounds to the kernel's
    value except where the plain f32 value sits at a bf16 rounding
    boundary (median distance from the midpoint <= 2^-14 of the value),
    what one bf16 step does not explain is <= 1e-3 * max|ref| (values
    more than one step apart are counted, not refused), and the f32
    final state meets 1e-3 * max|ref| + 1e-6: the serving forward's h,
    the trainable forward's h, gates and c_t, and the backward's dZ."""
    from yt8m_tpu_torch.kernels import lstm_train as tlt
    from yt8m_tpu_torch.kernels.lstm import lstm_recurrence

    xp, nf, wh, bias = args

    def report(stream, kernel, plain):
        r = tlt.rounding_report(kernel, plain)
        check(r.median <= 2.0 ** -14 and r.excess <= 1e-3,
              f"{name} {stream}: {r.n} values differ, median distance "
              f"{r.median:.3e}, remainder beyond one bf16 step "
              f"{r.excess:.3e}")
        say("witness", f"{name} reverse={reverse} {stream}: {r.n} of "
                       f"{kernel.numel()} bf16 values differ from the plain "
                       f"cell on the kernel's stream, plain value "
                       f"{r.median:.3e} (median) of itself from the "
                       f"rounding midpoint; {r.n_far} more than one bf16 "
                       f"step apart (up to {r.far_steps} steps, |value| up "
                       f"to {r.far_value:.3e} of max|ref|); remainder beyond"
                       f" one bf16 step {r.excess:.3e} of max|ref| (bound "
                       f"1e-3)")

    def final_state(kind, got, want):
        for g, w, what in zip(got, want, ("c", "h")):
            err = rel_check(f"{name} {kind} final {what}", g, w, rel=1e-3,
                            abs_=1e-6)
            say("witness", f"{name} reverse={reverse} {kind} final {what}: "
                           f"max|diff| {err:.3e} (1e-3 bound "
                           f"{1e-3 * w.abs().max().item() + 1e-6:.3e})")

    outs, state = lstm_recurrence(xp, nf, wh, bias, reverse=reverse)
    outs = outs.to(torch.bfloat16)
    hs, _, _, plain_state = tlt.forward_on_stream(outs, xp, nf, wh, bias,
                                                  reverse)
    report("serving h", outs, hs)
    final_state("serving", state, plain_state)
    del outs, hs
    outs, gates, cs, c, h = tlt.lstm_train_forward(xp, nf, wh, bias, reverse)
    hs, gs, cc, plain_state = tlt.forward_on_stream(outs, xp, nf, wh, bias,
                                                    reverse)
    report("trainable h", outs, hs)
    report("trainable gates", gates, gs)
    report("trainable c_t", cs, cc)
    final_state("trainable", (c, h), plain_state)
    del hs, gs, cc
    g = torch.Generator(device=xp.device).manual_seed(5)
    f, b, hd = outs.shape
    cot = [torch.randn(shape, generator=g, device=xp.device)
           for shape in ((f, b, hd), (b, hd), (b, hd))]
    dz = tlt.lstm_train_backward(*cot, gates, cs, nf, wh, reverse)
    report("backward dZ", dz, tlt.backward_on_stream(dz, *cot, gates, cs, nf,
                                                     wh, reverse))


def device_us(torch, fn, needle: str) -> float:
    """Device time (us) of the kernels whose name holds `needle` in one
    call of fn (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if needle in e.key)


def check_lstm_train(torch, gen, dev, flush) -> dict:
    """lstm_recurrence_trainable at the flagship's training shape (B=256,
    F=300, H=1024), both directions: the CUDA forward's outputs, final
    state and residuals and the CUDA backward's dZ against the plain
    versions on the same inputs; the Function's dx_proj, dW_h and db
    against the plain forward, backward and weight gradients for fixed
    random cotangents; planted hazards; the witness; times and bounds."""
    from yt8m_tpu_torch.kernels import lstm_train as tlt

    f, b, h = FLAG_FRAMES, TRAIN_BATCH, LSTM_CELLS

    def grads(args, cot, rev):
        xp, nf, wh, bias = args
        x = xp.clone().requires_grad_()
        w = wh.float().requires_grad_()
        bb = bias.clone().requires_grad_()
        outs, (fc, fh) = tlt.lstm_recurrence_trainable(x, nf, w, bb, rev)
        loss = sum((o * c).sum() for o, c in zip((outs, fc, fh), cot))
        loss.backward()
        return outs.detach(), fc.detach(), fh.detach(), x.grad, w.grad, bb.grad

    def plain_grads(args, cot, rev):
        xp, nf, wh, bias = args
        outs, gates, cs, c, hh = tlt.lstm_train_forward_plain(xp, nf, wh,
                                                             bias, rev)
        dz = tlt.lstm_train_backward_plain(*cot, gates, cs, nf, wh, rev)
        dwh, db = tlt.weight_grads(outs, dz)
        return outs.float(), c, hh, dz.float(), dwh, db

    err = 0.0
    names = ("outputs", "final c", "final h", "dx_proj", "dW_h", "db")
    for rev in (False, True):
        args = lstm_inputs(torch, gen, f, b, h, dev)
        xp, nf, wh, bias = args
        got = tlt.lstm_train_forward(*args, rev)
        want = tlt.lstm_train_forward_plain(*args, rev)
        for nm, g, w in zip(("outputs", "gates", "c_t", "final c", "final h"),
                            got, want):
            err = max(err, lstm_check(torch, f"trainable {nm} reverse={rev}",
                                      (g.float(), ()), (w.float(), ())))
        del want
        g = torch.Generator().manual_seed(11 + rev)
        cot = [t.to(dev) for t in (torch.randn(f, b, h, generator=g),
                                   torch.randn(b, h, generator=g),
                                   torch.randn(b, h, generator=g))]
        dz = tlt.lstm_train_backward(*cot, got[1], got[2], nf, wh, rev)
        err = max(err, lstm_check(
            torch, f"trainable dZ reverse={rev}", (dz.float(), ()),
            (tlt.lstm_train_backward_plain(*cot, got[1], got[2], nf, wh,
                                           rev).float(), ())))
        del got, dz
        kg = grads(args, cot, rev)
        pg = plain_grads(args, cot, rev)
        for nm, a, c in zip(names, kg, pg):
            check(bool(torch.isfinite(a).all()), f"trainable {nm}: non-finite")
            err = max(err, lstm_check(torch, f"trainable {nm} reverse={rev}",
                                      (a, ()), (c, ())))
        del kg, pg
        # Hazards: ±1e4 past num_frames leaves outputs and every gradient
        # bit for bit those of zeros there; dZ is exactly 0 on frozen steps.
        past = torch.arange(f, device=dev)[:, None] >= nf[None, :]
        if rev:
            past = past.flip(0)
        sign = torch.where(torch.arange(4 * h, device=dev) % 2 == 0, 1e4,
                           -1e4).to(torch.bfloat16)
        clean, loud = pad_hazard(torch, xp, past, sign)
        a = grads((clean, nf, wh, bias), cot, rev)
        c = grads((loud, nf, wh, bias), cot, rev)
        check(all(torch.equal(x, y) for x, y in zip(a, c)),
              f"trainable reverse={rev}: steps past num_frames moved "
              f"the outputs or the gradients")
        check(bool(torch.all(c[3][past] == 0)),
              f"trainable reverse={rev}: dZ not 0 on frozen steps")
        del a, c, clean, loud
        say("kernel", f"lstm_recurrence_trainable reverse={rev}: forward, "
                      f"residuals, dZ, dx_proj, dW_h, db within "
                      f"{LSTM_TOL} * max(1, max|ref|); hazards bit-identical")
        lstm_witness(torch, "lstm", args, rev)
    torch.cuda.empty_cache()

    xp, nf, wh, bias = args
    fwd = tlt.lstm_train_forward(xp, nf, wh, bias)
    cot = [torch.randn_like(t) for t in (fwd[0].float(), fwd[3], fwd[4])]
    ms_f = time_ms(torch, lambda: tlt.lstm_train_forward(xp, nf, wh, bias),
                   5, flush)
    ms_b = time_ms(torch, lambda: tlt.lstm_train_backward(
        *cot, fwd[1], fwd[2], nf, wh), 5, flush)
    us_f = device_us(torch, lambda: tlt.lstm_train_forward(xp, nf, wh, bias),
                     "lstm_step_kernel")
    us_b = device_us(torch, lambda: tlt.lstm_train_backward(
        *cot, fwd[1], fwd[2], nf, wh), "lstm_bptt_step_kernel")
    plain_f = time_ms(torch, lambda: tlt.lstm_train_forward_plain(
        xp, nf, wh, bias), 2, flush)
    plain_b = time_ms(torch, lambda: tlt.lstm_train_backward_plain(
        *cot, fwd[1], fwd[2], nf, wh), 2, flush)
    dz = tlt.lstm_train_backward(*cot, fwd[1], fwd[2], nf, wh)
    dw_ms = time_ms(torch, lambda: tlt.weight_grads(fwd[0], dz), 5, flush)

    # Yardstick: one cuDNN LSTM layer's forward and backward over the
    # packed sequence, the input projection included (gates reordered to
    # i, f, g, o; the forget bias in bias_hh), timed and never called by
    # the port.
    d = FEATURE_DIM
    frames = torch.randn(f, b, d, device=dev, dtype=torch.bfloat16)
    wx = (torch.randn(d, 4 * h, device=dev) * d ** -0.5).to(torch.bfloat16)
    order = torch.cat([torch.arange(0, h), torch.arange(2 * h, 3 * h),
                       torch.arange(h, 2 * h),
                       torch.arange(3 * h, 4 * h)]).to(dev)
    cudnn = torch.nn.LSTM(d, h, device=dev, dtype=torch.bfloat16)
    with torch.no_grad():
        cudnn.weight_ih_l0.copy_(wx.t()[order])
        cudnn.weight_hh_l0.copy_(wh.t()[order])
        cudnn.bias_ih_l0.copy_(bias[order])
        cudnn.bias_hh_l0.copy_(torch.cat([torch.zeros(h), torch.ones(h),
                                          torch.zeros(2 * h)]).to(dev))
    cudnn.flatten_parameters()
    lengths = torch.clamp(nf, min=1).cpu()

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            frames, lengths, enforce_sorted=False)
        out, _ = cudnn(packed)
        out.data.float().sum().backward()

    library_ms = time_ms(torch, library, 5, flush)
    live = int(nf.sum())  # this run's live (video, step) pairs
    g4 = 4 * h
    # Forward: the products and X' reads of live steps; outputs, gates and
    # c_t written for every step; W_h, bias, final state.
    f_flops = 2.0 * live * h * g4
    f_bytes = (live * g4 * 2 + f * b * (h + g4 + h) * 2 + h * g4 * 2
               + g4 * 4 + 4 * b + 2 * b * h * 4)
    # Backward: the products of live steps; dout, gates, c_t read, dZ
    # written for every step; W_h, the seeds.
    b_bytes = (f * b * (h + g4 + h) * 2 + f * b * g4 * 2 + h * g4 * 2
               + 4 * b + 2 * b * h * 4)
    bound_f = bound(f_flops, f_bytes, PEAK_BF16_FLOPS)
    bound_b = bound(f_flops, b_bytes, PEAK_BF16_FLOPS)
    bound_ms, bound_by = bound(2 * f_flops, f_bytes + b_bytes,
                               PEAK_BF16_FLOPS)
    say("kernel", f"lstm_recurrence_trainable B={b} F={f} H={h}: forward "
                  f"{ms_f:.3f} ms a call (profiler: {us_f / 1e3:.3f} ms of "
                  f"kernel, {us_f / f:.2f} us a step), backward {ms_b:.3f} "
                  f"ms a call ({us_b / 1e3:.3f} ms, {us_b / f:.2f} us a "
                  f"step); bounds {bound_f[0]:.4f} and "
                  f"{bound_b[0]:.4f} ms by {bound_f[1]} for this run's "
                  f"{live} live steps; plain {plain_f:.3f} + {plain_b:.3f} "
                  f"ms; dW_h + db outside the kernel {dw_ms:.3f} ms; one "
                  f"cuDNN LSTM layer forward + backward (projection "
                  f"included) {library_ms:.3f} ms")
    del fwd, dz, frames, cudnn
    return {
        "name": "lstm_recurrence_trainable", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/lstm_train.cu",
        "replaces": "yt8m_tpu/kernels/lstm_train.py:346",
        "max_abs_err": err, "ms": ms_f + ms_b, "plain_ms": plain_f + plain_b,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_forward": ms_f, "ms_backward": ms_b,
        "us_per_step_forward": us_f / f, "us_per_step_backward": us_b / f,
    }


# ---------------------------------------------------------------------------
# phase 4: serving end to end, DbofModel and the flagship
# ---------------------------------------------------------------------------


def make_model(torch, seed: int):
    from yt8m_tpu_torch.models import ModelHParams, get_model

    hp = ModelHParams(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=300,
        dbof_cluster_size=CLUSTERS, dbof_hidden_size=HIDDEN,
        iterations=FRAMES, moe_num_mixtures=MIXTURES,
        compute_dtype="bfloat16",
    )
    model = get_model("DbofModel", hp)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        # Non-trivial BatchNorm statistics and affines.
        for name, n in (("input_bn", FEATURE_DIM), ("cluster_bn", CLUSTERS)):
            getattr(model, f"{name}_mean").copy_(
                0.5 * torch.randn(n, generator=gen))
            getattr(model, f"{name}_var").copy_(
                0.5 + torch.rand(n, generator=gen))
            getattr(model, f"{name}_scale").copy_(
                0.5 + torch.rand(n, generator=gen))
            getattr(model, f"{name}_bias").copy_(
                0.1 * torch.randn(n, generator=gen))
        bn = model.hidden_bn
        bn.mean.copy_(0.5 * torch.randn(HIDDEN, generator=gen))
        bn.var.copy_(0.5 + torch.rand(HIDDEN, generator=gen))
        bn.scale.copy_(0.5 + torch.rand(HIDDEN, generator=gen))
        bn.bias.copy_(0.1 * torch.randn(HIDDEN, generator=gen))
        model.video_classifier.experts_bias.copy_(
            0.1 * torch.randn(CLASSES * MIXTURES, generator=gen))
    model.invalidate_serving()
    return hp, model.eval()


def make_flagship_model(torch, seed: int):
    """NetVladLstmModel at the JAX package's default widths, weights from
    a seed, non-trivial BatchNorm statistics and biases."""
    from yt8m_tpu_torch.models import ModelHParams, get_model

    hp = ModelHParams(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=FLAG_FRAMES,
        netvlad_cluster_size=VLAD_CLUSTERS, netvlad_hidden_size=VLAD_HIDDEN,
        netvlad_add_batch_norm=True, netvlad_gating=True,
        lstm_cells=LSTM_CELLS, lstm_layers=LSTM_LAYERS, lstm_pooling="last",
        moe_num_mixtures=MIXTURES, compute_dtype="bfloat16",
    )
    model = get_model("NetVladLstmModel", hp)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(
                model.named_buffers()):
            if t.dim() != 1:
                continue
            n = t.shape[0]
            if name.endswith(("mean",)):
                t.copy_(0.5 * torch.randn(n, generator=gen))
            elif name.endswith(("var", "scale")):
                t.copy_(0.5 + torch.rand(n, generator=gen))
            else:  # BN shifts, LSTM and expert biases
                t.copy_(0.1 * torch.randn(n, generator=gen))
    model.invalidate_serving()
    return hp, model.eval()


PATHS = {
    "DbofModel": (make_model, ("dbof_cluster_maxpool_v2",
                               "moe_head_serving", "exact_topk")),
    "NetVladLstmModel": (make_flagship_model, ("netvlad_aggregate",
                                               "lstm_recurrence",
                                               "moe_head_serving",
                                               "exact_topk")),
}


def kernel_wrappers():
    from yt8m_tpu_torch.kernels.dbof import dbof_cluster_maxpool_v2
    from yt8m_tpu_torch.kernels.lstm import lstm_recurrence
    from yt8m_tpu_torch.kernels.lstm_train import (
        lstm_train_backward,
        lstm_train_forward,
    )
    from yt8m_tpu_torch.kernels.moe_head import moe_head_serving
    from yt8m_tpu_torch.kernels.netvlad import netvlad_aggregate
    from yt8m_tpu_torch.kernels.topk import exact_topk

    return {fn.__name__: fn for fn in (
        dbof_cluster_maxpool_v2, moe_head_serving, exact_topk,
        netvlad_aggregate, lstm_recurrence, lstm_train_forward,
        lstm_train_backward)}


def check_csv(path: str) -> int:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    check(rows[0] == ["VideoId", "LabelConfidencePairs"], "CSV header")
    ids = set()
    for vid, pairs in rows[1:]:
        ids.add(vid)
        toks = pairs.split()
        check(len(toks) == 2 * TOP_K, f"{vid}: {len(toks) // 2} pairs")
        classes = [int(t) for t in toks[0::2]]
        values = [float(t) for t in toks[1::2]]
        check(all(0 <= c < CLASSES for c in classes), f"{vid}: class range")
        check(len(set(classes)) == TOP_K, f"{vid}: repeated class")
        check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in values),
              f"{vid}: value not a finite probability")
        check(all(a >= b for a, b in zip(values, values[1:])),
              f"{vid}: values not descending")
    check(len(ids) == len(rows) - 1, "repeated video id")
    return len(rows) - 1


def compare_with_cpu(torch, model, make, data_pattern, dev) -> float:
    """Probabilities of 8 videos on the card vs the same model on the CPU
    (with the same sampled frames where the model samples)."""
    from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig

    rc = ReaderConfig("rgb,audio", "1024,128", frame_features=True,
                      num_classes=CLASSES)
    batch = next(iter(BatchIterator(data_pattern, rc, batch_size=8)))
    feats = torch.from_numpy(batch["features"])
    nf = torch.from_numpy(batch["num_frames"])
    u = torch.rand(8, FRAMES, generator=torch.Generator().manual_seed(7))
    cpu_model = make(torch, seed=0)[1]
    with torch.inference_mode():
        gpu = model(feats.to(dev), nf.to(dev), u=u.to(dev))["predictions"]
        cpu = cpu_model(feats, nf, u=u)["predictions"]
    del cpu_model
    gpu = gpu.cpu()
    err = (gpu - cpu).abs().max().item()
    check(err <= 2e-3, f"card vs CPU probabilities: max|diff| {err:.3e}")
    top = torch.sort(cpu, dim=1, descending=True).values
    for i in range(8):
        if top[i, TOP_K - 1] - top[i, TOP_K] > 2e-3:
            a = set(torch.topk(gpu[i], TOP_K).indices.tolist())
            b = set(torch.topk(cpu[i], TOP_K).indices.tolist())
            check(a == b, f"video {i}: top-{TOP_K} sets differ card vs CPU")
    return err


def end_to_end(torch, dev, data, model_name) -> dict:
    """The inference CLI over `data` with `model_name`, its launch counts
    set to 0 just before and read just after."""
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.convert import save_checkpoint

    make, names = PATHS[model_name]
    hp, model = make(torch, seed=0)
    run = os.path.join(os.path.dirname(data), f"run_{model_name}")
    save_checkpoint(run, model, model_name, hp, frame_features=True,
                    feature_names="rgb,audio", feature_sizes="1024,128",
                    num_classes=CLASSES, max_frames=300,
                    label_loss="CrossEntropyLoss")
    out_csv = os.path.join(os.path.dirname(data), f"{model_name}.csv")
    argv = [
        f"--input_data_pattern={data}/test-*.tfrecord",
        f"--train_dir={run}", f"--output_file={out_csv}",
        f"--batch_size={E2E_BATCH}", f"--top_k={TOP_K}",
        "--frame_features=true", "--feature_names=rgb,audio",
        "--feature_sizes=1024,128", f"--model={model_name}",
        f"--device={dev.type}",
    ]
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    stats = inference_cli.main(argv)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    say("e2e", f"{model_name} inference CLI: {stats['num_videos']} videos, "
               f"{stats['videos_per_sec']:.1f} videos/s (batch {E2E_BATCH}, "
               f"reader included); launches {launches}")
    for name in names:
        check(launches[name] > 0,
              f"{name} was not launched on the {model_name} path")
    check(stats["num_videos"] == E2E_VIDEOS, "video count")
    check(stats["nonfinite_predictions"] == 0, "non-finite predictions")
    check(check_csv(out_csv) == E2E_VIDEOS, "CSV line count")
    say("e2e", f"{model_name} CSV ok: {E2E_VIDEOS} lines of {TOP_K} pairs")
    err = compare_with_cpu(torch, model.to(dev), make,
                           f"{data}/test-*.tfrecord", dev)
    say("e2e", f"{model_name} 8 videos card vs CPU: max|diff| {err:.3e} "
               f"<= 2e-3")
    del model
    shutil.rmtree(run, ignore_errors=True)
    return {"launches": {n: launches[n] for n in names},
            "videos_per_sec": stats["videos_per_sec"]}


# ---------------------------------------------------------------------------
# phase 5: the device serving step alone, and where its time goes
# ---------------------------------------------------------------------------


def profile_step(torch, dev, model_name, batch) -> dict:
    """A top-20 serving step on frames already on the card (no reader):
    median step time over 5 runs (CUDA events), then one profiled window
    of 3 steps for device time by kernel and the share of the window with
    no kernel running."""
    from yt8m_tpu_torch.infer.predict import make_topk_predict_step

    make, _ = PATHS[model_name]
    model = make(torch, seed=0)[1].to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randint(0, 256, (batch, 300, FEATURE_DIM), device=dev,
                          dtype=torch.uint8, generator=gen)
    nf = torch.randint(FRAMES, 301, (batch,), device=dev, dtype=torch.int32,
                       generator=gen)
    step = make_topk_predict_step(model, TOP_K)
    for _ in range(2):
        step(feats, nf, gen)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        values, _ = step(feats, nf, gen)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    check(bool(torch.isfinite(values).all()), "step: non-finite top-k")
    step_ms = statistics.median(times)
    say("step", f"{model_name} B={batch} serving step on the card: median "
                f"{step_ms:.3f} ms of {[round(t, 3) for t in times]} -> "
                f"{batch / step_ms * 1e3:.0f} videos/s (reader excluded); "
                f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                f" GiB")

    idle = profile_window(torch, "step", f"{model_name} serving",
                          lambda: step(feats, nf, gen), 3)
    del model, feats
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"step_ms": step_ms, "idle_share": idle}


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------


def train_batch(torch, dev, b, seed):
    """A synthetic training batch on the card: uint8 frames, num_frames in
    [30, 300], ~9 positive labels a video (bench_train.py's density)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return {
        "features": torch.randint(0, 256, (b, 300, FEATURE_DIM), device=dev,
                                  dtype=torch.uint8, generator=g),
        "num_frames": torch.randint(FRAMES, 301, (b,), device=dev,
                                    dtype=torch.int32, generator=g),
        "labels": (torch.rand(b, CLASSES, device=dev, generator=g)
                   < 0.002).to(torch.float32),
        "batch_mask": torch.ones(b, device=dev),
    }


def timed_steps(torch, step, state, batch, n, generator=None):
    """Host-clock step times (each ends in a synchronise) and the losses."""
    times, losses = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        _, metrics = step(state, batch, generator=generator)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, losses


def profile_window(torch, phase, name, fn, n_steps):
    """Device time by kernel over fn() run n_steps times, the 16 longest
    printed; the share of the window with no kernel running (None when
    the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    # A user annotation (the optimizer's "Optimizer.step#Adam.step") spans
    # device time its kernels already count.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:16]:
        say(phase, f"  {e.self_device_time_total / 1e3 / n_steps:9.4f} "
                   f"ms/step  x{e.count // n_steps:<5d} {e.key[:90]}")
    idle = 1.0 - busy_ms / window_ms if window_ms > 0 else float("nan")
    say(phase, f"{name} profiled window: {window_ms:.2f} ms for {n_steps} "
               f"step(s), kernels {busy_ms:.2f} ms, idle share {idle:.3f}"
        + ("" if kernels else " (profiler saw no device time)"))
    return idle if kernels else None


def train_flagship(torch, dev) -> dict:
    """The flagship at full width trained through make_train_step: the
    training path, its launch counts set to 0 just before the 10 steps and
    read just after."""
    from yt8m_tpu_torch.kernels import lstm_train as tlt
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState, clip_gradient_norms
    from yt8m_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_flagship_model(torch, seed=0)[1].to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    state = TrainState(model, global_batch_size=TRAIN_BATCH)  # config defaults
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=1)
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    _, losses = timed_steps(torch, step, state, batch, TRAIN_STEPS)
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in wrappers.items()}
    say("train", f"NetVladLstmModel B={TRAIN_BATCH} ({n_params} parameters, "
                 f"bf16, TF32 off, Adam, per-variable clip 1.0): "
                 f"{TRAIN_STEPS} steps on one batch, losses "
                 f"{[round(x, 4) for x in losses]}; launches {launches}, a "
                 f"step: {launches['lstm_train_forward'] // TRAIN_STEPS} "
                 f"forward and {launches['lstm_train_backward'] // TRAIN_STEPS}"
                 f" backward step kernels")
    check(all(math.isfinite(x) for x in losses), "training loss not finite")
    check(losses[-1] < losses[0], "training loss did not fall over 10 steps")
    for name in ("lstm_train_forward", "lstm_train_backward"):
        check(launches[name] == TRAIN_STEPS * LSTM_LAYERS * FLAG_FRAMES,
              f"{name}: {launches[name]} step launches, want "
              f"{TRAIN_STEPS} x {LSTM_LAYERS} x {FLAG_FRAMES}")
    times, _ = timed_steps(torch, step, state, batch, 5)
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("train", f"NetVladLstmModel B={TRAIN_BATCH} training step: median "
                 f"{step_ms:.3f} ms of {[round(t, 3) for t in times]} -> "
                 f"{TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; peak memory "
                 f"{peak:.2f} GiB")
    idle = profile_window(torch, "train", "NetVladLstmModel training",
                          lambda: step(state, batch), 1)
    flush = torch.empty(0, device=dev)
    grads = [p.grad for p in state.params if p.grad is not None]
    clip_ms = time_ms(torch, lambda: clip_gradient_norms(state.params, 1.0),
                      5, flush)
    f32_ms = time_ms(torch, lambda: [torch.linalg.vector_norm(g)
                                     for g in grads], 5, flush)
    say("train", f"per-variable clip of the {len(grads)} gradients, norms "
                 f"in float64: {clip_ms:.3f} ms a step (the float32 norms "
                 f"alone, for scale: {f32_ms:.3f} ms)")
    del state, model, batch, grads
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "idle_share": idle}


def train_dbof(torch, dev) -> None:
    """DbofModel at bench_train.py's B=512, K=8192: no kernel in training
    (the plain graph), a few steps, a finite loss and the step time."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    model = make_model(torch, seed=0)[1].to(dev).train()
    state = TrainState(model, global_batch_size=DBOF_TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, DBOF_TRAIN_BATCH, seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    timed_steps(torch, step, state, batch, 2, gen)
    times, losses = timed_steps(torch, step, state, batch, 5, gen)
    check(all(math.isfinite(x) for x in losses), "DbofModel loss not finite")
    step_ms = statistics.median(times)
    say("train", f"DbofModel B={DBOF_TRAIN_BATCH} K={CLUSTERS} training step: "
                 f"median {step_ms:.3f} ms of {[round(t, 3) for t in times]} "
                 f"-> {DBOF_TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; "
                 f"losses {[round(x, 4) for x in losses]}")
    del state, model, batch
    torch.cuda.empty_cache()


def train_card_vs_cpu(torch, dev) -> None:
    """One flagship training forward and backward on 8 videos, on the card
    and on the CPU, from the same weights and batch (bf16): the loss and
    each parameter's gradient norm, summed in float64 (the CPU's float32
    norm of the VLAD hidden FC's 302 M-element gradient is off by
    percents)."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.step import compute_loss

    batch = {k: v.cpu() for k, v in train_batch(torch, dev, 8, seed=4).items()}
    batch["num_frames"][:3] = torch.tensor([300, 1, 57], dtype=torch.int32)
    results = []
    for d in (dev, torch.device("cpu")):
        model = make_flagship_model(torch, seed=0)[1].to(d).train()
        total, _, _, _ = compute_loss(
            model, {k: v.to(d) for k, v in batch.items()},
            get_loss("CrossEntropyLoss"))
        total.backward()
        results.append((total.item(), {
            n: p.grad.double().norm().item()
            for n, p in model.named_parameters()}))
        del model
    (gpu_loss, gpu), (cpu_loss, cpu) = results
    loss_err = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    check(loss_err <= 2e-3, f"training loss card {gpu_loss} vs CPU {cpu_loss}")
    worst, worst_name = 0.0, ""
    for n, v in cpu.items():
        e = abs(gpu[n] - v) / max(v, 1e-6)
        check(e <= 2e-2, f"gradient norm of {n}: card {gpu[n]:.6e} vs CPU "
                         f"{v:.6e}")
        if e > worst:
            worst, worst_name = e, n
    say("train", f"one flagship training step, 8 videos, card vs CPU: loss "
                 f"{gpu_loss:.6f} vs {cpu_loss:.6f} ({loss_err:.2e} "
                 f"relative, bound 2e-3); gradient norms of {len(cpu)} "
                 f"parameters within {worst:.2e} relative ({worst_name}; "
                 f"bound 2e-2)")
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr, flush=True)
        return 1
    from yt8m_tpu_torch.kernels import _build

    smi = nvidia_smi_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    say("card", f"{smi} | torch {torch.__version__} cuda "
                f"{torch.version.cuda} | {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    res = _build.build()
    say("build", f"{res.seconds:.1f} s (one nvcc per source, in parallel, "
                 f"and a link)"
                 f" -> {res.path}"
        if res.built else f"already built -> {res.path}")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            say("ptxas", line.strip())
    _build.library()

    gen = torch.Generator().manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for fn in (check_dbof, check_moe, check_topk, check_netvlad, check_lstm,
               check_lstm_train):
        row = fn(torch, gen, dev, flush)
        say_row("(kernels line)", row)
        rows.append(row)
        torch.cuda.empty_cache()
    del flush
    check_repaired_shapes(torch, gen, dev)
    torch.cuda.empty_cache()

    from yt8m_tpu_torch.data.synthetic import write_dataset

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(REPO, "build"))
    try:
        data = os.path.join(work, "data")
        write_dataset(data, "test", num_shards=2,
                      videos_per_shard=E2E_VIDEOS // 2, frame_level=True,
                      num_classes=CLASSES, seed=3)
        say("e2e", f"wrote {E2E_VIDEOS} frame-level videos in 2 shards")
        e2e = {name: end_to_end(torch, dev, data, name) for name in PATHS}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    profile_step(torch, dev, "DbofModel", BATCH)
    profile_step(torch, dev, "NetVladLstmModel", FLAG_BATCH)
    training = train_flagship(torch, dev)
    train_dbof(torch, dev)
    train_card_vs_cpu(torch, dev)
    # Launches on the main paths: DBoF's on the DbofModel serving path, the
    # trainable LSTM's (forward and backward step kernels) on the
    # flagship's training path, the others on the flagship's serving path,
    # whose shapes their rows were measured at.
    for row in rows:
        if row["name"] == "lstm_recurrence_trainable":
            fwd = training["launches"]["lstm_train_forward"]
            bwd = training["launches"]["lstm_train_backward"]
            row.update(launches=fwd + bwd, launches_forward=fwd,
                       launches_backward=bwd)
            continue
        path = ("DbofModel" if row["name"] == "dbof_cluster_maxpool_v2"
                else "NetVladLstmModel")
        row["launches"] = e2e[path]["launches"][row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_forward", "launches_backward", "ms_forward",
             "ms_backward", "us_per_step_forward", "us_per_step_backward")
    print(json.dumps({"kernels": [
        {k: r[k] for k in keys + extra if k in r} for r in rows]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
