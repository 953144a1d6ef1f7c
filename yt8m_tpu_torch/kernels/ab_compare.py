"""Compare kernels of this checkout with another checkout's, on the card,
on the same inputs.

    python -m yt8m_tpu_torch.kernels.ab_compare --other DIR [--out DIR]
    python -m yt8m_tpu_torch.kernels.ab_compare --other DIR --kernels dbof,moe
    python -m yt8m_tpu_torch.kernels.ab_compare --other DIR \
        --kernels dequant,netvlad_core
    python -m yt8m_tpu_torch.kernels.ab_compare --other DIR --kernels nextvlad
    python -m yt8m_tpu_torch.kernels.ab_compare --other DIR --kernels vlad,int8
    python -m yt8m_tpu_torch.kernels.ab_compare --other DIR \
        --kernels attention,topk

DIR is the root of another checkout (e.g. a `git archive` of a parent
commit unpacked under build/). Each checkout runs in its own process, with
its own package and kernel build.

`--kernels dbof,moe`: the main path's two products at its shapes,
dbof_cluster_maxpool_v2 at B=2048 (S=30, D=1152, K=8192) and
moe_head_serving at B=512, H=2048 and B=2048, H=1024 (C=4716, M=2), on
inputs made from a seed. The checkouts run in turns (other, this, this,
other), each timing every call (median CUDA-event ms of 10, the L2
flushed before each) and this checkout also the MoE's library yardstick
(two bf16 matmuls, softmax, sigmoid, sum). Printed: each checkout's two
medians, and max|diff| between the checkouts' outputs against the rows'
bound 1e-3 * max|ref| + 1e-5 (the products sum in another order, so not
bit for bit).

`--kernels dequant,netvlad_core`: dequant_affine_matmul at M=153,600 in
both routes (D=1152, N=4096 in bf16; D=128, N=1024 in f32) and
netvlad_core at the flagship's training shape (B=256, F=300, K=256,
D=1152), forward and backward without dx, on inputs made from a seed.
The checkouts run in turns (other, this, this, other), each timing every
call by the profiler's device time (the sum over the call's kernels,
median of 7 windows, the L2 flushed before each), and this checkout also
each row's library call (the affine and one torch.matmul; softmax, a
bf16 bmm and autograd). Printed: each checkout's medians, the library's,
and max|diff| between the checkouts' outputs against each row's
tolerance (1e-3 * max|ref| + 1e-6; 1e-5 in f32).

`--kernels nextvlad`: nextvlad_aggregate at NeXtVladModel's serving
shape (B=512, F=300, D=1152, lambda=2, G=8, K=128, uint8 frames) and the
trainable pair (the forward with residuals and the backward) at its
training shape (B=256), on inputs made as chip_smoke.py makes them (a
seeded generator; num_frames uniform in 1..F with F, 0 and 1 planted).
The checkouts run in turns (other, this, this, other), each timing every
call by the profiler's device time (the sum over the call's kernels and
each kernel by name, median of 7 windows, the L2 flushed before each),
and this checkout also each row's library yardstick (bf16 matmuls,
softmax and bmm; under autograd for the pair). Printed: each checkout's
medians with the per-launch split, the library's, and max|diff| between
the checkouts' outputs and five weight gradients against the rows'
bound 2^-7 * max|ref| + 1e-6 (chip_smoke.py's NEXTVLAD_REL).

`--kernels vlad,int8`: netvlad_aggregate at the flagship's serving shape
(B=512, F=300, D=1152, K=256) with float32 and with uint8 frames, and
dbof_cluster_maxpool_int8 at B=2048 (S=30, D=1152, K=8192), on inputs
made as chip_smoke.py makes them (a seeded generator; num_frames uniform
in 1..F with F, 0 and 1 planted; the int8 constants from an f32 cluster
kernel). The checkouts run in turns (other, this, this, other), each
timing every call by the profiler's device time (the sum over the call's
kernels and each kernel by name, median of 7 windows, the L2 flushed
before each), and this checkout also each row's library yardstick (bf16
matmuls, softmax and the norms; torch._int_mm and the epilogue). Printed:
each checkout's medians with the per-launch split, the library's, and
for NetVLAD max|diff| between the checkouts against 2^-8 * max|ref| +
1e-6 (chip_smoke.py's VLAD_REL: the column sums and norms are summed in
another order), for the int8 kernel whether the two outputs are equal
bit for bit.

`--kernels attention,topk`: exact_topk at B=512 and B=2048 with k=20 and
at B=512 with k=64 (eval's sorted_topk) over C=4716 scores (uniform in
[0, 1), with NaN, -inf, ties, a row of equal values and a row of +-0.0
planted), and attention_pool at AttentionPoolingModel's serving shape
(B=512, F=300, D=1152, H=8) with uint8 and with float32 frames (num_frames
uniform in 1..F with F, 1 and 0 planted), on inputs made from a seed. The
checkouts run in turns (other, this, this, other), each timing every call
by the profiler's device time (the sum over the call's kernels and each
kernel by name, median of 7 windows, the L2 flushed before each), and
this checkout also each row's library call (torch.topk; a bf16 matmul,
the masked softmax and a bf16 bmm). Printed: each checkout's medians with
the split by kernel, the library's, whether the top-k outputs (values by
their bits, and indices) are equal across the checkouts, and for each
checkout's attention output its rounding witness against its own plain
version (kernels/attention_pool.py :: rounding_limit: the kernel's
recovered weights explain its output, none differs away from a rounding
boundary, |kernel - plain| within the derived limit).

`--kernels steps`: chip_smoke.py's `profile_step` (this checkout's) for
each serving path of `--paths` (';'-separated chip_smoke.py PATHS names;
B=2048 for the DBoF paths, else 512) on each checkout's package, in
turns (other, this, this, other), each run in a fresh process: the
step's median ms of 5 by CUDA events, and the profiler's device time by
kernel, which profile_step prints. Printed: each checkout's step ms.

Without `--kernels` (the recurrences): the trainable LSTM's and GRU's forward
(outputs, final state, residuals) and backward (dZ; dA_g and dA_c) at the
training shape (B=256, F=300, H=1024, num_frames uniform in 1..F with F,
0 and 1 planted), both directions, on inputs made from a seed. Both
backwards take the residuals of this checkout's forward. Printed for each
tensor: the number of values that differ, of how many, and the largest
difference; the residuals on the live (step, row) pairs only (a kernel
may write anything at a frozen step: every use there is masked).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

F, B, H = 300, 256, 1024
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _inputs(torch, kind, seed):
    g = torch.Generator().manual_seed(seed)
    nf = torch.randint(1, F + 1, (B,), generator=g, dtype=torch.int32)
    nf[:3] = torch.tensor([F, 0, 1], dtype=torch.int32)
    if kind == "lstm":
        ts = [(0.5 * torch.randn(F, B, 4 * H, generator=g)).to(torch.bfloat16),
              nf,
              (torch.randn(H, 4 * H, generator=g) * H ** -0.5).to(
                  torch.bfloat16),
              0.1 * torch.randn(4 * H, generator=g)]
    else:
        ts = [(0.5 * torch.randn(F, B, 2 * H, generator=g)).to(torch.bfloat16),
              (0.5 * torch.randn(F, B, H, generator=g)).to(torch.bfloat16),
              nf,
              (torch.randn(H, 2 * H, generator=g) * H ** -0.5).to(
                  torch.bfloat16),
              (torch.randn(H, H, generator=g) * H ** -0.5).to(torch.bfloat16),
              1.0 + 0.1 * torch.randn(2 * H, generator=g),
              0.1 * torch.randn(H, generator=g)]
    cot = [torch.randn(F, B, H, generator=g), torch.randn(B, H, generator=g),
           torch.randn(B, H, generator=g)]
    return [t.cuda() for t in ts], [t.cuda() for t in cot]


def run(out_path, residuals_path=None):
    """The package on sys.path: forward and backward of both recurrences,
    both directions, saved to out_path. The backwards take the residuals
    saved at residuals_path where given."""
    import torch

    from yt8m_tpu_torch.kernels import gru_train as tgt
    from yt8m_tpu_torch.kernels import lstm_train as tlt

    given = torch.load(residuals_path) if residuals_path else {}

    def shared(key, t):
        return given[key].cuda() if key in given else t

    res = {}
    for rev in (False, True):
        args, cot = _inputs(torch, "lstm", 1 + rev)
        key = f"lstm {rev}"
        outs, gates, cs, c, h = tlt.lstm_train_forward(*args, rev)
        res.update({f"{key} nf": args[1], f"{key} outs": outs,
                    f"{key} gates": gates, f"{key} cs": cs, f"{key} c": c,
                    f"{key} h": h})
        res[f"{key} dz"] = tlt.lstm_train_backward(
            cot[0], cot[1], cot[2], shared(f"{key} gates", gates),
            shared(f"{key} cs", cs), args[1], args[2], rev)
        args, cot = _inputs(torch, "gru", 3 + rev)
        key = f"gru {rev}"
        outs, gates, cand, h = tgt.gru_train_forward(*args, rev)
        res.update({f"{key} nf": args[2], f"{key} outs": outs,
                    f"{key} gates": gates, f"{key} cand": cand,
                    f"{key} h": h})
        res[f"{key} dag"], res[f"{key} dac"] = tgt.gru_train_backward(
            cot[0], cot[2], shared(f"{key} gates", gates),
            shared(f"{key} cand", cand), shared(f"{key} outs", outs),
            args[2], args[3], args[4], rev)
    torch.cuda.synchronize()
    torch.save({k: v.cpu() for k, v in res.items()}, out_path)


PRODUCT_SHAPES = (("dbof", 2048, 0), ("moe", 512, 2048), ("moe", 2048, 1024))
PRODUCT_REL, PRODUCT_ABS = 1e-3, 1e-5


def _product_inputs(torch, kind, b, h):
    g = torch.Generator().manual_seed(b + h)
    if kind == "dbof":
        s, d, k = 30, 1152, 8192
        return [torch.randint(0, 256, (b, s, d), generator=g,
                              dtype=torch.uint8),
                (torch.randn(d, k, generator=g) * d ** -0.5).to(
                    torch.bfloat16),
                (4.0 / 255.0) * (0.5 + torch.rand(d, generator=g)),
                0.1 * torch.randn(d, generator=g) - 2.0,
                0.5 + torch.rand(k, generator=g),
                0.1 * torch.randn(k, generator=g)]
    c, m = 4716, 2
    return [torch.randn(b, h, generator=g).abs(),
            (torch.randn(h, c * (m + 1), generator=g) * h ** -0.5).to(
                torch.bfloat16),
            (torch.randn(h, c * m, generator=g) * h ** -0.5).to(
                torch.bfloat16),
            0.1 * torch.randn(c * m, generator=g)]


def _median_ms(torch, fn, flush, reps=10):
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
    return sorted(times)[reps // 2]


def run_products(out_path, library="0"):
    """The package on sys.path: DBoF v2 and the MoE head at the main
    path's shapes, outputs and median ms saved to out_path; with library
    = "1" also the MoE's library yardstick."""
    import torch

    from yt8m_tpu_torch.kernels import dbof, moe_head

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for kind, b, h in PRODUCT_SHAPES:
        args = [t.cuda() for t in _product_inputs(torch, kind, b, h)]
        key = f"{kind} B={b}" + (f" H={h}" if h else "")
        if kind == "dbof":
            fn = lambda: dbof.dbof_cluster_maxpool_v2(*args)  # noqa: E731
        else:
            x, wg, we, be = args
            if hasattr(moe_head, "pitched"):  # the row stride TMA takes
                wg, we = moe_head.pitched(wg), moe_head.pitched(we)
            fn = lambda: moe_head.moe_head_serving(  # noqa: E731
                x, wg, we, be, 2)
        res[f"{key} out"] = fn().cpu()
        res[f"{key} ms"] = _median_ms(torch, fn, flush)
        if kind == "moe" and library == "1":
            x, wg, we, be = args

            def lib():
                xa = x.to(torch.bfloat16)
                g = torch.matmul(xa, wg).float()
                e = torch.matmul(xa, we).float() + be
                gate = torch.softmax(g.reshape(b, 4716, 3), -1)
                return torch.sum(gate[..., :2] * torch.sigmoid(
                    e.reshape(b, 4716, 2)), -1)

            res[f"{key} library ms"] = _median_ms(torch, lib, flush)
    torch.save(res, out_path)


CORE_CASES = (("dequant bf16", 1e-3), ("dequant f32", 1e-5),
              ("netvlad_core forward", 1e-3),
              ("netvlad_core backward", 1e-3))


def _device_ms(torch, fn, flush, reps=7):
    """Median over reps profiler windows of the summed device time of
    fn's kernels (the window opens and closes on an idle card)."""
    import statistics
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        # Kernels only: an aten op also carries its kernels' device time.
        us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        times.append(us / 1e3)
    return statistics.median(times)


def run_core(out_path, library="0"):
    """The package on sys.path: dequant_affine_matmul in both routes and
    netvlad_core forward and backward (no dx) at their main shapes,
    outputs and device ms saved to out_path; with library = "1" also the
    rows' library calls."""
    import torch

    from yt8m_tpu_torch.kernels import dequant_matmul as tdq
    from yt8m_tpu_torch.kernels import netvlad_train as tnt

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    m = 512 * 300
    for name, d, n in (("dequant bf16", 1152, 4096), ("dequant f32", 128, 1024)):
        g = torch.Generator().manual_seed(d + n)
        x = torch.randint(0, 256, (m, d), generator=g, dtype=torch.uint8)
        w = torch.randn(d, n, generator=g) * d ** -0.5
        scale = (4.0 / 255.0) * (0.5 + torch.rand(d, generator=g))
        bias = -2.0 + 0.1 * torch.randn(d, generator=g)
        x, w, scale, bias = (t.cuda() for t in (x, w, scale, bias))
        fn = lambda: tdq.dequant_affine_matmul(x, w, scale, bias)  # noqa: E731
        res[f"{name} out"] = fn().cpu()
        res[f"{name} ms"] = _device_ms(torch, fn, flush)
        if library == "1":
            dt = tdq.compute_dtype(d)
            res[f"{name} library ms"] = _device_ms(
                torch, lambda: torch.matmul(
                    (x.float() * scale + bias).to(dt), w.to(dt)).float(),
                flush)
        del x, w, fn
        torch.cuda.empty_cache()
    b, f, k, d = B, F, 256, 1152
    g = torch.Generator().manual_seed(b + f + k + d)
    act = 1.5 * torch.randn(b, f, k, generator=g)
    x = (torch.randint(0, 256, (b, f, d), generator=g).float() * (4.0 / 255.0)
         + (4.0 / 512.0 - 2.0))
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[:3] = torch.tensor([f, 0, 1], dtype=torch.int32)
    centers = torch.randn(k, d, generator=g) * d ** -0.5
    dvlad = torch.randn(b, k, d, generator=g)
    act, x, nf, centers, dvlad = (t.cuda() for t in (act, x, nf, centers,
                                                     dvlad))
    args = (act, x, nf, centers)
    vlad, a_sum = tnt.netvlad_core_forward(*args)
    res["netvlad_core forward out"] = torch.cat(
        [vlad.flatten(), a_sum.flatten()]).cpu()
    res["netvlad_core forward ms"] = _device_ms(
        torch, lambda: tnt.netvlad_core_forward(*args), flush)
    res["netvlad_core backward out"] = tnt.netvlad_core_backward(
        *args, dvlad, False)[0].cpu()
    res["netvlad_core backward ms"] = _device_ms(
        torch, lambda: tnt.netvlad_core_backward(*args, dvlad, False), flush)
    if library == "1":
        live = (torch.arange(f, device="cuda")[None, :]
                < nf[:, None])[:, :, None]

        def forward(a):
            p = torch.softmax(a, -1) * live
            v = torch.matmul(p.to(torch.bfloat16).transpose(1, 2),
                             x.to(torch.bfloat16)).to(torch.float32)
            return v - p.sum(1)[:, :, None] * centers

        def both():
            a = act.detach().requires_grad_()
            forward(a).backward(dvlad)

        with torch.no_grad():
            res["netvlad_core forward library ms"] = _device_ms(
                torch, lambda: forward(act), flush)
        res["netvlad_core both library ms"] = _device_ms(torch, both, flush)
    torch.save(res, out_path)


NXV_REL = 2.0 ** -7  # chip_smoke.py's NEXTVLAD_REL
NXV_CASES = ("nextvlad serving", "nextvlad train forward",
             "nextvlad train backward")


def _nextvlad_inputs(torch, b, seed):
    """chip_smoke.py's NeXtVLAD inputs (uint8 frames) at B=b."""
    f, d, lam, g, k = F, 1152, 2, 8, 128
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (b, f, d), generator=gen, dtype=torch.uint8)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[:3] = torch.tensor([f, 0, 1], dtype=torch.int32)
    de = lam * d
    w = [torch.randn(d, de, generator=gen) * d ** -0.5,
         torch.randn(de, g, generator=gen) * de ** -0.5,
         0.5 * torch.randn(g, generator=gen),
         torch.randn(de, g * k, generator=gen) * de ** -0.5,
         torch.randn(k, de // g, generator=gen) * de ** -0.5]
    dy = torch.randn(b, k, de // g, generator=gen)
    return [t.cuda() for t in (x, nf, *w)], dy.cuda(), g


def _device_split(torch, fn, flush, reps=7):
    """Median over reps profiler windows of fn's summed device time (ms)
    and of each kernel's by name."""
    import statistics
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    totals, names = [], {}
    for _ in range(reps):
        flush.zero_()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.02)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.02)
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.self_device_time_total
        totals.append(sum(by.values()) / 1e3)
        for n, us in by.items():
            names.setdefault(n, []).append(us / 1e3)
    return statistics.median(totals), {
        n: statistics.median(v + [0.0] * (reps - len(v)))
        for n, v in names.items()}


def run_nextvlad(out_path, library="0"):
    """The package on sys.path: nextvlad_aggregate at B=512 and the
    trainable forward and backward at B=256, outputs, gradients and
    device ms (total and by kernel) saved to out_path; with library =
    "1" also the library yardsticks."""
    import torch

    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels import nextvlad as tnv
    from yt8m_tpu_torch.kernels import nextvlad_train as tnt

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    bf = torch.bfloat16

    def library_fn(args, g, dy):
        x, nf, *w = args
        b, f, _ = x.shape
        k = w[3].shape[1] // g
        p = w[0].shape[1] // g
        mask = (torch.arange(f, device="cuda")[None, :]
                < nf[:, None])[:, :, None, None]

        def fn():
            ws = [t.detach().requires_grad_(dy is not None) for t in w]
            xb = (x.to(torch.float32) * DEQUANT_SCALE + DEQUANT_BIAS).to(bf)
            xe = torch.matmul(xb, ws[0].to(bf))
            alpha = torch.sigmoid(torch.matmul(xe, ws[1].to(bf)).float()
                                  + ws[2])
            act = torch.matmul(xe, ws[3].to(bf)).float().reshape(b, f, g, k)
            a = torch.softmax(act, -1) * alpha[..., None] * mask
            vlad = torch.bmm(a.to(bf).reshape(b, f * g, k).transpose(1, 2),
                             xe.reshape(b, f * g, p)).float()
            vlad = vlad - a.sum((1, 2))[:, :, None] * ws[4]
            out = torch.nn.functional.normalize(vlad, dim=2, eps=1e-6)
            if dy is not None:
                out.backward(dy)
        return fn

    args, _, g = _nextvlad_inputs(torch, 512, 17)
    x, nf, *w = args
    layout = tnv.kernel_layout(*w, g)
    fn = lambda: tnv.nextvlad_aggregate(*args, g, layout=layout)  # noqa: E731
    res["nextvlad serving out"] = fn().cpu()
    res["nextvlad serving ms"], res["nextvlad serving split"] = _device_split(
        torch, fn, flush)
    if library == "1":
        with torch.no_grad():
            res["nextvlad serving library ms"] = _device_split(
                torch, library_fn(args, g, None), flush)[0]
    del args, x, w, layout, fn
    torch.cuda.empty_cache()

    args, dy, g = _nextvlad_inputs(torch, 256, 29)
    x, nf, *w = args
    layout = tnv.kernel_layout(*w, g, training=True)
    out, scratch = tnt.nextvlad_train_forward(x, nf, layout)
    res["nextvlad train forward out"] = out.cpu()
    grads = tnt.nextvlad_train_backward(nf, scratch, layout, dy)
    res["nextvlad train backward out"] = torch.cat(
        [t.flatten() for t in grads]).cpu()
    for i, t in enumerate(grads):
        res[f"nextvlad train grad {i}"] = t.cpu()
    del out, grads
    res["nextvlad train forward ms"], res["nextvlad train forward split"] = (
        _device_split(torch, lambda: tnt.nextvlad_train_forward(
            x, nf, layout), flush))
    res["nextvlad train backward ms"], res["nextvlad train backward split"] = (
        _device_split(torch, lambda: tnt.nextvlad_train_backward(
            nf, scratch, layout, dy), flush))
    if library == "1":
        res["nextvlad train library ms"] = _device_split(
            torch, library_fn(args, g, dy), flush)[0]
    torch.save(res, out_path)


VLAD_REL = 2.0 ** -8  # chip_smoke.py's VLAD_REL
VLAD_CASES = ("netvlad float32", "netvlad uint8", "dbof int8")


def _vlad_inputs(torch, x_dtype, seed):
    """chip_smoke.py's NetVLAD inputs at the flagship's serving shape."""
    b, f, d, k = 512, F, 1152, 256
    gen = torch.Generator().manual_seed(seed)
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=gen, dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=gen)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[:3] = torch.tensor([f, 0, 1], dtype=torch.int32)
    wc = (torch.randn(d, k, generator=gen) * d ** -0.5).to(torch.bfloat16)
    scale = 0.5 + torch.rand(k, generator=gen)
    bias = 0.3 * torch.randn(k, generator=gen)
    centers = torch.randn(k, d, generator=gen) * d ** -0.5
    return [t.cuda() for t in (x, nf, wc, scale, bias, centers)]


def _int8_inputs(torch, seed):
    """chip_smoke.py's int8 DBoF inputs at B=2048: raw frames and the
    constants of int8_serving_constants."""
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels.dbof import int8_serving_constants

    b, s, d, k = 2048, 30, 1152, 8192
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (b, s, d), generator=gen, dtype=torch.uint8)
    s_in = DEQUANT_SCALE * (0.5 + torch.rand(d, generator=gen))
    b_in = DEQUANT_BIAS * s_in + 0.1 * torch.randn(d, generator=gen)
    w = (torch.randn(d, k, generator=gen) * d ** -0.5).to(torch.bfloat16)
    s_act = 0.5 + torch.rand(k, generator=gen)
    b_act = 0.1 * torch.randn(k, generator=gen)
    consts = int8_serving_constants(w.float(), s_in, b_in, s_act, b_act)
    return [t.cuda() for t in (x, *consts)]


def run_vlad_int8(out_path, library="0"):
    """The package on sys.path: netvlad_aggregate (float32 and uint8
    frames) at B=512 and dbof_cluster_maxpool_int8 at B=2048, outputs and
    device ms (total and by kernel) saved to out_path; with library =
    "1" also the library yardsticks."""
    import torch

    from yt8m_tpu_torch.kernels.dbof import dbof_cluster_maxpool_int8
    from yt8m_tpu_torch.kernels.netvlad import netvlad_aggregate

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for dt, seed in ((torch.float32, 31), (torch.uint8, 37)):
        args = _vlad_inputs(torch, dt, seed)
        key = f"netvlad {str(dt).split('.')[-1]}"
        fn = lambda: netvlad_aggregate(*args)  # noqa: E731
        res[f"{key} out"] = fn().cpu()
        res[f"{key} ms"], res[f"{key} split"] = _device_split(torch, fn,
                                                              flush)
        if library == "1":
            x, nf, wc, scale, bias, centers = args

            def lib():
                xf = x.to(torch.float32)
                if x.dtype == torch.uint8:
                    xf = xf * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
                xb = xf.to(torch.bfloat16)
                act = torch.matmul(xb, wc).to(torch.float32) * scale + bias
                mask = (torch.arange(x.shape[1], device="cuda")[None, :]
                        < nf[:, None])[:, :, None]
                a = torch.softmax(act, -1) * mask
                vlad = torch.matmul(a.to(torch.bfloat16).transpose(1, 2),
                                    xb).to(torch.float32)
                vlad = vlad - a.sum(1)[:, :, None] * centers
                vlad = torch.nn.functional.normalize(vlad, dim=2, eps=1e-6)
                return torch.nn.functional.normalize(vlad.flatten(1), dim=1,
                                                     eps=1e-6)
            res[f"{key} library ms"] = _device_split(torch, lib, flush)[0]
        del args, fn
        torch.cuda.empty_cache()
    args = _int8_inputs(torch, 41)
    fn = lambda: dbof_cluster_maxpool_int8(*args)  # noqa: E731
    res["dbof int8 out"] = fn().cpu()
    res["dbof int8 ms"], res["dbof int8 split"] = _device_split(torch, fn,
                                                                flush)
    if library == "1":
        x, w8, a_col, b_col = args

        def lib():
            xi = (x ^ 128).view(torch.int8).reshape(-1, x.shape[2])
            acc = torch._int_mm(xi, w8).to(torch.float32)
            act = torch.relu(acc * a_col + b_col)
            return torch.amax(act.reshape(x.shape[0], x.shape[1], -1), dim=1)
        res["dbof int8 library ms"] = _device_split(torch, lib, flush)[0]
    torch.save(res, out_path)


TOPK_CASES = ((512, 20), (2048, 20), (512, 64))
ATTN_CASES = ("attention uint8", "attention float32")
ATTN_SHAPE = (512, F, 1152, 8)  # AttentionPoolingModel serving: B, F, D, H


def _topk_inputs(torch, b, seed):
    """[b, 4716] scores uniform in [0, 1) with chip_smoke.py's planted
    rows: repeated values, NaN, -inf, -3.4e38 with NaN, a row of equal
    values, -inf and -3e38, and a row of +-0.0 among negative values."""
    c = 4716
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(b, c, generator=gen)
    x[0] = torch.repeat_interleave(torch.rand(c // 3 + 1, generator=gen),
                                   3)[:c]
    x[1, ::7] = float("nan")
    x[2, ::3] = float("-inf")
    x[3] = -3.4e38
    x[3, 100:110] = float("nan")
    x[4] = 0.25
    x[5, :30] = float("-inf")
    x[5, 30:] = -3.0e38
    x[6] = -torch.rand(c, generator=gen)
    x[6, 1::5] = 0.0
    x[6, ::5] = -0.0
    return x.cuda()


def run_attn_topk(out_path, library="0"):
    """The package on sys.path: exact_topk at TOPK_CASES and
    attention_pool at B=512, F=300, D=1152, H=8 with uint8 and float32
    frames; outputs, device ms (total and by kernel) and each attention
    output's rounding witness against this checkout's plain version saved
    to out_path; with library = "1" also the library calls."""
    import torch

    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels import attention_pool as tap
    from yt8m_tpu_torch.kernels.topk import exact_topk

    torch.backends.cuda.matmul.allow_tf32 = False
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for b, k in TOPK_CASES:
        x = _topk_inputs(torch, b, 43 + b + k)
        key = f"topk B={b} k={k}"
        v, i = exact_topk(x, k)
        res[f"{key} out"] = (v.cpu(), i.cpu())
        res[f"{key} ms"], res[f"{key} split"] = _device_split(
            torch, lambda: exact_topk(x, k), flush)
        if library == "1":
            res[f"{key} library ms"] = _device_split(
                torch, lambda: torch.topk(x, k, dim=1), flush)[0]
    b, f, d, h = ATTN_SHAPE
    for dt, seed in ((torch.uint8, 47), (torch.float32, 53)):
        gen = torch.Generator().manual_seed(seed)
        if dt == torch.uint8:
            x = torch.randint(0, 256, (b, f, d), generator=gen,
                              dtype=torch.uint8)
        else:
            x = torch.randn(b, f, d, generator=gen)
        nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
        nf[:3] = torch.tensor([f, 1, 0], dtype=torch.int32)
        q = (torch.randn(d, h, generator=gen) * d ** -0.5).to(torch.bfloat16)
        args = [t.cuda() for t in (x, nf, q)]
        key = f"attention {str(dt).split('.')[-1]}"
        got = tap.attention_pool(*args)
        want = tap.attention_pool_plain(*args)
        r = tap.rounding_limit(*args, got, want)
        err = (got - want).abs()
        res[f"{key} witness"] = (
            r.explained, r.away, bool(torch.all(err <= r.limit)),
            err.max().item(), r.flips)
        res[f"{key} out"] = got.cpu()
        del got, want, r, err
        res[f"{key} ms"], res[f"{key} split"] = _device_split(
            torch, lambda: tap.attention_pool(*args), flush)
        if library == "1":
            xs, nfs, qs = args
            live = torch.arange(f, device="cuda")[None, :] < nfs[:, None]
            live[nfs <= 0] = True

            def lib():
                xf = xs.to(torch.float32)
                if xs.dtype == torch.uint8:
                    xf = xf * DEQUANT_SCALE + DEQUANT_BIAS
                xb = xf.to(torch.bfloat16)
                s = torch.matmul(xb, qs.to(torch.bfloat16)).to(torch.float32)
                s = s.masked_fill(~live[..., None], -1e9)
                a = torch.softmax(s, dim=1).to(torch.bfloat16)
                return torch.bmm(a.transpose(1, 2), xb).to(torch.float32)
            res[f"{key} library ms"] = _device_split(torch, lib, flush)[0]
        del args
        torch.cuda.empty_cache()
    torch.save(res, out_path)


def compare_attn_topk(torch, mine, other) -> list:
    """Lines: each call's device ms in both checkouts with the split by
    kernel and the library's; top-k outputs across the checkouts (values
    by their bits, and indices); each checkout's attention witness."""
    lines = []
    keys = [f"topk B={b} k={k}" for b, k in TOPK_CASES] + list(ATTN_CASES)
    for key in keys:
        ms = [r[f"{key} ms"] for r in mine]
        ms_other = [r[f"{key} ms"] for r in other]
        line = (f"{key}: this checkout {ms[0]:.4f}, {ms[1]:.4f} ms; other "
                f"{ms_other[0]:.4f}, {ms_other[1]:.4f} ms (device, median "
                f"of 7)")
        if f"{key} library ms" in mine[0]:
            lib = [r[f"{key} library ms"] for r in mine]
            line += f"; library {lib[0]:.4f}, {lib[1]:.4f} ms"
        if key.startswith("topk"):
            (v, i), (w, j) = mine[0][f"{key} out"], other[0][f"{key} out"]
            same = (torch.equal(v.view(torch.int32), w.view(torch.int32))
                    and torch.equal(i, j))
            line += f"; bit for bit with the other: {same}"
        else:
            for name, r in (("this", mine[0]), ("other", other[0])):
                explained, away, within, err, flips = r[f"{key} witness"]
                line += (f"; {name}: witness explained={explained} away="
                         f"{away} within_limit={within} max|diff| "
                         f"{err:.3e} flips {flips}")
        lines.append(line)
        for name, r in (("this", mine[0]), ("other", other[0])):
            split = sorted(r[f"{key} split"].items(), key=lambda kv: -kv[1])
            lines.append(f"  {name} by kernel: " + "; ".join(
                f"{n[:60]} {v:.4f}" for n, v in split))
    return lines


def compare_vlad_int8(torch, mine, other) -> list:
    """Lines: each call's device ms in both checkouts with the split by
    kernel, the library's, and the outputs against the parent's: NetVLAD
    within 2^-8 * max|ref| + 1e-6, the int8 kernel bit for bit."""
    lines = []
    for key in VLAD_CASES:
        ms = [r[f"{key} ms"] for r in mine]
        ms_other = [r[f"{key} ms"] for r in other]
        line = (f"{key}: this checkout {ms[0]:.4f}, {ms[1]:.4f} ms; other "
                f"{ms_other[0]:.4f}, {ms_other[1]:.4f} ms (device, median "
                f"of 7)")
        if f"{key} library ms" in mine[0]:
            lib = [r[f"{key} library ms"] for r in mine]
            line += f"; library {lib[0]:.4f}, {lib[1]:.4f} ms"
        x, y = mine[0][f"{key} out"], other[0][f"{key} out"]
        if key.startswith("dbof"):
            line += (f"; bit for bit with the other: {torch.equal(x, y)}")
        else:
            diff = (x - y).abs().max().item()
            limit = VLAD_REL * y.abs().max().item() + 1e-6
            line += (f"; max|diff| {diff:.3e} (bound {limit:.3e}: "
                     f"{'within' if diff <= limit else 'OUTSIDE'}; "
                     f"{'' if torch.equal(x, y) else 'not '}bit for bit)")
        lines.append(line)
        for name, r in (("this", mine[0]), ("other", other[0])):
            split = sorted(r[f"{key} split"].items(), key=lambda kv: -kv[1])
            lines.append(f"  {name} by kernel: " + "; ".join(
                f"{n[:60]} {v:.4f}" for n, v in split))
    return lines


def compare_nextvlad(torch, mine, other) -> list:
    """Lines: each call's device ms in both checkouts with the split by
    kernel, the library's, and max|diff| between the checkouts against
    the rows' bound; the five weight gradients one by one."""
    lines = []
    for key in NXV_CASES:
        ms = [r[f"{key} ms"] for r in mine]
        ms_other = [r[f"{key} ms"] for r in other]
        line = (f"{key}: this checkout {ms[0]:.4f}, {ms[1]:.4f} ms; other "
                f"{ms_other[0]:.4f}, {ms_other[1]:.4f} ms (device, median "
                f"of 7)")
        lib_key = ("nextvlad serving library ms" if key.endswith("serving")
                   else "nextvlad train library ms"
                   if key.endswith("backward") else None)
        if lib_key in mine[0]:
            lib = [r[lib_key] for r in mine]
            line += (f"; library {lib[0]:.4f}, {lib[1]:.4f} ms"
                     + (" (forward + autograd backward)"
                        if key.endswith("backward") else ""))
        x, y = mine[0][f"{key} out"], other[0][f"{key} out"]
        if x.shape == y.shape:
            diff = (x - y).abs().max().item()
            limit = NXV_REL * y.abs().max().item() + 1e-6
            line += (f"; max|diff| {diff:.3e} (bound {limit:.3e}: "
                     f"{'within' if diff <= limit else 'OUTSIDE'}; "
                     f"{'' if torch.equal(x, y) else 'not '}bit for bit)")
        lines.append(line)
        for name, r in (("this", mine[0]), ("other", other[0])):
            split = sorted(r[f"{key} split"].items(), key=lambda kv: -kv[1])
            lines.append(f"  {name} by kernel: " + "; ".join(
                f"{n[:60]} {v:.4f}" for n, v in split))
    for i, name in enumerate(("dWe", "dWa", "dab", "dWc", "dcenters")):
        x = mine[0][f"nextvlad train grad {i}"]
        y = other[0][f"nextvlad train grad {i}"]
        diff = (x - y).abs().max().item()
        limit = NXV_REL * y.abs().max().item() + 1e-6
        lines.append(f"nextvlad train {name}: max|diff| {diff:.3e} (bound "
                     f"{limit:.3e}: {'within' if diff <= limit else 'OUTSIDE'}"
                     f"; {'' if torch.equal(x, y) else 'not '}bit for bit)")
    return lines


def compare_core(torch, mine, other) -> list:
    """Lines: each row's device ms in both checkouts, the library's, and
    max|diff| between the checkouts against the row's tolerance."""
    lines = []
    for key, rel in CORE_CASES:
        x, y = mine[0][f"{key} out"], other[0][f"{key} out"]
        diff = (x - y).abs().max().item()
        limit = rel * y.abs().max().item() + 1e-6
        ms = [r[f"{key} ms"] for r in mine]
        ms_other = [r[f"{key} ms"] for r in other]
        line = (f"{key}: this checkout {ms[0]:.4f}, {ms[1]:.4f} ms; other "
                f"{ms_other[0]:.4f}, {ms_other[1]:.4f} ms (device, median "
                f"of 7); max|diff| {diff:.3e} (bound {limit:.3e}: "
                f"{'within' if diff <= limit else 'OUTSIDE'})")
        lib_key = (f"{key} library ms" if key.startswith("dequant")
                   else "netvlad_core forward library ms"
                   if key.endswith("forward") else None)
        if lib_key and lib_key in mine[0]:
            lib = [r[lib_key] for r in mine]
            line += f"; library {lib[0]:.4f}, {lib[1]:.4f} ms"
        lines.append(line)
    both = [r["netvlad_core forward ms"] + r["netvlad_core backward ms"]
            for r in mine]
    both_other = [r["netvlad_core forward ms"] + r["netvlad_core backward ms"]
                  for r in other]
    lib = [r["netvlad_core both library ms"] for r in mine]
    lines.append(f"netvlad_core forward + backward: this checkout "
                 f"{both[0]:.4f}, {both[1]:.4f} ms; other {both_other[0]:.4f}"
                 f", {both_other[1]:.4f} ms; library (forward + autograd "
                 f"backward) {lib[0]:.4f}, {lib[1]:.4f} ms")
    return lines


def compare_products(torch, mine, other) -> list:
    """Lines: each product's medians in both checkouts, the library's,
    and max|diff| between the checkouts against the rows' bound."""
    lines = []
    for kind, b, h in PRODUCT_SHAPES:
        key = f"{kind} B={b}" + (f" H={h}" if h else "")
        x, y = mine[0][f"{key} out"], other[0][f"{key} out"]
        diff = (x - y).abs().max().item()
        limit = PRODUCT_REL * y.abs().max().item() + PRODUCT_ABS
        ms = [r[f"{key} ms"] for r in mine]
        ms_other = [r[f"{key} ms"] for r in other]
        line = (f"{key}: this checkout {ms[0]:.4f}, {ms[1]:.4f} ms; other "
                f"{ms_other[0]:.4f}, {ms_other[1]:.4f} ms; max|diff| "
                f"{diff:.3e} (bound {limit:.3e}: "
                f"{'within' if diff <= limit else 'OUTSIDE'})")
        if f"{key} library ms" in mine[0]:
            lib = [r[f"{key} library ms"] for r in mine]
            line += f"; library {lib[0]:.4f}, {lib[1]:.4f} ms"
        lines.append(line)
    return lines


def compare(torch, a, b):
    """Lines: each tensor's differing values against the other run's, the
    residuals on the live (step, row) pairs only."""
    lines = []
    for key in a:
        kind, rev, name = key.split()
        if name == "nf":
            continue
        x, y = a[key], b[key]
        if name in ("gates", "cs", "cand"):
            t = torch.arange(F)[:, None]
            orig = (F - 1 - t) if rev == "True" else t
            live = a[f"{kind} {rev} nf"].to(torch.int64)[None, :] > orig
            x, y = x[live], y[live]
        n = int((x != y).sum())
        diff = (x.float() - y.float()).abs().max().item()
        lines.append(f"{kind} reverse={rev} {name}: {n} of {x.numel()} values "
                     f"differ, max|diff| {diff:.3e}")
    return lines


def run_steps(out_path, paths):
    """chip_smoke.py :: profile_step of this file's checkout for each of
    `paths` (';'-separated) on the package first on sys.path; {path: step
    ms} saved to out_path."""
    import importlib.util

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    steps = {}
    for path in (p.strip() for p in paths.split(";")):
        b = smoke.BATCH if "Dbof" in path else smoke.FLAG_BATCH
        steps[path] = smoke.profile_step(torch, dev, path, b)["step_ms"]
    torch.save(steps, out_path)


def _in_checkout(root, fn, *extra):
    """fn of this file, run in its own process with the package of the
    checkout at root first on the path (this file is loaded by path: the
    other checkout need not have it)."""
    code = ("import sys, importlib.util as u; sys.path.insert(0, sys.argv[1]);"
            " s = u.spec_from_file_location('ab_compare', sys.argv[2]);"
            " m = u.module_from_spec(s); s.loader.exec_module(m);"
            f" m.{fn}(*sys.argv[3:])")
    subprocess.run([sys.executable, "-c", code, root,
                    os.path.abspath(__file__), *extra], cwd=root, check=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True,
                    help="root of the other checkout")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab"))
    ap.add_argument("--kernels", default="recurrences",
                    choices=("recurrences", "dbof,moe",
                             "dequant,netvlad_core", "nextvlad",
                             "vlad,int8", "attention,topk", "steps"))
    ap.add_argument("--paths", default="",
                    help="--kernels steps: ';'-separated serving paths")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ab_compare needs a CUDA device")
    args.out = os.path.abspath(args.out)  # the checkouts run in their roots
    os.makedirs(args.out, exist_ok=True)
    if args.kernels == "dbof,moe":
        return _main_products(torch, args, "run_products", compare_products)
    if args.kernels == "dequant,netvlad_core":
        return _main_products(torch, args, "run_core", compare_core)
    if args.kernels == "nextvlad":
        return _main_products(torch, args, "run_nextvlad", compare_nextvlad)
    if args.kernels == "vlad,int8":
        return _main_products(torch, args, "run_vlad_int8", compare_vlad_int8)
    if args.kernels == "attention,topk":
        return _main_products(torch, args, "run_attn_topk", compare_attn_topk)
    if args.kernels == "steps":
        return _main_steps(torch, args)
    mine = os.path.join(args.out, "this.pt")
    other = os.path.join(args.out, "other.pt")
    _in_checkout(ROOT, "run", mine)
    _in_checkout(os.path.abspath(args.other), "run", other, mine)
    for line in compare(torch, torch.load(mine), torch.load(other)):
        print(line, flush=True)
    return 0


def _main_products(torch, args, fn, compare_fn) -> int:
    """fn of this file in each checkout, in turns (other, this, this,
    other); compare_fn's lines."""
    other_root = os.path.abspath(args.other)
    runs = {"this": [], "other": []}
    for i, (name, root) in enumerate((("other", other_root), ("this", ROOT),
                                      ("this", ROOT), ("other", other_root))):
        path = os.path.join(args.out, f"{fn}_{i}_{name}.pt")
        _in_checkout(root, fn, path, "1" if name == "this" else "0")
        runs[name].append(torch.load(path))
    for line in compare_fn(torch, runs["this"], runs["other"]):
        print(line, flush=True)
    return 0


def _main_steps(torch, args) -> int:
    """run_steps in each checkout, in turns (other, this, this, other)."""
    if not args.paths:
        raise SystemExit("--kernels steps needs --paths")
    other_root = os.path.abspath(args.other)
    runs = {"this": [], "other": []}
    for i, (name, root) in enumerate((("other", other_root), ("this", ROOT),
                                      ("this", ROOT), ("other", other_root))):
        path = os.path.join(args.out, f"steps_{i}_{name}.pt")
        _in_checkout(root, "run_steps", path, args.paths)
        runs[name].append(torch.load(path))
    for p in (p.strip() for p in args.paths.split(";")):
        print(f"{p}: step ms this {[round(r[p], 3) for r in runs['this']]}, "
              f"other {[round(r[p], 3) for r in runs['other']]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
