#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (yt8m_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each with the elapsed seconds:
  1. the card (nvidia-smi name and power limit); raises without CUDA;
  2. the build of every kernel (one nvcc call);
  3. each kernel against its plain PyTorch version on the card at the
     serving shapes (B=2048) plus small edge cases, with its median time
     (CUDA events), the plain version's time, the time of one PyTorch
     yardstick for the same function, and the bound of the work;
  4. DbofModel serving end to end at the reference width (K=8192,
     H=1024, 30 frames, MoE M=2 over 4716 classes, bf16) through the
     inference CLI over synthetic frame-level TFRecords, with the launch
     count of every kernel, CSV checks, and a comparison of 8 videos
     with the same model on the CPU;
  5. the serving step alone at B=2048 on frames already on the card:
     median step time, and device time by kernel from torch.profiler.
Then a `{"kernels": [...]}` line, the nvidia-smi line, and as the last
line `{"ok": true, "device": {...}}`. Any failed check raises: the exit
code is not 0 and no `ok` line is printed. Nothing of JAX is imported.
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

BATCH = 2048          # bench.py's serving batch
FRAMES = 30           # iterations (sampled frames per video)
FEATURE_DIM = 1152    # rgb 1024 + audio 128
CLUSTERS = 8192
HIDDEN = 1024
CLASSES = 4716
MIXTURES = 2
TOP_K = 20
E2E_VIDEOS = 256
E2E_BATCH = 128


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


def check_moe(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.moe_head import (
        moe_head_plain,
        moe_head_serving,
    )

    for b, h, c, m in ((37, 64, 83, 1), (70, 96, 45, 2), (5, 32, 33, 4)):
        args = moe_inputs(torch, gen, b, h, c, m, dev)
        rel_check(f"moe edge B={b} H={h} C={c} M={m}",
                  moe_head_serving(*args, m), moe_head_plain(*args, m))
    # Logits far outside [-80, 80]: the clamp must keep every ratio finite.
    x, wg, we, be = moe_inputs(torch, gen, 16, 64, 40, 2, dev)
    wg = (wg.to(torch.float32) * 400).to(torch.bfloat16)
    got = moe_head_serving(x, wg, we, be, 2)
    check(bool(torch.isfinite(got).all()), "moe: non-finite with big logits")
    rel_check("moe clamp case", got, moe_head_plain(x, wg, we, be, 2))

    args = moe_inputs(torch, gen, BATCH, HIDDEN, CLASSES, MIXTURES, dev)
    got = moe_head_serving(*args, MIXTURES)
    want = moe_head_plain(*args, MIXTURES)
    torch.cuda.synchronize()
    err = rel_check("moe_head_serving", got, want)
    x, wg, we, be = args

    def library():
        xa = x.to(torch.bfloat16)
        g = torch.matmul(xa, wg).to(torch.float32)
        e = torch.matmul(xa, we).to(torch.float32) + be
        gating = torch.softmax(g.reshape(BATCH, CLASSES, MIXTURES + 1), -1)
        experts = torch.sigmoid(e.reshape(BATCH, CLASSES, MIXTURES))
        return torch.sum(gating[..., :MIXTURES] * experts, -1)

    ms = time_ms(torch, lambda: moe_head_serving(*args, MIXTURES), 10, flush)
    plain_ms = time_ms(torch, lambda: moe_head_plain(*args, MIXTURES), 5,
                       flush)
    library_ms = time_ms(torch, library, 5, flush)
    cols = CLASSES * (2 * MIXTURES + 1)
    flops = 2.0 * BATCH * HIDDEN * cols
    nbytes = (BATCH * HIDDEN * 4 + HIDDEN * cols * 2
              + CLASSES * MIXTURES * 4 + BATCH * CLASSES * 4)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    return {
        "name": "moe_head_serving", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/moe_head.cu",
        "replaces": "yt8m_tpu/kernels/moe_head.py:88",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_topk(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.topk import exact_topk, exact_topk_plain

    x = torch.rand(BATCH, CLASSES, generator=gen)
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

    for b, c, k in ((3, 20, 20), (37, 301, 20), (5, 4716, 128), (8, 7, 1)):
        xs = torch.rand(b, c, generator=gen).to(dev)
        xs[0, : c // 2] = xs[0, 0]
        gv, gi = exact_topk(xs, k)
        pv, pi = exact_topk_plain(xs, k)
        check(torch.equal(gv, pv) and torch.equal(gi, pi),
              f"exact_topk edge B={b} C={c} k={k} differs from plain")

    gv, gi = exact_topk(x, TOP_K)
    pv, pi = exact_topk_plain(x, TOP_K)
    torch.cuda.synchronize()
    check(torch.equal(gv, pv), "exact_topk values differ from plain")
    check(torch.equal(gi, pi), "exact_topk indices differ from plain")
    check(int(gi.min()) >= 0 and int(gi.max()) < CLASSES,
          "exact_topk index out of range")
    ms = time_ms(torch, lambda: exact_topk(x, TOP_K), 20, flush)
    plain_ms = time_ms(torch, lambda: exact_topk_plain(x, TOP_K), 5, flush)
    library_ms = time_ms(torch, lambda: torch.topk(x, TOP_K, dim=1), 20,
                         flush)
    nbytes = BATCH * CLASSES * 4 + BATCH * TOP_K * 8
    bound_ms, bound_by = bound(BATCH * CLASSES, nbytes, PEAK_F32_FLOPS)
    return {
        "name": "exact_topk", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/topk.cu",
        "replaces": "yt8m_tpu/kernels/topk.py:75",
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


# ---------------------------------------------------------------------------
# phase 4: DbofModel serving end to end
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


def compare_with_cpu(torch, model, data_pattern, dev) -> float:
    """Probabilities of 8 videos on the card vs the same model on the CPU
    with the same sampled frames."""
    from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig

    rc = ReaderConfig("rgb,audio", "1024,128", frame_features=True,
                      num_classes=CLASSES)
    batch = next(iter(BatchIterator(data_pattern, rc, batch_size=8)))
    feats = torch.from_numpy(batch["features"])
    nf = torch.from_numpy(batch["num_frames"])
    u = torch.rand(8, FRAMES, generator=torch.Generator().manual_seed(7))
    cpu_model = make_model(torch, seed=0)[1]
    with torch.inference_mode():
        gpu = model(feats.to(dev), nf.to(dev), u=u.to(dev))["predictions"]
        cpu = cpu_model(feats, nf, u=u)["predictions"]
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


def end_to_end(torch, dev) -> dict:
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.convert import save_checkpoint
    from yt8m_tpu_torch.data.synthetic import write_dataset
    from yt8m_tpu_torch.kernels.dbof import dbof_cluster_maxpool_v2
    from yt8m_tpu_torch.kernels.moe_head import moe_head_serving
    from yt8m_tpu_torch.kernels.topk import exact_topk

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(REPO, "build"))
    try:
        data = os.path.join(work, "data")
        write_dataset(data, "test", num_shards=2,
                      videos_per_shard=E2E_VIDEOS // 2, frame_level=True,
                      num_classes=CLASSES, seed=3)
        say("e2e", f"wrote {E2E_VIDEOS} frame-level videos in 2 shards")
        hp, model = make_model(torch, seed=0)
        run = os.path.join(work, "run")
        save_checkpoint(run, model, "DbofModel", hp, frame_features=True,
                        feature_names="rgb,audio", feature_sizes="1024,128",
                        num_classes=CLASSES, max_frames=300,
                        label_loss="CrossEntropyLoss")
        out_csv = os.path.join(work, "out.csv")
        argv = [
            f"--input_data_pattern={data}/test-*.tfrecord",
            f"--train_dir={run}", f"--output_file={out_csv}",
            f"--batch_size={E2E_BATCH}", f"--top_k={TOP_K}",
            "--frame_features=true", "--feature_names=rgb,audio",
            "--feature_sizes=1024,128", "--model=DbofModel",
            f"--device={dev.type}",
        ]
        kernels = (dbof_cluster_maxpool_v2, moe_head_serving, exact_topk)
        for fn in kernels:
            fn.launches = 0
        stats = inference_cli.main(argv)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in kernels}
        say("e2e", f"inference CLI: {stats['num_videos']} videos, "
                   f"{stats['videos_per_sec']:.1f} videos/s "
                   f"(batch {E2E_BATCH}, reader included); "
                   f"launches {launches}")
        for name, n in launches.items():
            check(n > 0, f"{name} was not launched on the main path")
        check(stats["num_videos"] == E2E_VIDEOS, "video count")
        check(stats["nonfinite_predictions"] == 0, "non-finite predictions")
        check(check_csv(out_csv) == E2E_VIDEOS, "CSV line count")
        say("e2e", f"CSV ok: {E2E_VIDEOS} lines of {TOP_K} pairs")
        err = compare_with_cpu(torch, model.to(dev),
                               f"{data}/test-*.tfrecord", dev)
        say("e2e", f"8 videos card vs CPU: max|diff| {err:.3e} <= 2e-3")
        return {"launches": launches, "videos_per_sec": stats["videos_per_sec"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 5: the device serving step alone, and where its time goes
# ---------------------------------------------------------------------------


def profile_step(torch, dev) -> dict:
    """The top-20 serving step at B=2048 on frames already on the card
    (no reader): median step time over 5 runs (CUDA events), then one
    profiled window of 3 steps for device time by kernel and the share of
    the window with no kernel running."""
    from torch.profiler import ProfilerActivity, profile

    from yt8m_tpu_torch.infer.predict import make_topk_predict_step

    model = make_model(torch, seed=0)[1].to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randint(0, 256, (BATCH, 300, FEATURE_DIM), device=dev,
                          dtype=torch.uint8, generator=gen)
    nf = torch.randint(FRAMES, 301, (BATCH,), device=dev, dtype=torch.int32,
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
    say("step", f"B={BATCH} serving step on the card: median {step_ms:.3f} ms"
                f" of {[round(t, 3) for t in times]} -> "
                f"{BATCH / step_ms * 1e3:.0f} videos/s (reader excluded)")

    n_steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(feats, nf, gen)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for e in kernels[:10]:
        say("step", f"  {e.self_device_time_total / 1e3 / n_steps:9.4f} ms/step"
                    f"  x{e.count // n_steps:<3d} {e.key[:90]}")
    idle = 1.0 - busy_ms / window_ms if window_ms > 0 else float("nan")
    say("step", f"profiled window: {window_ms:.2f} ms for {n_steps} steps, "
                f"kernels {busy_ms:.2f} ms, idle share {idle:.3f}"
                + ("" if kernels else " (profiler saw no device time)"))
    return {"step_ms": step_ms, "idle_share": idle if kernels else None}


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
    say("build", f"{res.seconds:.1f} s (nvcc, one call) -> {res.path}"
        if res.built else f"already built -> {res.path}")
    for line in res.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            say("ptxas", line.strip())
    _build.library()

    gen = torch.Generator().manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for fn in (check_dbof, check_moe, check_topk):
        row = fn(torch, gen, dev, flush)
        say("kernel", f"{row['name']}: ok, max|diff| {row['max_abs_err']:.3e};"
                      f" {row['ms']:.4f} ms (plain {row['plain_ms']:.4f},"
                      f" library {row['library_ms']:.4f}, bound"
                      f" {row['bound_ms']:.4f} by {row['bound_by']})")
        rows.append(row)
    del flush

    e2e = end_to_end(torch, dev)
    torch.cuda.empty_cache()
    profile_step(torch, dev)
    for row in rows:
        row["launches"] = e2e["launches"][row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
