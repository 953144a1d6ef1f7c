#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/H100 port (yt8m_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each with the elapsed seconds:
  1. the card (nvidia-smi name and power limit); raises without CUDA;
  2. the build of every kernel (one nvcc per source, at once, and a link);
  3. each kernel against its plain PyTorch version on the card at the
     shapes of its paths (DBoF at DbofModel's B=2048; MoE and top-k at
     DbofModel's B=2048, H=1024 and at the flagship's B=512, H=2048;
     NetVLAD and the LSTM at the flagship's B=512; the GRU at GruModel's
     B=512, F=300, H=1024 (the two serving recurrences are one persistent
     launch a call: both directions timed, the grid barriers' share from
     a run with the products skipped, the row chunks computed against
     B*F, the L2 -> SM bytes a step; edge shapes with every row dead,
     every row live, B=1, B=130, B=2048 and the LSTM at H=2048, where the
     weights are streamed, each held to one launch a call); attention pooling at AttentionPoolingModel's
     B=512, F=300, D=1152, 8 heads, uint8 and f32 frames; NeXtVLAD at
     NeXtVladModel's B=512, F=300, D=1152, lambda=2, G=8, K=128, uint8 and
     f32 frames) plus small, odd and ragged shapes and planted hazards
     (DBoF and the MoE head, on TMA + wgmma, at B, K, S, C and H that cut
     their tiles, the MoE's weights as pitched views; top-k also at eval's
     k=64 and with a row of +-0.0 held to the plain version on the CPU;
     attention pooling also at D=1001 with F=300, 16 heads and 300
     videos),
     with its median time (CUDA events; the profiler's device time for
     attention pooling, top-k and NeXtVLAD, with CUDA events beside it),
     the plain
     version's time, the time of one PyTorch yardstick for the same
     function, and the bound of the work; the trainable recurrences (the
     LSTM's and the GRU's, forward with residuals and the reverse-time
     backward, one persistent launch each) at their training shape
     (B=256, F=300, H=1024, both directions) with planted hazards, their
     rounding witnesses, times, us a step and barrier shares, and bounds
     beside one cuDNN layer's forward and backward;
     netvlad_core at the flagship's training shape (B=256, F=300, K=256,
     D=1152) and at small and odd shapes (K 8, 100, 256 and 512 x F 1,
     63, 65 and 300, with and without dx, hazards bit for bit); the
     trainable NeXtVLAD (the
     forward with residuals and the backward's five weight gradients) at
     NeXtVladModel's training shape (B=256) and at small and odd shapes,
     with a second run held bit for bit; NeXtVLAD's rounding witnesses,
     forward and backward; the int8 DBoF kernel at DbofModel's B=2048
     (columns with a_col < 0, 0 and -0.0 at the edges) with its
     int8-vs-bf16 deviation and the bf16 path's time in the same phase,
     DBoF v1 at B=2048 and the sampled
     DBoF at B=2048, F=300 beside DbofModel's own route (the gather, then
     v2; timed route, fused, fused, route), and dequant_affine_matmul at the
     flagship's first LSTM input projection over raw frames (M=153,600,
     D=1152, N=4096, bf16) and over the audio features (D=128, N=1024,
     f32), each with edge shapes (for dequant_affine_matmul M 1, 127, 129
     x N 7, 255, 257 x D 512, 1000, 1152 in bf16 and 64, 128, 200 in
     f32) and the DBoF ones with planted hazards; the f32 routes of
     --compute_dtype=float32 (DBoF v2 at B=2048 with f32 W, the MoE head
     at the flagship's B=512, H=2048 with f32 weights, netvlad_aggregate
     at B=512 with f32 Wc, attention pooling at B=512 with an f32 query;
     uint8 frames) and at small, odd and ragged shapes (DBoF S=40, the
     MoE head at H = 999 and 1000 and M = 16, NetVLAD at D = 100 and
     1001 and K = 37, attention pooling at D = 1001 and 19 heads), frames
     past num_frames planted, each with its CUDA-event and profiler
     times, the plain version's, the torch.matmul f32 graph's (TF32 off)
     and its bound (all four 3xTF32 routes, DBoF v2, the MoE head and
     NetVLAD on the weights' split copies, attention pooling splitting
     Q on chip: three TF32 products at the TF32 rate, the FMA units'
     bound beside it), and each route's and the f32 graph's error
     against the function in float64 at the serving shapes (DBoF's at
     depths D = 256 .. 16384 too); the shapes
     past the kernels' old limits, bf16 and f32 routes: the MoE head at
     M = 17 (the run-time tile), 32 and 200 (chunks of 120 mixtures) at
     B=512, H=2048, C=4716, with chunk edges (M = 122, 240, 241) and gate
     logits past +-80; netvlad_aggregate at K = 520, 1024 and 2048 at
     B=512, F=300, D=1152 with uint8 frames (frames past num_frames,
     an empty video and an unassigned cluster planted; padded clusters
     at K = 1020; the rounding witness at K = 1024); netvlad_core at K =
     520 and 1024 at the training shape (hazards and a second run bit for
     bit); each with CUDA-event and profiler times, the plain version's,
     the torch.matmul graph's and its bound;
  4. serving end to end through the inference CLI over synthetic
     frame-level TFRecords, for each path with the launch counts set to
     0 just before it and read just after: DbofModel at the reference
     width (K=8192, H=1024, 30 frames, MoE M=2 over 4716 classes, bf16),
     the same with --dbof_int8_serving (one int8 launch and no bf16 DBoF
     launch a batch), the flagship NetVladLstmModel at the JAX defaults (all 300 frames
     masked by num_frames, D=1152, VLAD K=256 with hidden 1024, BN and
     context gating, LSTM 2 x 1024 with last pooling, MoE M=2 over 4716
     classes, bf16), GruModel (GRU 2 x 1024, last pooling, MoE M=2, bf16),
     AttentionPoolingModel (8 heads, hidden 512 with BN, MoE M=2, bf16)
     and NeXtVladModel at the JAX defaults (lambda=2, G=8, K=128, hidden
     1024 with BN and context gating, MoE M=2 over 4716, bf16); then the
     rest of the zoo at the JAX defaults (MoE M=2 over 4716, bf16):
     LogisticModel, MoeModel and ChainMoeModel over video-level
     mean_rgb + mean_audio records, FrameLevelLogisticModel,
     GatedDbofModel, SoftDbofModel, LayerNormLstmModel, FrameCnnModel,
     NetFVModel, ChainFrameModel, ChainNetVladModel and
     DeepCombineChainModel over the frame-level ones, with the launches a
     batch that PER_BATCH fixes (3 MoE launches on each chain, 1 DBoF v2
     on GatedDbofModel, 1 netvlad_aggregate on ChainNetVladModel, no
     recurrence launch on LayerNormLstmModel); then DbofModel, the
     flagship, AttentionPoolingModel and NeXtVladModel at
     --compute_dtype=float32 (a batch: 1 f32 DBoF v2 and 1 f32 MoE; 1 f32
     netvlad_aggregate, 0 lstm_recurrence (the scan graph) and 1 f32 MoE;
     1 f32 attention_pool and 1 f32 MoE; 0 NeXtVLAD (the plain graph) and
     1 f32 MoE); the flagship at --netvlad_cluster_size=1024
     --moe_num_mixtures=32 (1 netvlad_aggregate, 2 lstm_recurrence and 1
     MoE a batch), ChainMoeModel at --moe_num_mixtures=32 cut to one
     chain stage (1 MoE a batch) and MoeModel with
     --moe_head_pallas=false (no MoE launch: the plain head); CSV
     checks, and 8 videos compared with the same model on the CPU;
  5. each serving step alone on frames already on the card (DbofModel at
     B=2048 with and without --dbof_int8_serving and at
     --compute_dtype=float32 (the 3xTF32 routes), GatedDbofModel and
     SoftDbofModel at B=2048, the others at B=512, the flagship and
     AttentionPoolingModel also at --compute_dtype=float32): median step time of
     5, and device time by kernel from torch.profiler; one recurrence
     launch a layer in the flagship's and GruModel's steps, PER_BATCH's
     launches in the others';
  6. training through make_train_step (bf16, Adam at the config
     defaults, per-variable clip 1.0) with the launch counts set to 0
     just before and read just after: the flagship at full width (B=256
     as bench_train.py) for 10 steps on one repeated synthetic batch, a
     falling loss, the median step time of 5, a torch.profiler breakdown
     of one step and the peak memory, once with the plain VLAD training
     graph and once with --netvlad_fused_train (1 + 1 netvlad_core
     launches a step); DbofModel at B=512, K=8192; one flagship training
     step on 8 videos on the card and on the CPU; GruModel at B=256 the
     same way (10 steps, one recurrence launch a layer each way a step)
     and one of its steps on 8 videos card vs CPU; AttentionPoolingModel
     at B=256
     through its plain training graph (no kernel, as in the JAX package);
     NeXtVladModel at B=256 the same way as GruModel (1 + 1 trainable
     NeXtVLAD launches a step) and one of its steps on 8 videos card vs
     CPU; ChainNetVladModel (plain, then --netvlad_fused_train: 1 + 1
     netvlad_core launches a step), DeepCombineChainModel, NetFVModel and
     FrameCnnModel at the JAX defaults, 8 steps each at B=256, a falling
     loss and the step time; DbofModel at float32 (B=512, 7 steps, a
     falling loss); the flagship at B=256 for 3 steps under Adam f32,
     AdafactorOptimizer, RMSPropOptimizer, AdagradOptimizer and Adam with
     a bf16 first moment (finite losses, step time, the optimizer state's
     bytes beside Adam f32's), and one step of each new optimizer on 8
     videos' gradients, card vs CPU; the flagship at K=1024 and M=32 with
     --netvlad_fused_train, 3 steps at B=256 (finite losses, the step
     time, 1 + 1 netvlad_core launches a step);
  7. the reference workflow through the port's CLIs with the flagship at
     full width and --netvlad_fused_train, over synthetic frame-level
     TFRecords (256 train and 128 eval videos, 30-300 frames): cli.train
     to step 2 (a checkpoint at step 2), cli.train again to step 4
     (resumed at step 2), cli.eval --run_once (finite GAP, Hit@1, mAP in
     [0, 1]; exact_topk launched through sorted_topk at k=64),
     cli.inference (the CSV), each with its launch counts set to 0 just
     before and read just after; the checkpoint's size and its save and
     restore seconds; 8 eval videos from the checkpoint on the card and
     on the CPU; then GruModel and NeXtVladModel each through cli.train
     (2 steps) -> cli.eval --run_once -> cli.inference on the same videos,
     and DbofModel the same way, served by eval and inference with
     --dbof_int8_serving; DbofModel at float32 with
     --optimizer=AdafactorOptimizer through cli.train to step 2, resumed
     to step 4 (the step-4 checkpoint's optimizer state at step 4, its
     moments factored), then served by cli.inference on the f32 routes;
     the default workflow on video-level records
     (cli.train with no flag but the data and the run directory:
     LogisticModel over mean_rgb on the card, then cli.eval and
     cli.inference); ChainNetVladModel with --netvlad_fused_train through
     the three CLIs; DbofModel at the reference width through cli.train
     with a checkpoint a step, to step 3 and resumed to 4, synchronously
     and with --async_checkpoint (resumed at step 3, no hidden directory
     left), the seconds each save held the training thread;
  8. the readers: frame-level videos/s of the Python reader, the native
     one, 4 parse threads and 4 spawned reader processes over 384 videos
     in 8 shards (each video once, the reader that ran asserted), and
     DbofModel at the reference width through cli.inference (batch 128)
     with the Python reader and with the native one; then the ensemble
     workflow on the workflow's records: two members (DbofModel at the
     reference width, the flagship at the JAX defaults) trained 2 steps
     through cli.train, their dense train-split dumps and DbofModel's
     sparse top-64 through cli.inference, cli.ensemble --fit_weights to a
     CSV, the two served together through cli.inference
     --ensemble_train_dirs (launches a batch: 1 DBoF v2, 2 MoE, 1
     netvlad_aggregate, 2 lstm_recurrence, 1 top-k), its dense dump
     against the host average of the members' dumps, 8 videos against
     the same ensemble on the CPU, its serving step against its members'
     at B=512; a flagship student trained 4 steps with
     --netvlad_fused_train on distill records written from the ensemble's
     dump (MixedCrossEntropyDistillLoss, finite and falling losses, the
     trainable LSTM's and netvlad_core's launches), DbofModel trained 4
     steps with boost weights from its member's dump, and the mean of
     DbofModel's last two checkpoints served;
  9. the serving export: DbofModel at the reference config (K=8192,
     H=1024, 30 sampled frames, M=2 over 4716), with
     --dbof_int8_serving, the flagship and NeXtVladModel at the JAX
     defaults exported with a dynamic batch (infer/export.py), the rest
     of the zoo (and the f32 flagship, its LSTM an unrolled scan) at one
     recurrent layer, and DbofModel's cli.train --export_model_steps=2
     directory; a fresh python3 process loads each program and serves it
     (B=2048 and 128 for the DBoF paths, 512 and 128 for the flagship and
     NeXtVLAD, 8 videos for the rest): its top-20 equal to the eager
     serving step's with a generator seeded 0, bit for bit, two calls
     equal, and on the four first paths the same launches a batch and,
     the eager step rebuilt in that process from the same seed, the same
     kernels a batch by the profiler, with eager and exported videos/s,
     the export seconds and program.pt2's size against the state dict's;
     then cli.parity on the workflow's inference CSV against itself with
     the eval labels (every delta 0, exit 0). Phase 3 also runs NeXtVLAD
     at K = 264 and 520 (serving B=512, trainable B=256; the wide
     launches), phase 4 NeXtVladModel at K=520 through cli.inference and
     phase 6 trains it 3 fused steps;
 10. multi-GPU (parallel/): (a) the flagship at full width with
     --netvlad_fused_train on torch.cuda.device_count() ranks over NCCL,
     one a card (1 here), 3 data-parallel steps at global B=256 and 3
     with --fsdp_min_size=1e8 (the VLAD hidden FC sharded where there are
     several ranks), Adam: finite, falling losses, 1 + 1 netvlad_core and
     2 + 2 trainable LSTM launches a step on every rank, each rank's step
     time, peak memory and NCCL's device ms in one step; at one rank the
     first data-parallel step bit for bit make_train_step's; (b) two
     ranks sharing one card over gloo, one data-parallel and one FSDP
     SGD step from the same weights on the same global batch (B=256)
     against the one-device step, with a witness (the one-device step
     from weights one float32 step off); (c) cli.train --num_devices=W
     --fsdp_min_size=1e8 (W the cards: one rank here) to step 2, resumed
     to 4, cli.eval --run_once and cli.inference at W ranks (with
     several, the CSV byte for byte cli.inference's at one rank at the
     ranks' batch from the same checkpoint); (a) also runs 3
     tensor-parallel steps (--model_parallel) at mp = 2 and 4 where the
     cards divide by it (none here); (d) two ranks sharing one card over
     gloo as a (1, 2) grid, --model_parallel=2: 3 SGD steps each of
     DbofModel (graft widths) and the fused flagship against the
     one-device step with (b)'s bounds and a witness of each, each rank
     holding its blocks of the MoE head (and DBoF's cluster layer), the
     flagship's trainable kernels launched in the TP steps; (e)
     cli.train DbofModel --num_devices=2 --model_parallel=2 on the shared
     card, then cli.eval at one rank of its checkpoint. Phases 1-9 run
     the CLIs at --num_devices=1. A `phase:` line gives each phase's
     seconds.
Then a `{"kernels": [...]}` line, the nvidia-smi line, and as the last
line `{"ok": true, "device": {...}}`. Any failed check raises: the exit
code is not 0 and no `ok` line is printed. Nothing of JAX is imported.

Tolerances, max|kernel - plain| on the same inputs:
  * DBoF, MoE: <= 1e-3 * max|ref| + 1e-5. Both round the same operands
    to bf16 at the same points (elementwise, in the same order); only the
    summation order of the products differs.
  * top-k: exactly equal (a row of +-0.0 against the plain version on
    the CPU, values by their bits: the card's sort may order the two
    zeros by their bits).
  * int8 DBoF: bit for bit. The integer sums are exact on both sides (the
    plain version multiplies in float64, exact below 2^53; float32 would
    round sums above 2^24); the plain version converts each to f32 and
    applies the affine unfused, the kernel the same to the pooled sum
    only (every step is monotone: a max, or a min where a_col < 0, of
    the sums commutes with it exactly). Its deviation from the bf16
    plain version, max|int8 - bf16| / mean|bf16|, is printed (the CPU
    tests hold the port's int8 path to the JAX test's 0.10 at its
    shape).
  * sampled DBoF: bit for bit with v2 on the gathered frames (the same
    affine rounding, the same product); DBoF v1 and dequant_affine_matmul
    in bf16 (D >= 512): the DBoF bound; dequant_affine_matmul in f32
    (D < 512): <= 1e-5 * max|ref| + 1e-6.
  * NetVLAD (every K): <= 2^-8 * max|ref| + 1e-6. The assignment is rounded to
    bf16 after a softmax whose f32 max and sum run in another order in
    the two versions; where a value lies within their last-bit
    difference of a bf16 rounding boundary, the two round one bf16 step
    (2^-8 relative) apart, and that moves one frame's term of one
    cluster row, which the intra-normalisation carries into the row.
    1e-3 * max|ref| does not hold (2.2e-5 against 1.0e-5 was read on
    the card). The witness shows the cause: the assignments differ only
    by one bf16 step at rounding boundaries, and on the kernel's own
    assignment the plain remainder meets 1e-3 * max|ref| + 1e-6.
  * LSTM and GRU, serving and trainable (outputs, final state, gates,
    c_t or the candidate, dZ or dA, dx, dW_h, db): <= 2e-2 * max(1,
    max|ref|). Both round h (and
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
    by the 1e-3 remainder alone. The GRU's witness runs the serving
    kernel one step at a time and feeds the plain cell the kernel's own
    state (its f32 h, u and bf16(r * h)): u and h meet 1e-3 * max|ref| +
    1e-6, bf16(r * h) and the outputs differ only at rounding boundaries;
    the trainable forward equals those steps bit for bit, and its gates
    and candidate and the backward's dA_g and dA_c, fed their own bf16
    streams, differ in the same way only.
  * attention pooling: <= 1e-3 * max|ref| + 1e-5 at the edge shapes and
    with f32 frames. Both round x, Q and the attention to bf16 at the
    same points; the softmax's f32 max and sum run in another order,
    which can move one bf16 attention weight one step, one frame's term
    in a sum over up to 300. With uint8 frames at the serving shape such
    a weight in [0.5, 1) moves the output 2^-9 |x|, past that bound on
    some draws: those draws are held to the limit the rounding witness
    derives (kernels/attention_pool.py :: rounding_limit).
  * the trainable forwards' residuals (gates; the GRU's candidate): the
    LSTM bound on live (video, step) pairs, exactly 0 on frozen ones
    (the kernels compute live rows only).
  * netvlad_core (vlad, a_sum, dact, dx, dcenters): <= 1e-3 * max|ref| +
    1e-6. Both round the products' operands to bf16 at the same points;
    the softmax's f32 max and sum run in another order, which can move a
    bf16 assignment one step at a rounding boundary, but one frame's term
    in a sum over up to 300 frames stays far inside 1e-3 of the largest
    value (read on the card).
  * NeXtVLAD, serving and trainable (the output and the five weight
    gradients): <= 2^-7 * max|ref| + 1e-6. Both round x, xe, the
    assignment (and in the backward dv, d_act and d_xe) to bf16 at the
    same points; where an f32 sum before a rounding runs in another order
    a value at a rounding boundary lands one bf16 step (2^-8 to 2^-7 of
    itself) apart, and an xe value or assignment that dominates an
    element of a short video's row moves the intra-normalised element by
    up to that share of itself. 1e-3 * max|ref| does not hold (up to
    3.1e-3 of max|ref| on the forward, 1.8e-3 on dWe, read on the card).
    The witnesses show the cause: fed the kernel's own bf16 streams, the
    plain steps round to the kernel's values but at rounding boundaries,
    and what follows the roundings meets 1e-3 * max|ref| + 1e-6.
  * planted hazards: the kernel's output with large values in the frames
    or steps past num_frames equals its output with zeros there.
  * the served ensemble's dense dump against the weighted average of its
    members' dumps (numpy, float64 then f32): <= 1e-5 * max|ref|. The
    members run the same kernels on the same batches with the same
    frame draws (the flagship draws none), so only the f32 sum of the
    two weighted terms differs.
  * the f32 routes (DBoF v2, the MoE head, NetVLAD, attention pooling
    with f32 weights): <= 1e-5 * max|ref| + 1e-5, NetVLAD's + 1e-8 (its
    L2-normalised descriptor holds values near 1.8e-3 at the serving
    shape, where + 1e-5 would let a bf16 rounding of x or Wc through).
    Nothing is rounded to bf16 on either side (the plain versions run
    with TF32 off); the kernels differ from them in the order of the f32
    sums and by their 3xTF32 split (about 2^-21 of each product; the
    float64 witness prints its distance beside the f32 graph's).
  * card vs CPU end to end (8 videos): probabilities within 2e-3, and
    within 1e-5 * max|ref| at --compute_dtype=float32; the per-video
    eval loss from the workflow's checkpoint within 2e-3 relative.
  * the new optimizers' one step card vs CPU on the same gradients: each
    parameter's move within 1e-5 * max|move on the CPU| + 2^-23 *
    max|parameter| (f32 elementwise arithmetic; the clip's float64 norms
    and Adafactor's means are summed in another order; the new weight is
    rounded to f32, one step of itself where u differs in its last bits:
    2.98e-8 on the VLAD hidden FC against a 1.9e-3 Adafactor move, read
    on the card).
  * card vs CPU, one flagship training step (8 videos, bf16): the loss
    within 2e-3 relative, each parameter's gradient norm within 2e-2
    relative (the LSTM bound: the recurrence carries one-step bf16
    rounding differences into the gradients).
"""

from __future__ import annotations

import csv
import gc
import json
import logging
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

T0 = time.perf_counter()
REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM datasheet peaks (dense): bf16 and int8 tensor cores, f32
# outside them, TF32 tensor cores (the f32 routes of DBoF v2 and the MoE
# head: three TF32 products an f32 product), device memory rate.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 494.7e12
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
# GruModel and AttentionPoolingModel at the JAX package's defaults.
GRU_CELLS = 1024
GRU_LAYERS = 2
ATTN_HEADS = 8
ATTN_HIDDEN = 512
# NeXtVladModel at the JAX package's defaults.
NEXTVLAD_LAMBDA = 2
NEXTVLAD_GROUPS = 8
NEXTVLAD_CLUSTERS = 128
NEXTVLAD_HIDDEN = 1024
NEXTVLAD_REL = 2.0 ** -7


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


def dbof_library(torch, x, w, s_in, b_in, s_act, b_act):
    """Row 1's yardstick: the affine, a bf16 matmul, the epilogue, amax."""
    xa = (x.to(torch.float32) * s_in + b_in).to(torch.bfloat16)
    act = torch.matmul(xa, w.to(torch.bfloat16)).to(torch.float32)
    return torch.amax(torch.relu(act * s_act + b_act), dim=1)


def check_dbof(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool_plain,
        dbof_cluster_maxpool_v2,
    )

    # Edge cases: ragged B and K, S < 32, float input; shapes that cut
    # the TMA + wgmma tiles (B no multiple of 4 or 128, so a cluster's
    # second video tile lies past B; K no multiple of 256; S in {1, 17,
    # 31, 32}; D no multiple of 64); and the padded-row hazard (every
    # real row negative before the ReLU, a zero row would give
    # relu(act_bias) = 3) at S = 30, 1, 31, 32 and 40.
    for b, s, d, k, dt in ((7, 5, 64, 200, torch.uint8),
                           (9, 32, 96, 136, torch.float32),
                           (5, 30, 1152, 8192, torch.uint8),
                           (130, 31, 1152, 1000, torch.uint8),
                           (133, 1, 64, 264, torch.float32),
                           (3, 32, 96, 8, torch.uint8),
                           (9, 17, 160, 2056, torch.float32)):
        args = dbof_inputs(torch, gen, b, s, d, k, dt, dev)
        rel_check(f"dbof edge B={b} S={s} D={d} K={k} {dt}",
                  dbof_cluster_maxpool_v2(*args),
                  dbof_cluster_maxpool_plain(*args))
    for s in (30, 1, 31, 32, 40):
        x, w, s_in, b_in, s_act, b_act = dbof_inputs(
            torch, gen, 6, s, 64, 264, torch.uint8, dev)
        w = torch.full_like(w, -1.0)
        s_in = torch.ones_like(s_in)
        b_in = torch.full_like(b_in, 1.0)
        b_act = torch.full_like(b_act, 3.0)
        got = dbof_cluster_maxpool_v2(x, w, s_in, b_in, s_act, b_act)
        want = dbof_cluster_maxpool_plain(x, w, s_in, b_in, s_act, b_act)
        check(bool(torch.all(want == 0)),
              f"dbof hazard case S={s}: plain not all 0")
        check(bool(torch.all(got == 0)),
              f"dbof S={s}: padded frame rows leaked into the max")

    args = dbof_inputs(torch, gen, BATCH, FRAMES, FEATURE_DIM, CLUSTERS,
                       torch.uint8, dev)
    got = dbof_cluster_maxpool_v2(*args)
    want = dbof_cluster_maxpool_plain(*args)
    torch.cuda.synchronize()
    err = rel_check("dbof_cluster_maxpool_v2", got, want)
    del want
    ms = time_ms(torch, lambda: dbof_cluster_maxpool_v2(*args), 10, flush)
    plain_ms = time_ms(torch, lambda: dbof_cluster_maxpool_plain(*args), 3,
                       flush)
    library_ms = time_ms(torch, lambda: dbof_library(torch, *args), 5,
                         flush)
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
    """The MoE head's inputs, the weights as the pitched views (row
    stride a multiple of 8) that MoeHead's serving constants are."""
    from yt8m_tpu_torch.kernels.moe_head import pitched

    x = torch.randn(b, h, generator=gen).abs()
    wg = (torch.randn(h, c * (m + 1), generator=gen) * h ** -0.5)
    we = (torch.randn(h, c * m, generator=gen) * h ** -0.5)
    be = 0.1 * torch.randn(c * m, generator=gen)
    return [x.to(dev), pitched(wg.to(torch.bfloat16).to(dev)),
            pitched(we.to(torch.bfloat16).to(dev)), be.to(dev)]


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

    # Edge cases, the weights as pitched views (C*(M+1) no multiple of 8):
    # B, C and H cutting the TMA + wgmma tiles (H a multiple of 32, not
    # of 64), M of each compiled tile and of the run-time one.
    for b, h, c, m in ((37, 64, 83, 1), (70, 96, 45, 2), (5, 32, 33, 4),
                       (131, 160, 83, 2), (129, 96, 4716, 5),
                       (E2E_BATCH, VLAD_HIDDEN + LSTM_CELLS, CLASSES,
                        MIXTURES)):
        args = moe_inputs(torch, gen, b, h, c, m, dev)
        rel_check(f"moe edge B={b} H={h} C={c} M={m}",
                  moe_head_serving(*args, m), moe_head_plain(*args, m))
    # Logits far outside [-80, 80]: the clamp must keep every ratio finite.
    from yt8m_tpu_torch.kernels.moe_head import pitched

    x, wg, we, be = moe_inputs(torch, gen, 16, 64, 40, 2, dev)
    wg = pitched((wg.to(torch.float32) * 400).to(torch.bfloat16))
    got = moe_head_serving(x, wg, we, be, 2)
    check(bool(torch.isfinite(got).all()), "moe: non-finite with big logits")
    rel_check("moe clamp case", got, moe_head_plain(x, wg, we, be, 2))

    say_row(f"DbofModel B={BATCH} H={HIDDEN}",
            moe_at(torch, gen, dev, flush, BATCH, HIDDEN))
    return moe_at(torch, gen, dev, flush, FLAG_BATCH,
                  VLAD_HIDDEN + LSTM_CELLS)


def topk_at(torch, gen, dev, flush, b, k=TOP_K) -> dict:
    """exact_topk against its plain version on [B, 4716] scores with NaN,
    -inf, ties, -3.4e38 rows and a row of +-0.0 among negative scores
    planted: equality (the +-0.0 row also against the plain version on
    the CPU, values by their bits: the card's sort may order the two
    zeros by their bits), times (the profiler's device time and CUDA
    events), bound."""
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
    x[6] = -torch.rand(CLASSES, generator=gen)
    x[6, 1::5] = 0.0
    x[6, ::5] = -0.0
    zeros = x[6:7].clone()
    x = x.to(dev)
    gv, gi = exact_topk(x, k)
    pv, pi = exact_topk_plain(x, k)
    torch.cuda.synchronize()
    rows = torch.arange(b, device=dev) != 6
    check(torch.equal(gv[rows], pv[rows]),
          f"exact_topk B={b} k={k} values differ from plain")
    check(torch.equal(gi[rows], pi[rows]),
          f"exact_topk B={b} k={k} indices differ from plain")
    zv, zi = exact_topk_plain(zeros, k)
    check(torch.equal(gv[6:7].cpu().view(torch.int32), zv.view(torch.int32))
          and torch.equal(gi[6:7].cpu(), zi),
          f"exact_topk B={b} k={k}: the +-0.0 row differs from the plain "
          f"version on the CPU")
    check(int(gi.min()) >= 0 and int(gi.max()) < CLASSES,
          "exact_topk index out of range")
    ms_events = time_ms(torch, lambda: exact_topk(x, k), 20, flush)
    us = device_us(torch, lambda: exact_topk(x, k), "exact_topk")
    plain_ms = time_ms(torch, lambda: exact_topk_plain(x, k), 5, flush)
    library_ms = time_ms(torch, lambda: torch.topk(x, k, dim=1), 20,
                         flush)
    nbytes = b * CLASSES * 4 + b * k * 8
    bound_ms, bound_by = bound(b * CLASSES, nbytes, PEAK_F32_FLOPS)
    return {
        "name": "exact_topk", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/topk.cu",
        "replaces": "yt8m_tpu/kernels/topk.py:75",
        "max_abs_err": 0.0, "ms": us / 1e3, "ms_events": ms_events,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def check_topk(torch, gen, dev, flush) -> dict:
    """Edge cases, then DbofModel's B=2048 and eval's k=64 at B=512
    (printed) and the flagship's B=512, k=20 (the row), as for the MoE
    head."""
    from yt8m_tpu_torch.kernels.topk import exact_topk, exact_topk_plain

    for b, c, k in ((3, 20, 20), (37, 301, 20), (5, 4716, 128), (8, 7, 1),
                    (6, 4715, 20), (4, 128, 128), (6, 4716, 64)):
        xs = torch.rand(b, c, generator=gen).to(dev)
        xs[0, : c // 2] = xs[0, 0]
        gv, gi = exact_topk(xs, k)
        pv, pi = exact_topk_plain(xs, k)
        check(torch.equal(gv, pv) and torch.equal(gi, pi),
              f"exact_topk edge B={b} C={c} k={k} differs from plain")
    for b, k in ((BATCH, TOP_K), (FLAG_BATCH, 64)):
        row = topk_at(torch, gen, dev, flush, b, k)
        say_row(f"B={b} k={k} (events {row['ms_events']:.4f} ms)", row)
    row = topk_at(torch, gen, dev, flush, FLAG_BATCH)
    say("kernel", f"exact_topk B={FLAG_BATCH} k={TOP_K}: profiler "
                  f"{row['ms']:.4f} ms, CUDA events {row['ms_events']:.4f} "
                  f"ms")
    return row


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

    # Edges, then the two warpgroups' split of K: K = 512, and K = 264
    # (a second half of 8 clusters in a chain of 256).
    for b, f, d, k, dt in ((5, 13, 128, 8, torch.uint8),
                           (4, 70, 256, 136, torch.float32),
                           (2, 1, 128, 64, torch.uint8),
                           (8, FLAG_FRAMES, FEATURE_DIM, 512, torch.float32),
                           (8, FLAG_FRAMES, 256, 264, torch.uint8)):
        args = vlad_inputs(torch, gen, b, f, d, k, dt, dev)
        got = netvlad_aggregate(*args)
        if b > 2:
            check(bool(torch.all(got[1] == 0)),
                  f"netvlad edge K={k}: num_frames=0 is not exact zeros")
        rel_check(f"netvlad edge B={b} F={f} D={d} K={k} {dt}", got,
                  netvlad_aggregate_plain(*args), rel=VLAD_REL, abs_=1e-6)
    shape = (FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM, VLAD_CLUSTERS)
    errs, times, split = {}, {}, {}
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
        split[dt] = device_kernels(torch, lambda: netvlad_aggregate(*args),
                                   "nv_serve")
    for dt, seen in split.items():
        say("kernel", f"netvlad_aggregate {dt} by launch (profiler): "
                      f"{sum(seen.values()) / 1e3:.4f} ms = " + " + ".join(
                          f"{us / 1e3:.4f} "
                          f"{key[key.find('nv_serve'):].split('(')[0]}"
                          for key, us in seen.items()))
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
        "max_abs_err": max(errs.values()),
        "ms": sum(split[torch.float32].values()) / 1e3,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_events": times[torch.float32],
    }


def lstm_inputs(torch, gen, f, b, h, dev):
    xp = (0.5 * torch.randn(f, b, 4 * h, generator=gen)).to(torch.bfloat16)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    wh = (torch.randn(h, 4 * h, generator=gen) * h ** -0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(4 * h, generator=gen)
    return [t.to(dev) for t in (xp, nf, wh, bias)]


def live_residuals(torch, what, got, want, nf, reverse):
    """A trainable forward's residuals [F, B, X] on the card: exactly 0 at
    the frozen (step, row) pairs, which the kernel does not compute (the
    plain version computes every step; every use of a frozen step's gates
    is masked). (got, want) at the live pairs, for the comparison."""
    from yt8m_tpu_torch.kernels._schedule import live_pairs

    live = live_pairs(nf, got.shape[0], reverse)
    check(bool(torch.all(got[~live] == 0)),
          f"{what}: a residual at a frozen step is not 0")
    return got[live], want[live]


def lstm_check(torch, name, got, want) -> float:
    err = 0.0
    for g, w in zip((got[0], *got[1]), (want[0], *want[1])):
        e = (g - w).abs().max().item()
        bound_ = LSTM_TOL * max(1.0, w.abs().max().item())
        check(math.isfinite(e) and e <= bound_,
              f"{name}: max|diff| {e:.3e} > {bound_:.3e}")
        err = max(err, e)
    return err


# Edge shapes of the serving recurrences, each both directions: (F, B, H,
# num_frames): "ragged" keeps the inputs' draw (uniform in 1..F with F, 0
# and 1 planted), "dead" sets every row to 0, "live" every row to F,
# "outside" draws them uniform in -F..2F (a row at or below 0 is dead).
# The small, odd and ragged ones draw from the phases' shared generator,
# as they always have; the persistent kernels' edges (every row dead or
# live, num_frames out of range, B = 1, B = 2048) draw from their own, so
# that the later phases keep their inputs.
RECURRENCE_EDGES = ((13, 5, 64, "ragged"), (40, 130, 192, "ragged"),
                    (1, 1, 64, "ragged"))
PERSISTENT_EDGES = ((40, 130, 1024, "dead"), (40, 130, 1024, "live"),
                    (40, 130, 1024, "outside"), (30, 1, 1024, "ragged"),
                    (30, 2048, 1024, "ragged"))


def recurrence_edges(torch, name, fn, plain, make, state, edges) -> None:
    """fn against plain at each edge shape, both directions: one launch a
    call, LSTM_TOL, and a dead row's outputs and state 0. make(f, b, h)
    gives the inputs, state(result) the final h."""
    for f, b, h, frames in edges:
        for rev in (False, True):
            args = make(f, b, h)
            nf = next(a for a in args if a.dtype == torch.int32)
            if frames == "dead":
                nf.zero_()
            elif frames == "live":
                nf.fill_(f)
            elif frames == "outside":
                nf.copy_(torch.randint(-f, 2 * f + 1, nf.shape,
                                       generator=torch.Generator()
                                       .manual_seed(f * b),
                                       dtype=torch.int32))
            before = fn.launches
            got = fn(*args, reverse=rev)
            check(fn.launches == before + 1,
                  f"{name} F={f} B={b} H={h}: {fn.launches - before} "
                  f"launches, want 1")
            want = plain(*args, reverse=rev)
            what = f"{name} edge F={f} B={b} H={h} {frames} reverse={rev}"
            err = recurrence_check(what, [(got[0], want[0]),
                                          (state(got), state(want))])
            dead = nf <= 0
            check(bool(torch.all(got[0][:, dead] == 0))
                  and bool(torch.all(state(got)[dead] == 0)),
                  f"{what}: a row with num_frames <= 0 moved")
            say("kernel", f"{what}: 1 launch, max|diff| {err:.3e}")
            del got, want, args


def persist_report(torch, name, plan, barriers_only, barriers, live, ms,
                   flush, b, h, products) -> dict:
    """What a call of a persistent recurrence spends, at the main path's
    shape: us a step and the grid barriers' share (barriers_only runs the
    kernel with its products and cell updates skipped), both measured and
    returned; and, printed only, the tiling's model of the work: the
    32-row chunks the schedule computes (live [F], the rows live at each
    step) against B * F, and the L2 -> SM bytes a step (each unit tile
    reads each computed row of a product's operand once: `products` holds
    (rows [F], depth) of each product of a step). No counter measures
    those bytes."""
    f = live.shape[0]
    bar_ms = time_ms(torch, barriers_only, 5, flush)

    def chunks(rows):
        return int(((rows.to(torch.int64) + 31) // 32).sum())

    tiles = h // 16
    computed = chunks(live)
    l2_mean = sum(tiles * chunks(r) * 32 * k * 2 for r, k in products) / f
    l2_full = sum(tiles * b * k * 2 for _, k in products)
    weights = ("resident, read once a call" if plan["resident"]
               else "streamed every round of rows")
    say("kernel", f"{name}: 1 launch a call, plan {plan}; "
                  f"{ms / f * 1e3:.2f} us a step; the schedule and "
                  f"{barriers} barriers alone {bar_ms:.4f} ms "
                  f"({bar_ms / barriers * 1e3:.2f} us a barrier, "
                  f"{bar_ms / ms:.3f} of the call); weights {weights}")
    say("kernel", f"{name}, the tiling's model (computed from the schedule, "
                  f"not measured): {computed} row chunks of 32 computed = "
                  f"{computed * 32} rows of B * F = {b * f} "
                  f"({computed * 32 / (b * f):.3f}); operands read L2 -> SM "
                  f"{l2_mean / 2**20:.2f} MiB a step on average "
                  f"({l2_full / 2**20:.2f} MiB with every row live)")
    return {"us_per_step": ms / f * 1e3, "barrier_ms": bar_ms,
            "barrier_share": bar_ms / ms}


def step_rows(torch, nf, f):
    """(live [F], product_rows [F]) of the forward-direction schedule."""
    from yt8m_tpu_torch.kernels._schedule import live_schedule, product_rows

    live = live_schedule(nf, f)[1]
    return live, product_rows(live)


def check_lstm(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.lstm import (
        lstm_recurrence,
        lstm_recurrence_plain,
    )

    from yt8m_tpu_torch.kernels import lstm as tlstm

    # H = 2048: a unit tile's W_h columns (256 KB) do not fit the shared
    # weight area; the same kernel streams them.
    check(tlstm.plan(96, 2048)["resident"] == 0
          and tlstm.plan(FLAG_BATCH, LSTM_CELLS)["resident"] == 1,
          "lstm: want resident weights at H=1024, streamed at H=2048")
    edge_gen = torch.Generator().manual_seed(11)
    for g, edges in ((gen, RECURRENCE_EDGES),
                     (edge_gen, PERSISTENT_EDGES + ((30, 96, 2048, "ragged"),))):
        recurrence_edges(torch, "lstm", lstm_recurrence, lstm_recurrence_plain,
                         lambda f, b, h: lstm_inputs(torch, g, f, b, h, dev),
                         lambda r: r[1][1], edges)
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
    ms_reverse = time_ms(torch, lambda: lstm_recurrence(*args, reverse=True),
                         5, flush)
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
    busy_us = device_us(torch, lambda: lstm_recurrence(*args),
                        "lstm_persist")
    say("kernel", f"lstm_recurrence B={FLAG_BATCH} F={FLAG_FRAMES} "
                  f"H={LSTM_CELLS}: {ms:.4f} ms forward, {ms_reverse:.4f} ms "
                  f"reverse (events), {busy_us / 1e3:.4f} ms device time "
                  f"(profiler); one cuDNN LSTM layer {library_ms:.4f} ms; "
                  f"plain {plain_ms:.4f} ms")
    f, b = FLAG_FRAMES, FLAG_BATCH
    live, _ = step_rows(torch, nf, f)
    report = persist_report(torch, "lstm_recurrence", tlstm.plan(b, h),
                            lambda: tlstm.barriers_only(*args), f - 1, live,
                            ms, flush, b, h, [(live, h)])

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
        "library_ms": library_ms, "ms_reverse": ms_reverse,
        "device_ms": busy_us / 1e3, **report,
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


def live_witness(torch, what, kernel, plain, nf, reverse) -> None:
    """rounding_witness on a trainable forward's residuals at the live
    (step, row) pairs; exactly 0 at the frozen ones (live_residuals)."""
    rounding_witness(f"{what} (live pairs)",
                     *live_residuals(torch, what, kernel, plain, nf, reverse))


def rounding_witness(what, kernel, plain) -> None:
    """A kernel's bf16 stream against the plain f32 values computed on that
    stream (kernels/lstm_train.py :: rounding_report): the values that
    differ sit at bf16 rounding boundaries (median distance from the
    midpoint <= 2^-14 of the value) and what one bf16 step does not
    explain is <= 1e-3 * max|ref|; values more than one step apart are
    counted, not refused."""
    from yt8m_tpu_torch.kernels.lstm_train import rounding_report

    r = rounding_report(kernel, plain)
    check(r.median <= 2.0 ** -14 and r.excess <= 1e-3,
          f"{what}: {r.n} values differ, median distance {r.median:.3e}, "
          f"remainder beyond one bf16 step {r.excess:.3e}")
    say("witness", f"{what}: {r.n} of {kernel.numel()} bf16 values differ "
                   f"from the plain cell on the kernel's stream, plain value "
                   f"{r.median:.3e} (median) of itself from the rounding "
                   f"midpoint; {r.n_far} more than one bf16 step apart (up "
                   f"to {r.far_steps} steps, |value| up to "
                   f"{r.far_value:.3e} of max|ref|); remainder beyond one "
                   f"bf16 step {r.excess:.3e} of max|ref| (bound 1e-3)")


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
        rounding_witness(f"{name} reverse={reverse} {stream}", kernel, plain)

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
    live_witness(torch, f"{name} reverse={reverse} trainable gates", gates,
                 gs, nf, reverse)
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


def bracketed_window(torch, fn, pad: float):
    """(prof, whole): a torch.profiler window around one call of fn, with
    `pad` seconds of idle card either side, and whether it is known to
    hold all of fn's kernels.

    A window can lose kernels, never add one: on the card, windows lost a
    run of a call's kernels (the first ~6 ms of a 12 ms serving step, in
    three windows in a row, late in a long process; a one-kernel call, in
    five). So fn sits between two sentinel kernels (torch.cuda._sleep's
    spin_kernel), each on an idle card: a window that holds both is
    whole at its edges. Where a window is not, the callers read another
    (a wider idle did not bring the sentinels back where they were lost
    mid-run, so the idle grows only a little)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(pad)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(pad)
    sentinels = sum(e.count for e in prof.key_averages()
                    if "spin_kernel" in e.key
                    and e.self_device_time_total > 0)
    return prof, sentinels == 2


def device_kernels(torch, fn, needle) -> dict:
    """Device time (us) by kernel name of the kernels whose name holds
    `needle` (or one of a tuple of needles) in one call of fn
    (torch.profiler): the first whole window that saw them (see
    bracketed_window), else the fullest of five; where none saw them, the
    call's CUDA-event time under one key that says so."""
    needles = (needle,) if isinstance(needle, str) else needle
    best = {}
    for attempt in range(5):
        prof, whole = bracketed_window(torch, fn, 0.02 * (attempt + 1))
        seen = {e.key: e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total > 0
                and any(n in e.key for n in needles)}
        if seen and whole:
            return seen
        if sum(seen.values()) > sum(best.values()):
            best = seen
    if best:
        say("profile", f"no window of 5 around the {needles} call was whole "
                       f"at its edges: the fullest")
        return best
    # Where the profiler shows no device time, CUDA events instead (they
    # include the wrapper's host work): the f32 dequant_affine_matmul's
    # one kernel was lost in 5 windows in a row on the card.
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    us = statistics.median(times) * 1e3
    say("kernel", f"the profiler saw no kernel named {needles} in 5 "
                  f"windows: CUDA events instead, {us / 1e3:.4f} ms a call "
                  f"(host work included)")
    return {f"{'|'.join(needles)} (CUDA events, not the profiler)": us}


def launch_split(split: dict) -> str:
    """device_kernels' times by kernel, in ms, the largest first, each
    name cut to its kernel's (nxv_cluster_kernel<128>, ...)."""
    def short(key):
        m = re.search(r"(nxv_\w+(?:<[^>]*>)?)", key)
        return m.group(1) if m else key[:60]
    return "; ".join(f"{short(k)} {v / 1e3:.4f}" for k, v in
                     sorted(split.items(), key=lambda kv: -kv[1]))


def device_us(torch, fn, needle) -> float:
    """The summed device time (us) of device_kernels."""
    return sum(device_kernels(torch, fn, needle).values())


def check_lstm_train(torch, gen, dev, flush) -> dict:
    """lstm_recurrence_trainable at the flagship's training shape (B=256,
    F=300, H=1024), both directions: the CUDA forward's outputs, final
    state and residuals and the CUDA backward's dZ against the plain
    versions on the same inputs; the Function's dx_proj, dW_h and db
    against the plain forward, backward and weight gradients for fixed
    random cotangents; planted hazards; the witness; times and bounds."""
    from yt8m_tpu_torch.kernels import lstm as tlstm
    from yt8m_tpu_torch.kernels import lstm_train as tlt

    f, b, h = FLAG_FRAMES, TRAIN_BATCH, LSTM_CELLS

    def grads(args, cot, rev):
        xp, nf, wh, bias = args
        x = xp.clone().requires_grad_()
        w = wh.float().requires_grad_()
        bb = bias.clone().requires_grad_()
        before = (tlt.lstm_train_forward.launches,
                  tlt.lstm_train_backward.launches)
        outs, (fc, fh) = tlt.lstm_recurrence_trainable(x, nf, w, bb, rev)
        loss = sum((o * c).sum() for o, c in zip((outs, fc, fh), cot))
        loss.backward()
        check((tlt.lstm_train_forward.launches - before[0],
               tlt.lstm_train_backward.launches - before[1]) == (1, 1),
              "lstm_recurrence_trainable: want one forward and one "
              "backward launch a call")
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
            if nm == "gates":  # live pairs; 0 where frozen (live_residuals)
                g, w = live_residuals(torch, f"trainable gates reverse={rev}",
                                      g, w, nf, rev)
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
                     "lstm_persist")
    us_b = device_us(torch, lambda: tlt.lstm_train_backward(
        *cot, fwd[1], fwd[2], nf, wh), "lstm_bwd_persist")
    live, prod = step_rows(torch, nf, f)
    rep_f = persist_report(
        torch, "lstm_recurrence_trainable forward", tlstm.plan(b, h),
        lambda: tlt.barriers_only_forward(xp, nf, wh, bias), f - 1, live,
        ms_f, flush, b, h, [(live, h)])
    rep_b = persist_report(
        torch, "lstm_recurrence_trainable backward", tlt.plan(b, h),
        lambda: tlt.barriers_only_backward(*cot, fwd[1], fwd[2], nf, wh),
        f - 1, live, ms_b, flush, b, h, [(prod, 4 * h)])
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
        "barrier_share_forward": rep_f["barrier_share"],
        "barrier_share_backward": rep_b["barrier_share"],
        "call_launches": [1, 1],
    }


def core_inputs(torch, gen, b, f, d, k, dev):
    """netvlad_core's inputs as the flagship's training path makes them:
    x the dequantized uint8 frames, act the assignment product of x's
    bf16 values with its BatchNorm on batch moments (unit scale, with a
    gamma and beta), num_frames uniform in [1, f] with f, 0 and 1
    planted, centers at the initialiser's scale; and a dvlad."""
    from yt8m_tpu_torch.models.frame_utils import ensure_float

    x = ensure_float(torch.randint(0, 256, (b, f, d), generator=gen,
                                   dtype=torch.uint8).to(dev))
    w = (torch.randn(d, k, generator=gen) * d ** -0.5).to(torch.bfloat16)
    act = torch.matmul(x.reshape(b * f, d).to(torch.bfloat16),
                       w.to(dev)).to(torch.float32)
    act = (act - act.mean(0)) * torch.rsqrt(act.var(0, unbiased=False) + 1e-3)
    act = (act * (0.5 + torch.rand(k, generator=gen)).to(dev)
           + (0.1 * torch.randn(k, generator=gen)).to(dev)).reshape(b, f, k)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    centers = torch.randn(k, d, generator=gen) * d ** -0.5
    dvlad = torch.randn(b, k, d, generator=gen)
    return [act, x, nf.to(dev), centers.to(dev)], dvlad.to(dev)


def core_grads(torch, args, dvlad, need_x):
    """vlad and the Function's gradients (act, x or None, centers)."""
    from yt8m_tpu_torch.kernels.netvlad_train import netvlad_core

    act, x, nf, centers = args
    a = act.clone().requires_grad_()
    xx = x.clone().requires_grad_(need_x)
    c = centers.clone().requires_grad_()
    vlad = netvlad_core(a, xx, nf, c)
    vlad.backward(dvlad)
    return vlad.detach(), a.grad, xx.grad, c.grad


def check_netvlad_core(torch, gen, dev, flush) -> dict:
    """netvlad_core (--netvlad_fused_train) at the flagship's training
    shape (B=256, F=300, K=256, D=1152) and at small and odd shapes: the
    CUDA forward (vlad, a_sum) and backward (dact, dx) against the plain
    versions on the same inputs, the Function's dact and dcenters, the
    planted hazards, times, bounds and a library yardstick."""
    from yt8m_tpu_torch.kernels import netvlad_train as tnt

    def compare(name, args, dvlad):
        fwd0 = tnt.netvlad_core_forward.launches
        bwd0 = tnt.netvlad_core_backward.launches
        vlad, a_sum = tnt.netvlad_core_forward(*args)
        dact, dx = tnt.netvlad_core_backward(*args, dvlad)
        torch.cuda.synchronize()
        check(tnt.netvlad_core_forward.launches == fwd0 + 1
              and tnt.netvlad_core_backward.launches == bwd0 + 1,
              f"{name}: the kernels did not launch")
        pv, pa = tnt.netvlad_core_plain_forward(*args)
        pda, pdx = tnt.netvlad_core_plain_backward(*args, dvlad)
        errs = [rel_check(f"{name} {what}", g, w, rel=1e-3, abs_=1e-6)
                for what, g, w in (("vlad", vlad, pv), ("a_sum", a_sum, pa),
                                   ("dact", dact, pda), ("dx", dx, pdx))]
        del vlad, dact, dx, pv, pda, pdx
        got = core_grads(torch, args, dvlad, need_x=False)
        check(got[2] is None, f"{name}: dx computed for an x without grad")
        errs.append(rel_check(f"{name} dcenters", got[3],
                              -torch.einsum("bk,bkd->kd", pa, dvlad),
                              rel=1e-3, abs_=1e-6))
        return max(errs)

    for b, f, d, k in ((3, 7, 1000, 100), (5, 70, 1152, 256),
                       (2, 300, 256, 512)):
        args, dvlad = core_inputs(torch, gen, b, f, d, k, dev)
        err = compare(f"netvlad_core B={b} F={f} D={d} K={k}", args, dvlad)
        say("kernel", f"netvlad_core B={b} F={f} D={d} K={k}: forward, "
                      f"backward, dcenters max|diff| {err:.3e}")
    # Shapes that cut the tiles (256 clusters x 128 columns forward, 64
    # frames backward, Kh = 128 or 256): num_frames F, 0 and 1 planted,
    # with and without dx, and the hazards bit for bit. Their own
    # generator: the later phases keep their inputs.
    edge_gen = torch.Generator().manual_seed(14)
    worst = 0.0
    for k in (8, 100, 256, 512):
        for f in (1, 63, 65, 300):
            args, dvlad = core_inputs(torch, edge_gen, 4, f, 264, k, dev)
            name = f"netvlad_core edge F={f} K={k}"
            worst = max(worst, compare(name, args, dvlad))
            act, x, nf, centers = args
            past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
            clean_a, loud_a = pad_hazard(torch, act, past, 3e4)
            clean_x, loud_x = pad_hazard(torch, x, past, -1e5)
            clean = [clean_a, clean_x, nf, centers]
            loud = [loud_a, loud_x, nf, centers]
            same = all(torch.equal(p, q) for p, q in zip(
                tnt.netvlad_core_forward(*clean),
                tnt.netvlad_core_forward(*loud)))
            for need_dx in (True, False):
                got = tnt.netvlad_core_backward(*loud, dvlad, need_dx)
                want = tnt.netvlad_core_backward(*clean, dvlad, need_dx)
                same = same and torch.equal(got[0], want[0])
                check(bool(torch.all(got[0][past] == 0)),
                      f"{name}: dact not 0 past num_frames")
                if need_dx:
                    same = same and torch.equal(got[1], want[1])
                    check(bool(torch.all(got[1][past] == 0)),
                          f"{name}: dx not 0 past num_frames")
            check(same, f"{name}: frames past num_frames moved a result")
            check(bool(torch.all(tnt.netvlad_core_forward(*loud)[0][1] == 0)),
                  f"{name}: num_frames=0 is not 0")
    say("kernel", f"netvlad_core edges K in (8, 100, 256, 512) x F in (1, 63, "
                  f"65, 300): forward, backward with and without dx within "
                  f"1e-3 * max|ref| + 1e-6 (max|diff| {worst:.3e}); hazards "
                  f"bit-identical")
    b, f, d, k = TRAIN_BATCH, FLAG_FRAMES, FEATURE_DIM, VLAD_CLUSTERS
    args, dvlad = core_inputs(torch, gen, b, f, d, k, dev)
    err = compare("netvlad_core", args, dvlad)
    act, x, nf, centers = args
    # Hazards: large finite act and x past num_frames leave vlad and every
    # gradient bit for bit those of zeros there; dact and dx are zeros
    # past num_frames; num_frames = 0 (video 1) gives vlad = 0.
    past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
    clean_a, loud_a = pad_hazard(torch, act, past, 3e4)
    clean_x, loud_x = pad_hazard(torch, x, past, -1e5)
    a = core_grads(torch, [clean_a, clean_x, nf, centers], dvlad, True)
    c = core_grads(torch, [loud_a, loud_x, nf, centers], dvlad, True)
    check(all(torch.equal(p, q) for p, q in zip(a, c)),
          "netvlad_core: frames past num_frames moved vlad or a gradient")
    check(bool(torch.all(c[1][past] == 0)) and bool(torch.all(c[2][past] == 0)),
          "netvlad_core: dact or dx not 0 past num_frames")
    check(bool(torch.all(c[0][1] == 0)), "netvlad_core: num_frames=0 is not 0")
    del a, c, clean_a, loud_a, clean_x, loud_x
    say("kernel", f"netvlad_core B={b} F={f} D={d} K={k}: forward, backward, "
                  f"dcenters within 1e-3 * max|ref| + 1e-6 (max|diff| "
                  f"{err:.3e}); hazards bit-identical, zeros past "
                  f"num_frames")

    ms_f = time_ms(torch, lambda: tnt.netvlad_core_forward(*args), 10, flush)
    ms_b = time_ms(torch, lambda: tnt.netvlad_core_backward(
        *args, dvlad, False), 10, flush)
    ms_bdx = time_ms(torch, lambda: tnt.netvlad_core_backward(
        *args, dvlad, True), 10, flush)
    us_f = device_us(torch, lambda: tnt.netvlad_core_forward(*args),
                     ("vlad_assign", "vlad_fwd"))
    us_b = device_us(torch, lambda: tnt.netvlad_core_backward(
        *args, dvlad, False), "vlad_bwd")
    plain_f = time_ms(torch, lambda: tnt.netvlad_core_plain_forward(*args), 3,
                      flush)
    plain_b = time_ms(torch, lambda: tnt.netvlad_core_plain_backward(
        *args, dvlad, False), 3, flush)
    mask = past.logical_not()[:, :, None]

    def library_forward(a):
        p = torch.softmax(a, -1) * mask
        v = torch.matmul(p.to(torch.bfloat16).transpose(1, 2),
                         x.to(torch.bfloat16)).to(torch.float32)
        return v - p.sum(1)[:, :, None] * centers

    def library():
        a = act.detach().requires_grad_()
        library_forward(a).backward(dvlad)

    with torch.no_grad():
        lib_f = time_ms(torch, lambda: library_forward(act), 5, flush)
    library_ms = time_ms(torch, library, 5, flush)

    live = int(nf.clamp(0, f).sum())  # this run's live frames
    f_flops = 2.0 * live * k * d
    # Forward: live act and x rows read, centers, vlad and a_sum written.
    f_bytes = live * (k + d) * 4 + 4 * b + k * d * 4 + b * k * d * 4 + b * k * 4
    # Backward without dx (the main path's): live act and x rows, dvlad,
    # centers read, dact written for every row.
    b_bytes = live * (k + d) * 4 + 4 * b + k * d * 4 + b * k * d * 4 + b * f * k * 4
    bound_f = bound(f_flops, f_bytes, PEAK_BF16_FLOPS)
    bound_b = bound(f_flops, b_bytes, PEAK_BF16_FLOPS)
    bound_bdx = bound(2 * f_flops, b_bytes + b * f * d * 4, PEAK_BF16_FLOPS)
    bound_ms, bound_by = bound(2 * f_flops, f_bytes + b_bytes,
                               PEAK_BF16_FLOPS)
    say("kernel", f"netvlad_core B={b} F={f} K={k} D={d}: forward {ms_f:.4f} "
                  f"ms (profiler {us_f / 1e3:.4f} ms), backward without dx "
                  f"{ms_b:.4f} ms (profiler {us_b / 1e3:.4f} ms, the bf16(dvlad) "
                  f"pass included), with dx {ms_bdx:.4f} ms; bounds for this "
                  f"run's {live} live frames {bound_f[0]:.4f} ms by "
                  f"{bound_f[1]}, {bound_b[0]:.4f} ms by {bound_b[1]}, "
                  f"{bound_bdx[0]:.4f} ms by {bound_bdx[1]} with dx; plain "
                  f"{plain_f:.4f} + {plain_b:.4f} ms; library (bf16 matmul +"
                  f" softmax) forward {lib_f:.4f} ms, forward + autograd "
                  f"backward {library_ms:.4f} ms")
    del args, dvlad, act, x
    return {
        "name": "netvlad_core", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/netvlad_train.cu",
        "replaces": "yt8m_tpu/kernels/netvlad_train.py:208",
        "max_abs_err": err, "ms": ms_f + ms_b, "plain_ms": plain_f + plain_b,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_forward": ms_f, "ms_backward": ms_b,
        "ms_backward_with_dx": ms_bdx, "device_ms_forward": us_f / 1e3,
        "device_ms_backward": us_b / 1e3,
        "device_ms": (us_f + us_b) / 1e3,
    }


# ---------------------------------------------------------------------------
# phase 3 (cont.): the GRU recurrences and attention pooling
# ---------------------------------------------------------------------------


def gru_inputs(torch, gen, f, b, h, dev):
    """xg, xc, num_frames (with f, 0 and 1 planted), bf16 W_hg and W_hc,
    the gate bias around its initial 1 and the candidate bias."""
    xg = (0.5 * torch.randn(f, b, 2 * h, generator=gen)).to(torch.bfloat16)
    xc = (0.5 * torch.randn(f, b, h, generator=gen)).to(torch.bfloat16)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    whg = (torch.randn(h, 2 * h, generator=gen) * h ** -0.5).to(torch.bfloat16)
    whc = (torch.randn(h, h, generator=gen) * h ** -0.5).to(torch.bfloat16)
    bg = 1.0 + 0.1 * torch.randn(2 * h, generator=gen)
    bc = 0.1 * torch.randn(h, generator=gen)
    return [t.to(dev) for t in (xg, xc, nf, whg, whc, bg, bc)]


def gru_hazard(torch, args, rev):
    """(clean, loud, past): the GRU's args with xg and xc zero, and +-1e4,
    at the steps past num_frames (flipped in time when reversed)."""
    xg, xc, nf = args[:3]
    past = torch.arange(xg.shape[0], device=xg.device)[:, None] >= nf[None, :]
    if rev:
        past = past.flip(0)
    clean, loud = [], []
    for x in (xg, xc):
        sign = torch.where(torch.arange(x.shape[2], device=x.device) % 2 == 0,
                           1e4, -1e4).to(x.dtype)
        c, n = pad_hazard(torch, x, past, sign)
        clean.append(c)
        loud.append(n)
    return clean + list(args[2:]), loud + list(args[2:]), past


def recurrence_check(name, pairs) -> float:
    """LSTM_TOL * max(1, max|ref|) on each (got, want); the largest
    error."""
    err = 0.0
    for g, w in pairs:
        e = (g.float() - w.float()).abs().max().item()
        bound_ = LSTM_TOL * max(1.0, w.float().abs().max().item())
        check(math.isfinite(e) and e <= bound_,
              f"{name}: max|diff| {e:.3e} > {bound_:.3e}")
        err = max(err, e)
    return err


def gru_witness(torch, name, args, reverse) -> None:
    """Why the GRU bounds are 2e-2 and not 1e-3. The serving kernel run
    one step at a time: fed the kernel's own state, the plain cell's u
    and f32 h meet 1e-3 * max|ref| + 1e-6, and bf16(r * h) and the
    outputs round to the kernel's values except at bf16 rounding
    boundaries (median distance from the midpoint <= 2^-14 of the value;
    what one bf16 step does not explain <= 1e-3 * max|ref|). The
    trainable forward equals those steps bit for bit; its gates and
    candidate, and the backward's dA_g and dA_c, fed their own bf16
    streams, differ from the plain cell in the same way only."""
    from yt8m_tpu_torch.kernels import gru_train as tgt

    xg, xc, nf, whg, whc, bg, bc = args

    def report(stream, kernel, plain):
        rounding_witness(f"{name} reverse={reverse} {stream}", kernel, plain)

    kern, plain = tgt.forward_steps_on_card(*args, reverse)
    for what in ("u", "h"):
        err = rel_check(f"{name} step by step {what}", kern[what],
                        plain[what], rel=1e-3, abs_=1e-6)
        say("witness", f"{name} reverse={reverse} step by step {what} (f32):"
                       f" max|diff| {err:.3e} (1e-3 bound "
                       f"{1e-3 * plain[what].abs().max().item() + 1e-6:.3e})")
    report("serving bf16(r * h)", kern["rh"], plain["rh"])
    report("serving outputs", kern["out"], plain["h"])
    outs, gates, cand, h = tgt.gru_train_forward(*args, reverse)
    check(torch.equal(outs, kern["out"]) and torch.equal(h, kern["h"][-1]),
          f"{name}: the trainable forward differs from the serving steps")
    gp, cp = tgt.residuals_on_stream(outs, kern["rh"], xg, xc, whg, whc, bg,
                                     bc)
    del kern, plain
    for stream, kernel, plain in (("gates", gates, gp),
                                  ("candidate", cand, cp)):
        live_witness(torch, f"{name} reverse={reverse} trainable {stream}",
                     kernel, plain, nf, reverse)
    del gp, cp
    g = torch.Generator(device=xg.device).manual_seed(5)
    f, b, hd = outs.shape
    cot = [torch.randn((f, b, hd), generator=g, device=xg.device),
           torch.randn((b, hd), generator=g, device=xg.device)]
    dag, dac = tgt.gru_train_backward(*cot, gates, cand, outs, nf, whg, whc,
                                      reverse)
    sg, sc = tgt.backward_on_stream(dag, dac, *cot, gates, cand, outs, nf,
                                    whg, whc, reverse)
    report("backward dA_g", dag, sg)
    report("backward dA_c", dac, sc)


def gru_bound(live, f, b, h, live_bytes, step_bytes):
    """(flops, bytes) of a GRU recurrence: the products of `live` (video,
    step) pairs (a frozen step needs none), 2 live H 3H; `live_bytes` for
    each live pair and `step_bytes` for each step, the weights and biases,
    num_frames and one [B, H] f32 state."""
    flops = 2.0 * live * h * 3 * h
    nbytes = (live * live_bytes + f * step_bytes + 3 * h * h * 2 + 3 * h * 4
              + 4 * b + b * h * 4)
    return flops, nbytes


def check_gru(torch, gen, dev, flush) -> dict:
    """gru_recurrence at small, odd and ragged shapes, then at GruModel's
    serving shape (B=512, F=300, H=1024), both directions, against its
    plain version; planted hazards; times, bound and a cuDNN GRU layer."""
    from yt8m_tpu_torch.kernels.gru import (
        gru_recurrence,
        gru_recurrence_plain,
    )

    from yt8m_tpu_torch.kernels import gru as tgru

    check(tgru.plan(FLAG_BATCH, GRU_CELLS)["resident"] == 1,
          "gru: want resident weights at H=1024")
    edge_gen = torch.Generator().manual_seed(12)
    for g, edges in ((gen, RECURRENCE_EDGES + ((9, 7, 96, "ragged"),)),
                     (edge_gen, PERSISTENT_EDGES)):
        recurrence_edges(torch, "gru", gru_recurrence, gru_recurrence_plain,
                         lambda f, b, h: gru_inputs(torch, g, f, b, h, dev),
                         lambda r: r[1], edges)
    f, b, h = FLAG_FRAMES, FLAG_BATCH, GRU_CELLS
    err = 0.0
    for rev in (False, True):
        args = gru_inputs(torch, gen, f, b, h, dev)
        clean, loud, _ = gru_hazard(torch, args, rev)
        got = gru_recurrence(*loud, reverse=rev)
        ref = gru_recurrence(*clean, reverse=rev)
        check(all(torch.equal(a, c) for a, c in zip(got, ref)),
              f"gru reverse={rev}: steps past num_frames moved the carry")
        check(bool(torch.all(got[0][:, 1] == 0))
              and bool(torch.all(got[1][1] == 0)),
              f"gru reverse={rev}: num_frames=0 moved the carry")
        want = gru_recurrence_plain(*loud, reverse=rev)
        torch.cuda.synchronize()
        err = max(err, recurrence_check(f"gru_recurrence reverse={rev}",
                                        zip(got, want)))
        del got, ref, want, clean
    args = loud
    xg, xc, nf, whg, whc, bg, bc = args
    ms = time_ms(torch, lambda: gru_recurrence(*args), 5, flush)
    ms_reverse = time_ms(torch, lambda: gru_recurrence(*args, reverse=True),
                         5, flush)
    plain_ms = time_ms(torch, lambda: gru_recurrence_plain(*args), 2, flush)
    busy_us = device_us(torch, lambda: gru_recurrence(*args), "gru_persist")
    live, _ = step_rows(torch, nf, f)
    report = persist_report(torch, "gru_recurrence", tgru.plan(b, h),
                            lambda: tgru.barriers_only(*args), 2 * f - 1,
                            live, ms, flush, b, h, [(live, h), (live, h)])

    # Yardstick: one cuDNN GRU layer over the packed sequence, the input
    # projection included, timed only: cuDNN applies r after the hidden
    # product (r * (h @ W_hc)), a different function of the same size.
    d = FEATURE_DIM
    frames = torch.randn(f, b, d, device=dev, dtype=torch.bfloat16)
    wx = (torch.randn(d, 3 * h, device=dev) * d ** -0.5).to(torch.bfloat16)
    cudnn = torch.nn.GRU(d, h, device=dev, dtype=torch.bfloat16)
    cudnn.flatten_parameters()
    lengths = torch.clamp(nf, min=1).cpu()

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            frames, lengths, enforce_sorted=False)
        with torch.no_grad():
            return cudnn(packed)

    def port_with_projection():
        xp = torch.matmul(frames, wx)
        return gru_recurrence(xp[..., :2 * h].contiguous(),
                              xp[..., 2 * h:].contiguous(), nf, whg, whc, bg,
                              bc)

    library_ms = time_ms(torch, library, 5, flush)
    port_ms = time_ms(torch, port_with_projection, 5, flush)
    say("kernel", f"gru: input projections + kernel {port_ms:.4f} ms vs one "
                  f"cuDNN GRU layer (projection included; r after the "
                  f"product) {library_ms:.4f} ms")
    say("kernel", f"gru_recurrence B={b} F={f} H={h}: {ms:.4f} ms forward, "
                  f"{ms_reverse:.4f} ms reverse (events), "
                  f"{busy_us / 1e3:.4f} ms device time (profiler); one cuDNN "
                  f"GRU layer {library_ms:.4f} ms; plain {plain_ms:.4f} ms")
    live = int(nf.sum())  # this run's live (video, step) pairs
    # xg and xc read for live steps, the outputs written for every step.
    bound_ms, bound_by = bound(*gru_bound(live, f, b, h, 3 * h * 2,
                                          b * h * 2), PEAK_BF16_FLOPS)
    full_ms = bound(*gru_bound(b * f, f, b, h, 3 * h * 2, b * h * 2),
                    PEAK_BF16_FLOPS)[0]
    say("kernel", f"gru_recurrence bounds: {bound_ms:.4f} ms by {bound_by} "
                  f"for this run's {live} live steps; {full_ms:.4f} ms for "
                  f"all {b * f}")
    del frames, cudnn
    return {
        "name": "gru_recurrence", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/gru.cu",
        "replaces": "yt8m_tpu/kernels/gru.py:98",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_reverse": ms_reverse,
        "device_ms": busy_us / 1e3, **report,
    }


def check_gru_train(torch, gen, dev, flush) -> dict:
    """gru_recurrence_trainable at GruModel's training shape (B=256,
    F=300, H=1024), both directions: the CUDA forward's outputs, final h
    and residuals and the CUDA backward's dA_g and dA_c against the plain
    versions on the same inputs; the Function's dxg, dxc, dW_hg, dW_hc,
    dbg and dbc against the plain forward, backward and weight gradients
    for fixed random cotangents; planted hazards; the witness; times and
    bounds beside one cuDNN GRU layer's forward and backward."""
    from yt8m_tpu_torch.kernels import gru as tgru
    from yt8m_tpu_torch.kernels import gru_train as tgt

    f, b, h = FLAG_FRAMES, TRAIN_BATCH, GRU_CELLS

    def grads(args, cot, rev):
        xg, xc, nf, whg, whc, bg, bc = args
        ps = [xg.clone().requires_grad_(), xc.clone().requires_grad_(),
              whg.float().requires_grad_(), whc.float().requires_grad_(),
              bg.clone().requires_grad_(), bc.clone().requires_grad_()]
        before = (tgt.gru_train_forward.launches,
                  tgt.gru_train_backward.launches)
        outs, fh = tgt.gru_recurrence_trainable(ps[0], ps[1], nf, *ps[2:],
                                                rev)
        ((outs * cot[0]).sum() + (fh * cot[1]).sum()).backward()
        check((tgt.gru_train_forward.launches - before[0],
               tgt.gru_train_backward.launches - before[1]) == (1, 1),
              "gru_recurrence_trainable: want one forward and one backward "
              "launch a call")
        return [outs.detach(), fh.detach()] + [p.grad for p in ps]

    def plain_grads(args, cot, rev):
        xg, xc, nf, whg, whc, bg, bc = args
        outs, gates, cand, hh = tgt.gru_train_forward_plain(*args, rev)
        dag, dac = tgt.gru_train_backward_plain(*cot, gates, cand, outs, nf,
                                                whg, whc, rev)
        return [outs.float(), hh, dag.float(), dac.float(),
                *tgt.weight_grads(outs, gates, dag, dac)]

    names = ("outputs", "final h", "dxg", "dxc", "dW_hg", "dW_hc", "dbg",
             "dbc")
    err = 0.0
    for rev in (False, True):
        args = gru_inputs(torch, gen, f, b, h, dev)
        xg, xc, nf, whg, whc, bg, bc = args
        got = tgt.gru_train_forward(*args, rev)
        pairs = list(zip(got, tgt.gru_train_forward_plain(*args, rev)))
        for i in (1, 2):  # gates, candidate: live pairs; 0 where frozen
            pairs[i] = live_residuals(torch, f"gru trainable residual {i} "
                                             f"reverse={rev}", *pairs[i],
                                      nf, rev)
        err = max(err, recurrence_check(
            f"trainable forward (outputs, gates, candidate, h) reverse={rev}",
            pairs))
        del pairs
        g = torch.Generator().manual_seed(11 + rev)
        cot = [torch.randn(f, b, h, generator=g).to(dev),
               torch.randn(b, h, generator=g).to(dev)]
        bwd = (*cot, got[1], got[2], got[0], nf, whg, whc, rev)
        err = max(err, recurrence_check(
            f"trainable dA_g, dA_c reverse={rev}",
            zip(tgt.gru_train_backward(*bwd),
                tgt.gru_train_backward_plain(*bwd))))
        del got, bwd
        kg = grads(args, cot, rev)
        pg = plain_grads(args, cot, rev)
        for nm, a, c in zip(names, kg, pg):
            check(bool(torch.isfinite(a).all()), f"trainable {nm}: non-finite")
            err = max(err, recurrence_check(f"trainable {nm} reverse={rev}",
                                            [(a, c)]))
        del kg, pg
        # Hazards: +-1e4 past num_frames leaves outputs and every gradient
        # bit for bit those of zeros there; dA is exactly 0 on frozen steps.
        clean, loud, past = gru_hazard(torch, args, rev)
        a = grads(clean, cot, rev)
        c = grads(loud, cot, rev)
        check(all(torch.equal(x, y) for x, y in zip(a, c)),
              f"gru trainable reverse={rev}: steps past num_frames moved "
              f"the outputs or the gradients")
        check(bool(torch.all(c[2][past] == 0))
              and bool(torch.all(c[3][past] == 0)),
              f"gru trainable reverse={rev}: dA not 0 on frozen steps")
        del a, c, clean, loud
        say("kernel", f"gru_recurrence_trainable reverse={rev}: forward, "
                      f"residuals, dA_g, dA_c, dxg, dxc, dW_hg, dW_hc, dbg, "
                      f"dbc within {LSTM_TOL} * max(1, max|ref|); hazards "
                      f"bit-identical")
        gru_witness(torch, "gru", args, rev)
        torch.cuda.empty_cache()

    xg, xc, nf, whg, whc, bg, bc = args
    outs, gates, cand, _ = tgt.gru_train_forward(*args)
    cot = [torch.randn_like(outs, dtype=torch.float32),
           torch.randn(b, h, device=dev)]
    bwd = (*cot, gates, cand, outs, nf, whg, whc)
    ms_f = time_ms(torch, lambda: tgt.gru_train_forward(*args), 5, flush)
    ms_b = time_ms(torch, lambda: tgt.gru_train_backward(*bwd), 5, flush)
    us_f = device_us(torch, lambda: tgt.gru_train_forward(*args),
                     "gru_persist")
    us_b = device_us(torch, lambda: tgt.gru_train_backward(*bwd),
                     "gru_bwd_persist")
    live, prod = step_rows(torch, nf, f)
    rep_f = persist_report(
        torch, "gru_recurrence_trainable forward", tgru.plan(b, h),
        lambda: tgt.barriers_only_forward(*args), 2 * f - 1, live, ms_f,
        flush, b, h, [(live, h), (live, h)])
    rep_b = persist_report(
        torch, "gru_recurrence_trainable backward", tgt.plan(b, h),
        lambda: tgt.barriers_only_backward(*bwd), 2 * f - 1, live, ms_b,
        flush, b, h, [(prod, 2 * h), (live, h)])
    plain_f = time_ms(torch, lambda: tgt.gru_train_forward_plain(*args), 2,
                      flush)
    plain_b = time_ms(torch, lambda: tgt.gru_train_backward_plain(*bwd), 2,
                      flush)
    dag, dac = tgt.gru_train_backward(*bwd)
    dw_ms = time_ms(torch, lambda: tgt.weight_grads(outs, gates, dag, dac), 5,
                    flush)

    # Yardstick: one cuDNN GRU layer's forward and backward over the packed
    # sequence, the input projection included (r after the hidden product:
    # a different function of the same size), timed only.
    d = FEATURE_DIM
    frames = torch.randn(f, b, d, device=dev, dtype=torch.bfloat16)
    cudnn = torch.nn.GRU(d, h, device=dev, dtype=torch.bfloat16)
    cudnn.flatten_parameters()
    lengths = torch.clamp(nf, min=1).cpu()

    def library():
        packed = torch.nn.utils.rnn.pack_padded_sequence(
            frames, lengths, enforce_sorted=False)
        out, _ = cudnn(packed)
        out.data.float().sum().backward()

    library_ms = time_ms(torch, library, 5, flush)
    live = int(nf.sum())
    # Forward: xg and xc read for live steps; outputs, gates and candidate
    # written for every step. Backward: dout, gates, candidate and outputs
    # read, dA_g and dA_c written for every step.
    f_flops, f_bytes = gru_bound(live, f, b, h, 3 * h * 2, b * 4 * h * 2)
    b_flops, b_bytes = gru_bound(live, f, b, h, 0, b * 8 * h * 2)
    bound_f = bound(f_flops, f_bytes, PEAK_BF16_FLOPS)
    bound_b = bound(b_flops, b_bytes, PEAK_BF16_FLOPS)
    bound_ms, bound_by = bound(f_flops + b_flops, f_bytes + b_bytes,
                               PEAK_BF16_FLOPS)
    say("kernel", f"gru_recurrence_trainable B={b} F={f} H={h}: forward "
                  f"{ms_f:.3f} ms a call (profiler: {us_f / 1e3:.3f} ms of "
                  f"kernel, {us_f / f:.2f} us a step), backward {ms_b:.3f} "
                  f"ms a call ({us_b / 1e3:.3f} ms, {us_b / f:.2f} us a "
                  f"step); bounds {bound_f[0]:.4f} and {bound_b[0]:.4f} ms by"
                  f" {bound_f[1]} for this run's {live} live steps; plain "
                  f"{plain_f:.3f} + {plain_b:.3f} ms; dW + db outside the "
                  f"kernel {dw_ms:.3f} ms; one cuDNN GRU layer forward + "
                  f"backward (projection included) {library_ms:.3f} ms")
    del outs, gates, cand, dag, dac, frames, cudnn, bwd
    return {
        "name": "gru_recurrence_trainable", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/gru_train.cu",
        "replaces": "yt8m_tpu/kernels/gru_train.py:304",
        "max_abs_err": err, "ms": ms_f + ms_b, "plain_ms": plain_f + plain_b,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_forward": ms_f, "ms_backward": ms_b,
        "us_per_step_forward": us_f / f, "us_per_step_backward": us_b / f,
        "barrier_share_forward": rep_f["barrier_share"],
        "barrier_share_backward": rep_b["barrier_share"],
        "call_launches": [1, 1],
    }


def attention_inputs(torch, gen, b, f, d, h, x_dtype, dev):
    """Frames, num_frames uniform in [1, f] with f, 1 and 0 planted, and a
    query [D, H] ~ normal(1/sqrt(D))."""
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=gen,
                          dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=gen)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 1, 0], dtype=torch.int32)[: min(b, 3)]
    q = torch.randn(d, h, generator=gen) * d ** -0.5
    # The bf16 route: the query in bf16, as the model's serving constant.
    return [t.to(dev) for t in (x, nf, q.to(torch.bfloat16))]


def attention_witness(torch, name, args, got, want) -> float:
    """Why attention_pool's kernel and its plain version differ, on the
    card (kernels/attention_pool.py :: rounding_limit): the kernel's own
    bf16 attention weights, recovered from its output, (a) explain it
    within the f32 sums' bound and (b) differ from the plain version's
    only within 2^-14 of a bf16 rounding boundary, by one step; and
    |kernel - plain| stays within the limit (a) and (b) give. Returns the
    largest share of that limit used."""
    from yt8m_tpu_torch.kernels.attention_pool import rounding_limit

    r = rounding_limit(*args, got, want)
    check(r.explained,
          f"{name} witness: the plain product with the kernel's own weights "
          f"misses the kernel's output by {r.explain_err:.3e}, past the f32 "
          f"sums' bound")
    check(r.away == 0,
          f"{name} witness: {r.away} of the kernel's weights differ from "
          f"the plain version's away from a rounding boundary")
    err = (got - want).abs()
    check(bool(torch.all(err <= r.limit)),
          f"{name}: max|diff| {err.max().item():.3e} past the rounding "
          f"witness's limit")
    share = (err / r.limit.clamp(min=1e-30)).max().item()
    old = 1e-3 * want.abs().max().item() + 1e-5
    say("witness", f"{name}: the kernel's bf16 attention weights, recovered "
                   f"from its output, explain it within the f32 sums' bound "
                   f"(max|diff| {r.explain_err:.3e}); {r.flips} of "
                   f"{r.weights} weights sit one bf16 step from the plain "
                   f"version's, each within {r.worst:.2e} of its size of a "
                   f"rounding boundary ({r.near} within 2^-14), "
                   f"{r.unresolved} below the solve's resolution; "
                   f"max|kernel - plain| {err.max().item():.3e} uses "
                   f"{share:.3f} of that limit (max "
                   f"{r.limit.max().item():.3e}; the fixed check's 1e-3 * "
                   f"max|ref| + 1e-5 = {old:.3e})")
    return share


def check_attention_pool(torch, gen, dev, flush) -> dict:
    """attention_pool at small and odd shapes (D not a multiple of 4, D no
    multiple of 16 at the serving shape's F, 16 and more than 16 heads,
    one frame, more videos than SMs), then at AttentionPoolingModel's
    serving shape (B=512, F=300, D=1152, H=8) with uint8 and f32 frames
    against its plain version; frames past num_frames set to 255 / 1e4;
    the empty video held to the plain version's mean; the rounding witness
    on those draws and on two more; the launch's plan; times (the
    profiler's device time and CUDA events), bounds and a library
    yardstick."""
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels.attention_pool import (
        attention_pool,
        attention_pool_plain,
        kernel_plan,
    )

    for b, f, d, h, dt in ((5, 13, 32, 4, torch.uint8),
                           (3, 70, 1001, 3, torch.float32),
                           (4, 20, 64, 19, torch.uint8),
                           (2, 1, 8, 1, torch.float32),
                           (9, FLAG_FRAMES, 1001, ATTN_HEADS, torch.uint8),
                           (6, FLAG_FRAMES, 1001, ATTN_HEADS, torch.float32),
                           (6, FLAG_FRAMES, FEATURE_DIM, 16, torch.uint8),
                           (300, 24, 64, ATTN_HEADS, torch.uint8)):
        args = attention_inputs(torch, gen, b, f, d, h, dt, dev)
        rel_check(f"attention_pool edge B={b} F={f} D={d} H={h} {dt}",
                  attention_pool(*args), attention_pool_plain(*args))
    b, f, d, h = FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM, ATTN_HEADS
    for dt in (torch.uint8, torch.float32):
        p = kernel_plan(f, d, h, dt)
        say("kernel", f"attention_pool plan {dt}: {p['stages']} stages of "
                      f"{p['rows']} frames ({p['stage_bytes']} B), "
                      f"{p['smem']} B of shared memory, {p['warps']} "
                      f"consumer warps and a producer, grid "
                      f"{min(b, p['sms'])}")
    errs, times, device = {}, {}, {}
    for dt, loud in ((torch.float32, 1e4), (torch.uint8, 255)):
        x, nf, q = attention_inputs(torch, gen, b, f, d, h, dt, dev)
        if dt == torch.float32:
            live_f32 = torch.arange(f, device=dev)[None, :] < nf[:, None]
            live_f32[nf <= 0] = True
        past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
        past[2] = False  # the empty video averages all its rows
        clean, x = pad_hazard(torch, x, past, loud)
        args = (x, nf, q)
        got = attention_pool(*args)
        check(torch.equal(got, attention_pool(clean, nf, q)),
              f"attention_pool {dt}: frames past num_frames leaked")
        check(bool(torch.isfinite(got).all()), f"attention_pool {dt}: "
                                               f"non-finite")
        want = attention_pool_plain(*args)
        torch.cuda.synchronize()
        if dt == torch.uint8:
            # The serving draw: held to the limit its rounding witness
            # derives (attention_witness below), not to the fixed 1e-3,
            # which an attention weight in [0.5, 1) one bf16 step from the
            # plain version's exceeds on some draws.
            errs[dt] = (got - want).abs().max().item()
        else:
            errs[dt] = rel_check(f"attention_pool {dt}", got, want)
        empty = rel_check(f"attention_pool {dt} num_frames=0", got[2],
                          want[2])
        say("kernel", f"attention_pool {dt}: max|diff| {errs[dt]:.3e}, the "
                      f"num_frames=0 video (mean of its {f} rows) "
                      f"{empty:.3e}; hazards bit-identical")
        attention_witness(torch, f"attention_pool {dt}", args, got, want)
        times[dt] = time_ms(torch, lambda: attention_pool(*args), 10, flush)
        device[dt] = device_us(torch, lambda: attention_pool(*args),
                               "attention_pool") / 1e3
        del got, want, clean
    # The serving path feeds uint8 frames: time and bound that case.
    us = device[torch.uint8] * 1e3
    plain_ms = time_ms(torch, lambda: attention_pool_plain(*args), 3, flush)
    live = (torch.arange(f, device=dev)[None, :] < nf[:, None])
    live[nf == 0] = True

    def library():
        xb = (x.to(torch.float32) * DEQUANT_SCALE
              + DEQUANT_BIAS).to(torch.bfloat16)
        scores = torch.matmul(xb, q.to(torch.bfloat16)).to(torch.float32)
        scores = scores.masked_fill(~live[..., None], -1e9)
        attn = torch.softmax(scores, dim=1).to(torch.bfloat16)
        return torch.bmm(attn.transpose(1, 2), xb).to(torch.float32)

    library_ms = time_ms(torch, library, 5, flush)
    rows = int(live.sum())  # the frames the function must read
    flops = 4.0 * rows * d * h
    nbytes = rows * d + d * h * 4 + b * h * d * 4 + 4 * b
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    # The f32 draw had its own num_frames: its bound from its own rows.
    rows_f32 = int(live_f32.sum())
    bound_f32, by_f32 = bound(4.0 * rows_f32 * d * h,
                              4 * rows_f32 * d + d * h * 4 + b * h * d * 4
                              + 4 * b, PEAK_BF16_FLOPS)
    say("kernel", f"attention_pool B={b} F={f} D={d} H={h}: uint8 "
                  f"{us / 1e3:.4f} ms (profiler; CUDA events "
                  f"{times[torch.uint8]:.4f} ms), f32 frames "
                  f"{device[torch.float32]:.4f} ms (events "
                  f"{times[torch.float32]:.4f}); bound {bound_ms:.4f} ms by "
                  f"{bound_by} for this run's {rows} frames read (f32: "
                  f"{bound_f32:.4f} by {by_f32} for {rows_f32}); plain "
                  f"{plain_ms:.4f} ms; library (bf16 matmul + masked softmax "
                  f"+ bmm) {library_ms:.4f} ms")
    # Two more draws of the serving shape, each held to the witness and
    # the limit it derives (a fixed 1e-3 check holds on some draws only:
    # seed 21 puts one weight in [0.5, 1) one bf16 step from the plain
    # version's, 3.906e-3 against 2.0e-3).
    for seed in (21, 22):
        draw = attention_inputs(torch, torch.Generator().manual_seed(seed),
                                b, f, d, h, torch.uint8, dev)
        attention_witness(torch, f"attention_pool uint8 draw {seed}", draw,
                          attention_pool(*draw), attention_pool_plain(*draw))
        del draw
        torch.cuda.empty_cache()
    return {
        "name": "attention_pool", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/attention_pool.cu",
        "replaces": "yt8m_tpu/kernels/attention_pool.py:63",
        "max_abs_err": max(errs.values()), "ms": us / 1e3,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_events": times[torch.uint8],
        "ms_f32": device[torch.float32], "ms_events_f32": times[torch.float32],
        "bound_ms_f32": bound_f32, "bound_by_f32": by_f32,
    }


# ---------------------------------------------------------------------------
# phase 3 (cont.): NeXtVLAD, serving and trainable
# ---------------------------------------------------------------------------


def nextvlad_inputs(torch, gen, b, f, d, lam, g, k, x_dtype, dev):
    """Frames, num_frames uniform in [1, f] with f, 0 and 1 planted, and
    the five weights at the JAX initialisers' scales with a drawn
    attention bias."""
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=gen,
                          dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=gen)
    nf = torch.randint(1, f + 1, (b,), generator=gen, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    de = lam * d
    w = [torch.randn(d, de, generator=gen) * d ** -0.5,
         torch.randn(de, g, generator=gen) * de ** -0.5,
         0.5 * torch.randn(g, generator=gen),
         torch.randn(de, g * k, generator=gen) * de ** -0.5,
         torch.randn(k, de // g, generator=gen) * de ** -0.5]
    return [t.to(dev) for t in (x, nf, *w)]


def nextvlad_flops(live, d, de, g, k):
    """The three products of the forward (and the attention dot) over
    `live` frames."""
    p = de // g
    return 2.0 * live * (d * de + de * g * (k + 1) + g * k * p)


def nextvlad_witness(torch, name, args, g) -> None:
    """Why the NeXtVLAD bound is NEXTVLAD_REL and not 1e-3: the kernel and
    its plain version part only where a value is rounded to bf16. Fed the
    kernel's own bf16 frames, the plain f32 xe rounds to the kernel's xe
    but at rounding boundaries; fed the kernel's own xe, so does the plain
    f32 assignment (rounding_witness); and the plain aggregation and norm
    on the kernel's own xe, assignment and a_sum meet 1e-3 * max|ref| +
    1e-6 (kernels/nextvlad.py :: forward_on_stream)."""
    from yt8m_tpu_torch.kernels.nextvlad import (
        forward_on_stream,
        kernel_layout,
        nextvlad_aggregate_with_scratch,
    )

    x, nf, *w = args
    layout = kernel_layout(*w, g)
    out, scratch = nextvlad_aggregate_with_scratch(x, nf, layout)
    pairs = forward_on_stream(x, nf, layout, scratch, out)
    del scratch
    for what in ("xe", "assign"):
        rounding_witness(f"{name} {what}", *pairs[what])
    got, tail = pairs["out"]
    err = rel_check(f"{name} on the kernel's own xe and assignment", got,
                    tail, rel=1e-3, abs_=1e-6)
    say("witness", f"{name}: plain aggregation and norm on the kernel's own "
                   f"xe, assignment and a_sum: max|diff| {err:.3e} (1e-3 "
                   f"bound {1e-3 * tail.abs().max().item() + 1e-6:.3e})")


def nextvlad_train_witness(torch, args, g, dy) -> None:
    """The same for the backward (kernels/nextvlad_train.py ::
    backward_on_stream): fed the kernel's own residuals and bf16 streams,
    the plain steps give bf16(dv), bf16(d_act) and bf16(d_xe) that differ
    from the kernel's only at rounding boundaries, and dv, cdot, d_pre and
    the weight-gradient products on the kernel's bf16 operands meet 1e-3 *
    max|ref| + 1e-6."""
    from yt8m_tpu_torch.kernels import nextvlad_train as tnt
    from yt8m_tpu_torch.kernels.nextvlad import kernel_layout

    x, nf, *w = args
    layout = kernel_layout(*w, g, training=True)
    _, res = tnt.nextvlad_train_forward(x, nf, layout)
    dwe, dwext, _, _, t = tnt.nextvlad_train_backward_with_scratch(
        nf, res, layout, dy)
    pairs = tnt.backward_on_stream(nf, res, layout, dy, dwe, dwext, t)
    del res, t
    for what in ("dvb", "d_act", "d_xe"):
        rounding_witness(f"nextvlad_train {what}", *pairs.pop(what))
    for what, (got, ref) in pairs.items():
        err = rel_check(f"nextvlad_train {what} on the kernel's stream", got,
                        ref, rel=1e-3, abs_=1e-6)
        say("witness", f"nextvlad_train {what} on the kernel's own stream: "
                       f"max|diff| {err:.3e} ({err / ref.abs().max().item():.2e}"
                       f" of max|ref|, bound 1e-3)")


def check_nextvlad(torch, gen, dev, flush) -> dict:
    """nextvlad_aggregate at small and odd shapes (P=8, 2, 144, 251 and
    K=12, 96, 130, 256, one group and sixteen, D not a multiple of 8; P=
    320, wider than a column tile), then at NeXtVladModel's serving shape
    (B=512, F=300, D=1152, lambda=2, G=8, K=128) with uint8 and f32 frames
    against its plain version, with frames past num_frames set to 255 /
    1e4, the num_frames = 0 video, the rounding witness, times (each
    launch's by the profiler), bound and a library yardstick."""
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels.nextvlad import (
        kernel_layout,
        nextvlad_aggregate,
        nextvlad_aggregate_plain,
    )

    for b, f, d, lam, g, k, dt in ((3, 10, 16, 2, 4, 12, torch.uint8),
                                   (4, 70, 64, 2, 1, 128, torch.float32),
                                   (3, 13, 32, 1, 16, 96, torch.uint8),
                                   (5, 300, 96, 3, 2, 130, torch.float32),
                                   (2, 130, 1004, 2, 8, 256, torch.uint8)):
        args = nextvlad_inputs(torch, gen, b, f, d, lam, g, k, dt, dev)
        err = rel_check(f"nextvlad edge B={b} F={f} D={d} G={g} K={k} {dt}",
                        nextvlad_aggregate(*args, g),
                        nextvlad_aggregate_plain(*args, g),
                        rel=NEXTVLAD_REL, abs_=1e-6)
        say("kernel", f"nextvlad edge B={b} F={f} D={d} lambda={lam} G={g} "
                      f"K={k} {dt}: max|diff| {err:.3e}")
    # P = 320, wider than the aggregation's 288-column tile: two column
    # tiles and the norm pass (its own generator: the later draws stay).
    args = nextvlad_inputs(torch, torch.Generator().manual_seed(15), 3, 9,
                           64, 5, 1, 40, torch.uint8, dev)
    err = rel_check("nextvlad edge P=320", nextvlad_aggregate(*args, 1),
                    nextvlad_aggregate_plain(*args, 1), rel=NEXTVLAD_REL,
                    abs_=1e-6)
    say("kernel", f"nextvlad edge B=3 F=9 D=64 lambda=5 G=1 K=40 (P=320) "
                  f"uint8: max|diff| {err:.3e}")
    b, f, d, lam, g, k = (FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM,
                          NEXTVLAD_LAMBDA, NEXTVLAD_GROUPS, NEXTVLAD_CLUSTERS)
    de, p = lam * d, lam * d // g
    errs, times, shares = {}, {}, {}
    for dt, loud in ((torch.float32, 1e4), (torch.uint8, 255)):
        args = nextvlad_inputs(torch, gen, b, f, d, lam, g, k, dt, dev)
        x, nf, *w = args
        past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
        clean, x = pad_hazard(torch, x, past, loud)
        args = [x, nf, *w]
        layout = kernel_layout(*w, g)
        got = nextvlad_aggregate(*args, g, layout=layout)
        check(torch.equal(got, nextvlad_aggregate(clean, nf, *w, g,
                                                  layout=layout)),
              f"nextvlad {dt}: frames past num_frames leaked")
        check(bool(torch.isfinite(got).all()), f"nextvlad {dt}: non-finite")
        check(bool(torch.all(got[1] == 0)),
              f"nextvlad {dt}: num_frames=0 is not exact zeros")
        want = nextvlad_aggregate_plain(*args, g)
        torch.cuda.synchronize()
        errs[dt] = rel_check(f"nextvlad_aggregate {dt}", got, want,
                             rel=NEXTVLAD_REL, abs_=1e-6)
        shares[dt] = errs[dt] / want.abs().max().item()
        del got, want, clean
        nextvlad_witness(torch, f"nextvlad_aggregate {dt}", args, g)
        times[dt] = time_ms(torch, lambda: nextvlad_aggregate(
            *args, g, layout=layout), 10, flush)
    # The serving path feeds uint8 frames: time and bound that case, launch
    # by launch.
    split = device_kernels(torch, lambda: nextvlad_aggregate(
        *args, g, layout=layout), "nxv_")
    us = sum(split.values())
    say("kernel", "nextvlad_aggregate by launch (profiler ms): "
        + launch_split(split))
    plain_ms = time_ms(torch, lambda: nextvlad_aggregate_plain(*args, g), 3,
                       flush)
    live = torch.arange(f, device=dev)[None, :] < nf[:, None]
    mask = live[:, :, None, None]
    bf = torch.bfloat16
    we_b, wa_b, wc_b = w[0].to(bf), w[1].to(bf), w[3].to(bf)

    def library():
        xb = (x.to(torch.float32) * DEQUANT_SCALE + DEQUANT_BIAS).to(bf)
        xe = torch.matmul(xb, we_b)
        alpha = torch.sigmoid(torch.matmul(xe, wa_b).float() + w[2])
        act = torch.matmul(xe, wc_b).float().reshape(b, f, g, k)
        a = torch.softmax(act, -1) * alpha[..., None] * mask
        vlad = torch.bmm(a.to(bf).reshape(b, f * g, k).transpose(1, 2),
                         xe.reshape(b, f * g, p)).float()
        vlad = vlad - a.sum((1, 2))[:, :, None] * w[4]
        return torch.nn.functional.normalize(vlad, dim=2, eps=1e-6)

    library_ms = time_ms(torch, library, 5, flush)
    real = int(live.sum())  # this run's live frames
    flops = nextvlad_flops(real, d, de, g, k)
    nbytes = (real * d + 4 * b + (d * de + de * g + de * g * k) * 2
              + 4 * g + k * p * 4 + b * k * p * 4)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    say("kernel", f"nextvlad_aggregate B={b} F={f} D={d} De={de} G={g} "
                  f"K={k} P={p}: uint8 {us / 1e3:.4f} ms by the profiler "
                  f"(events {times[torch.uint8]:.4f}; f32 frames "
                  f"{times[torch.float32]:.4f}); bound {bound_ms:.4f} ms by "
                  f"{bound_by} for this run's {real} live frames "
                  f"({flops / 1e12:.3f} TFLOP; "
                  f"{nextvlad_flops(b * f, d, de, g, k) / 989e12 * 1e3:.4f} "
                  f"ms for all {b * f}); plain {plain_ms:.4f} ms; library "
                  f"(bf16 matmul + softmax + bmm) {library_ms:.4f} ms; "
                  f"max|diff| {errs[torch.uint8]:.3e} uint8 "
                  f"({shares[torch.uint8]:.2e} of max|ref|), "
                  f"{errs[torch.float32]:.3e} f32 "
                  f"({shares[torch.float32]:.2e})")
    return {
        "name": "nextvlad_aggregate", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/nextvlad.cu",
        "replaces": "yt8m_tpu/kernels/nextvlad.py:142",
        "max_abs_err": max(errs.values()), "ms": us / 1e3,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_events": times[torch.uint8],
        "ms_events_f32": times[torch.float32],
    }


def nextvlad_train_grads(torch, args, g, dy):
    """(out, the five weight gradients) through the Function."""
    from yt8m_tpu_torch.kernels.nextvlad_train import nextvlad_aggregate_train

    x, nf, *w = args
    ws = [t.clone().requires_grad_() for t in w]
    out = nextvlad_aggregate_train(x, nf, *ws, g)
    (out * dy).sum().backward()
    return out.detach(), [t.grad for t in ws]


def check_nextvlad_train(torch, gen, dev, flush) -> dict:
    """nextvlad_aggregate_train at small and odd shapes (P=320 too) and
    at NeXtVladModel's training shape (B=256, F=300, uint8 frames): the
    forward and the five weight gradients against the plain versions, a
    second run bit for bit, frames past num_frames set to 255, times by
    the profiler (each launch's too), bound and the library yardstick
    under autograd."""
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels import nextvlad_train as tnt
    from yt8m_tpu_torch.kernels.nextvlad import (
        kernel_layout,
        nextvlad_aggregate_plain,
    )

    names = ("dWe", "dWa", "dab", "dWc", "dcenters")

    def compare(name, args, g, dy):
        out, grads = nextvlad_train_grads(torch, args, g, dy)
        errs = [rel_check(f"{name} forward", out,
                          nextvlad_aggregate_plain(*args, g),
                          rel=NEXTVLAD_REL, abs_=1e-6)]
        want = tnt.nextvlad_aggregate_train_plain_backward(*args, dy, g)
        shares = []
        for what, got, ref in zip(names, grads, want):
            errs.append(rel_check(f"{name} {what}", got, ref,
                                  rel=NEXTVLAD_REL, abs_=1e-6))
            shares.append(errs[-1] / max(ref.abs().max().item(), 1e-30))
        again = nextvlad_train_grads(torch, args, g, dy)[1]
        check(all(torch.equal(a, c) for a, c in zip(grads, again)),
              f"{name}: a second run gave other gradient bits")
        return max(errs), shares

    for b, f, d, lam, g, k in ((3, 10, 16, 2, 4, 12), (5, 300, 96, 3, 2, 130),
                               (2, 130, 1004, 2, 8, 256)):
        args = nextvlad_inputs(torch, gen, b, f, d, lam, g, k, torch.uint8,
                               dev)
        dy = torch.randn(b, k, lam * d // g, generator=gen).to(dev)
        err, _ = compare(f"nextvlad_train B={b} F={f} D={d} G={g} K={k}",
                         args, g, dy)
        say("kernel", f"nextvlad_train B={b} F={f} D={d} lambda={lam} G={g} "
                      f"K={k}: forward and gradients max|diff| {err:.3e}")
    edge = torch.Generator().manual_seed(16)  # P = 320: two column tiles
    args = nextvlad_inputs(torch, edge, 3, 9, 64, 5, 1, 40, torch.uint8, dev)
    err, _ = compare("nextvlad_train P=320", args, 1,
                     torch.randn(3, 40, 320, generator=edge).to(dev))
    say("kernel", f"nextvlad_train B=3 F=9 D=64 lambda=5 G=1 K=40 (P=320): "
                  f"forward and gradients max|diff| {err:.3e}")
    b, f, d, lam, g, k = (TRAIN_BATCH, FLAG_FRAMES, FEATURE_DIM,
                          NEXTVLAD_LAMBDA, NEXTVLAD_GROUPS, NEXTVLAD_CLUSTERS)
    de, p = lam * d, lam * d // g
    args = nextvlad_inputs(torch, gen, b, f, d, lam, g, k, torch.uint8, dev)
    x, nf, *w = args
    dy = torch.randn(b, k, p, generator=gen).to(dev)
    err, shares = compare("nextvlad_aggregate_train", args, g, dy)
    nextvlad_train_witness(torch, args, g, dy)
    past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
    clean, loud = pad_hazard(torch, x, past, 255)
    a = nextvlad_train_grads(torch, [clean, nf, *w], g, dy)
    c = nextvlad_train_grads(torch, [loud, nf, *w], g, dy)
    check(torch.equal(a[0], c[0]) and all(
        torch.equal(p_, q_) for p_, q_ in zip(a[1], c[1])),
        "nextvlad_train: frames past num_frames moved the output or a "
        "gradient")
    del a, c, clean, loud
    say("kernel", f"nextvlad_aggregate_train B={b} F={f}: forward and the "
                  f"five gradients within {NEXTVLAD_REL:g} * max|ref| + 1e-6 "
                  f"(max|diff| {err:.3e}; of max|ref|: "
                  + ", ".join(f"{n} {s:.2e}" for n, s in zip(names, shares))
                  + "); a second run bit for bit; hazards bit-identical")

    layout = kernel_layout(*w, g, training=True)
    out, scratch = tnt.nextvlad_train_forward(x, nf, layout)
    ms_f = time_ms(torch, lambda: tnt.nextvlad_train_forward(x, nf, layout),
                   5, flush)
    ms_b = time_ms(torch, lambda: tnt.nextvlad_train_backward(
        nf, scratch, layout, dy), 5, flush)
    split_f = device_kernels(torch, lambda: tnt.nextvlad_train_forward(
        x, nf, layout), "nxv_")
    split_b = device_kernels(torch, lambda: tnt.nextvlad_train_backward(
        nf, scratch, layout, dy), "nxv_")
    us_f, us_b = sum(split_f.values()), sum(split_b.values())
    say("kernel", "nextvlad_aggregate_train forward by launch (profiler ms): "
        + launch_split(split_f))
    say("kernel", "nextvlad_aggregate_train backward by launch (profiler "
        "ms): " + launch_split(split_b))
    del out, scratch

    def plain():
        tnt.nextvlad_aggregate_train_plain_backward(*args, dy, g)

    plain_ms = time_ms(torch, plain, 2, flush)
    live = past.logical_not()
    mask = live[:, :, None, None]
    bf = torch.bfloat16

    def library():
        ws = [t.detach().requires_grad_() for t in w]
        xb = (x.to(torch.float32) * DEQUANT_SCALE + DEQUANT_BIAS).to(bf)
        xe = torch.matmul(xb, ws[0].to(bf))
        alpha = torch.sigmoid(torch.matmul(xe, ws[1].to(bf)).float() + ws[2])
        act = torch.matmul(xe, ws[3].to(bf)).float().reshape(b, f, g, k)
        a = torch.softmax(act, -1) * alpha[..., None] * mask
        vlad = torch.bmm(a.to(bf).reshape(b, f * g, k).transpose(1, 2),
                         xe.reshape(b, f * g, p)).float()
        vlad = vlad - a.sum((1, 2))[:, :, None] * ws[4]
        torch.nn.functional.normalize(vlad, dim=2, eps=1e-6).backward(dy)

    library_ms = time_ms(torch, library, 3, flush)
    real = int(live.sum())
    kx = g * layout["dims"]["Kp"] + layout["dims"]["KA"]
    f_flops = nextvlad_flops(real, d, de, g, k)
    # The backward's products per live frame: d_assign and d_xg (2 G K P
    # each), d_xe and [dWc | dWa] (2 De (G K + G) each), dWe (2 D De).
    b_flops = 2.0 * real * (2 * g * k * p + 2 * de * (g * k + g) + d * de)
    nbytes = (real * d + 4 * b + (d * de + de * g + de * g * k) * 2 * 2
              + 4 * g + k * p * 4 + 2 * b * k * p * 4
              + (d * de + de * g + de * g * k + g + k * p) * 4)
    bound_ms, bound_by = bound(f_flops + b_flops, nbytes, PEAK_BF16_FLOPS)
    say("kernel", f"nextvlad_aggregate_train B={b} F={f}: forward "
                  f"{us_f / 1e3:.4f} ms, backward {us_b / 1e3:.4f} ms by the "
                  f"profiler (events {ms_f:.4f} + {ms_b:.4f}); bound "
                  f"{bound_ms:.4f} ms by {bound_by} for this run's {real} "
                  f"live frames ({f_flops / 1e12:.3f} + {b_flops / 1e12:.3f} "
                  f"TFLOP; Kx={kx}); plain forward + backward {plain_ms:.4f} "
                  f"ms; library (the bf16 yardstick under autograd) "
                  f"{library_ms:.4f} ms")
    return {
        "name": "nextvlad_aggregate_train", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/nextvlad_train.cu",
        "replaces": "yt8m_tpu/kernels/nextvlad_train.py:372",
        "max_abs_err": err, "ms": (us_f + us_b) / 1e3, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_forward": us_f / 1e3,
        "ms_backward": us_b / 1e3, "ms_events": ms_f + ms_b,
    }


# ---------------------------------------------------------------------------
# phase 3 (cont.): the int8, v1 and sampled DBoF kernels, dequant matmul
# ---------------------------------------------------------------------------


def int8_inputs(torch, gen, b, s, d, k, dev):
    """Raw frames, the f32 cluster kernel and folded vectors of
    dbof_inputs, and the int8 constants built from them."""
    from yt8m_tpu_torch.kernels.dbof import int8_serving_constants

    x, w, s_in, b_in, s_act, b_act = dbof_inputs(torch, gen, b, s, d, k,
                                                 torch.uint8, dev)
    consts = int8_serving_constants(w.float(), s_in, b_in, s_act, b_act)
    return [x, *consts], [x, w, s_in, b_in, s_act, b_act]


def check_dbof_int8(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool_int8,
        dbof_cluster_maxpool_int8_plain,
        dbof_cluster_maxpool_plain,
        dbof_cluster_maxpool_v2,
    )

    # Edge cases, each bit for bit: ragged B and K, S < 32, S = 64 (two
    # launches), the serving widths at B=5; and the padded-row hazard
    # (every real row negative before the ReLU, an int8 zero row, the raw
    # byte 128, would give relu(b_col) = 3).
    for b, s, d, k in ((7, 5, 64, 200), (9, 32, 96, 136), (3, 64, 128, 48),
                       (5, 30, 1152, 8192)):
        args, _ = int8_inputs(torch, gen, b, s, d, k, dev)
        check(torch.equal(dbof_cluster_maxpool_int8(*args),
                          dbof_cluster_maxpool_int8_plain(*args)),
              f"dbof int8 edge B={b} S={s} D={d} K={k}: not bit for bit")
        # Columns with a_col < 0 (the kernel pools the minimum integer sum
        # there), a_col = 0 and a_col = -0.0.
        x, w8, a_col, b_col = args
        a_col = a_col.clone()
        a_col[::3] *= -1.0
        a_col[1::7] = 0.0
        a_col[2::11] = -0.0
        check(torch.equal(dbof_cluster_maxpool_int8(x, w8, a_col, b_col),
                          dbof_cluster_maxpool_int8_plain(x, w8, a_col,
                                                          b_col)),
              f"dbof int8 signed a_col B={b} S={s} D={d} K={k}: not bit "
              f"for bit")
    (x, w8, a_col, _), _ = int8_inputs(torch, gen, 6, 30, 64, 64, dev)
    # acc <= -72 * 127 a column: with a_col = 1 every real row is < 0.
    x, w8, a_col = torch.clamp(x, min=200), -w8.abs(), torch.ones_like(a_col)
    b_col = torch.full_like(a_col, 3.0)
    check(bool(torch.all(dbof_cluster_maxpool_int8_plain(
        x, w8, a_col, b_col) == 0)), "dbof int8 hazard: plain not all 0")
    check(bool(torch.all(dbof_cluster_maxpool_int8(x, w8, a_col, b_col)
                         == 0)),
          "dbof int8: padded frame rows leaked into the max")
    check(bool(torch.all(dbof_cluster_maxpool_int8(x, -w8, -a_col, b_col)
                         == 0)),
          "dbof int8: padded frame rows leaked into the min (a_col < 0)")

    args, bf16_args = int8_inputs(torch, gen, BATCH, FRAMES, FEATURE_DIM,
                                  CLUSTERS, dev)
    got = dbof_cluster_maxpool_int8(*args)
    want = dbof_cluster_maxpool_int8_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(got, want),
          f"dbof_cluster_maxpool_int8: not bit for bit, max|diff| "
          f"{(got - want).abs().max().item():.3e}")
    ref = dbof_cluster_maxpool_plain(*bf16_args)
    deviation = ((got - ref).abs().max() / ref.abs().mean()).item()
    del want, ref
    x, w8, a_col, b_col = args

    def library():
        xi = (x ^ 128).view(torch.int8).reshape(-1, FEATURE_DIM)
        acc = torch._int_mm(xi, w8).to(torch.float32)
        act = torch.relu(acc * a_col + b_col)
        return torch.amax(act.reshape(BATCH, FRAMES, CLUSTERS), dim=1)

    check(torch.equal(library(), got), "int8 library yardstick differs")
    ms = time_ms(torch, lambda: dbof_cluster_maxpool_int8(*args), 10, flush)
    # The whole call: the kernel and the wrapper's column sums of w8 (a
    # PyTorch reduction).
    us = whole_call_us(torch, lambda: dbof_cluster_maxpool_int8(*args),
                       ("dbof_int8", "reduce_kernel"),
                       "dbof_cluster_maxpool_int8")
    # The path the int8 one replaces, in the same call: DBoF v2 (its input
    # affine and bf16 product) on the same frames.
    xq, w, s_in, b_in, s_act, b_act = bf16_args
    w16 = w.to(torch.bfloat16)
    bf16_us = whole_call_us(
        torch, lambda: dbof_cluster_maxpool_v2(xq, w16, s_in, b_in, s_act,
                                               b_act), WHOLE_DBOF,
        "dbof bf16 path (v2)")
    plain_ms = time_ms(torch, lambda: dbof_cluster_maxpool_int8_plain(*args),
                       3, flush)
    library_ms = time_ms(torch, library, 5, flush)
    ops = 2.0 * BATCH * FRAMES * FEATURE_DIM * CLUSTERS
    nbytes = (BATCH * FRAMES * FEATURE_DIM + FEATURE_DIM * CLUSTERS
              + 4 * 2 * CLUSTERS + BATCH * CLUSTERS * 4)
    bound_ms, bound_by = bound(ops, nbytes, PEAK_INT8_OPS)
    say("kernel", f"dbof_cluster_maxpool_int8 B={BATCH}: bit for bit with "
                  f"its plain version (and the edge cases, the hazard); "
                  f"{us / 1e3:.4f} ms (profiler; events {ms:.4f}) against "
                  f"the bf16 path's {bf16_us / 1e3:.4f} ms (profiler); "
                  f"max|int8 - bf16 plain| / mean|bf16 plain| "
                  f"{deviation:.4f} (the JAX test bounds it at 0.10 on "
                  f"16 x 7 x 256 x 256)")
    return {
        "name": "dbof_cluster_maxpool_int8", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/dbof_int8.cu",
        "replaces": "yt8m_tpu/kernels/dbof.py:287",
        "max_abs_err": 0.0, "ms": us / 1e3, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_events": ms,
        "bf16_path_ms": bf16_us / 1e3, "int8_vs_bf16": deviation,
    }


# The kernels of a DBoF wrapper's call: csrc/dbof.cu's and the shared
# launches of csrc/input_affine.cuh (the input affine, the W rounding).
SHARED_LAUNCHES = "inaff::"
WHOLE_DBOF = ("dbof", SHARED_LAUNCHES)


def whole_call_us(torch, fn, needles, name) -> float:
    """device_us over every kernel of a wrapper's call, each printed."""
    seen = device_kernels(torch, fn, needles)
    for key, us in seen.items():
        say("kernel", f"{name}: {us / 1e3:.4f} ms {key[:80]}")
    return sum(seen.values())


def check_dbof_v1(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool,
        dbof_cluster_maxpool_v1_plain,
    )

    def f32_weights(args):
        x, w, *vec = args
        return [x, w.float() + 1e-3 * torch.randn(
            w.shape, generator=gen).to(dev), *vec]

    for b, s, d, k, dt in ((7, 5, 64, 200, torch.uint8),
                           (9, 32, 96, 136, torch.float32),
                           (3, 40, 96, 64, torch.uint8)):
        args = f32_weights(dbof_inputs(torch, gen, b, s, d, k, dt, dev))
        rel_check(f"dbof v1 edge B={b} S={s} D={d} K={k} {dt}",
                  dbof_cluster_maxpool(*args),
                  dbof_cluster_maxpool_v1_plain(*args))
    args = f32_weights(dbof_inputs(torch, gen, BATCH, FRAMES, FEATURE_DIM,
                                   CLUSTERS, torch.uint8, dev))
    got = dbof_cluster_maxpool(*args)
    err = rel_check("dbof_cluster_maxpool (v1)", got,
                    dbof_cluster_maxpool_v1_plain(*args))
    ms = time_ms(torch, lambda: dbof_cluster_maxpool(*args), 10, flush)
    us = whole_call_us(torch, lambda: dbof_cluster_maxpool(*args),
                       WHOLE_DBOF, "dbof_cluster_maxpool (v1)")
    plain_ms = time_ms(
        torch, lambda: dbof_cluster_maxpool_v1_plain(*args), 3, flush)
    library_ms = time_ms(torch, lambda: dbof_library(torch, *args), 5,
                         flush)
    flops = 2.0 * BATCH * FRAMES * FEATURE_DIM * CLUSTERS
    nbytes = (BATCH * FRAMES * FEATURE_DIM + FEATURE_DIM * CLUSTERS * 4
              + 4 * (2 * FEATURE_DIM + 2 * CLUSTERS) + BATCH * CLUSTERS * 4)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    return {
        "name": "dbof_cluster_maxpool", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/dbof.cu",
        "replaces": "yt8m_tpu/kernels/dbof.py:65",
        "max_abs_err": err, "ms": us / 1e3, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_events": ms, "on_main_path": False,
    }


def sampled_inputs(torch, gen, b, f, d, s, k, dev):
    x, w, *vec = dbof_inputs(torch, gen, b, f, d, k, torch.uint8, dev)
    idx = torch.randint(0, f, (b, s), generator=gen, dtype=torch.int32)
    return [x, idx.to(dev), w, *vec]


def check_dbof_sampled(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool_v2,
        dbof_sampled_cluster_maxpool,
        dbof_sampled_cluster_maxpool_plain,
        sampled_frames_plain,
    )

    def gathered_v2(x, idx, w, *vec):
        rows = torch.arange(x.shape[0], device=x.device)[:, None]
        return dbof_cluster_maxpool_v2(x[rows, idx.long()], w, *vec)

    # Edge cases, each equal to v2 on the gathered frames bit for bit;
    # indices outside [0, F) select a zero frame.
    for b, f, d, s, k in ((7, 300, 64, 5, 200), (9, 40, 96, 32, 136)):
        args = sampled_inputs(torch, gen, b, f, d, s, k, dev)
        check(torch.equal(dbof_sampled_cluster_maxpool(*args),
                          gathered_v2(*args)),
              f"dbof sampled edge B={b} F={f} S={s}: differs from v2 on the "
              f"gathered frames")
    x, idx, w, *vec = sampled_inputs(torch, gen, 4, 10, 64, 6, 32, dev)
    idx[0, :3] = torch.tensor([-1, 10, 1 << 30], dtype=torch.int32)
    idx[2] = -7
    check(torch.equal(
        dbof_sampled_cluster_maxpool(x, idx, w, *vec),
        dbof_cluster_maxpool_v2(sampled_frames_plain(x, idx), w, *vec)),
        "dbof sampled: an out-of-range index is not a zero frame")

    # DbofModel's route at F=300: the sampler's gather, then v2.
    args = sampled_inputs(torch, gen, BATCH, FLAG_FRAMES, FEATURE_DIM,
                          FRAMES, CLUSTERS, dev)
    got = dbof_sampled_cluster_maxpool(*args)
    check(torch.equal(got, gathered_v2(*args)),
          "dbof_sampled_cluster_maxpool: differs from v2 on the gathered "
          "frames")
    err = rel_check("dbof_sampled_cluster_maxpool", got,
                    dbof_sampled_cluster_maxpool_plain(*args))
    x, idx, w, *vec = args
    fused = lambda: dbof_sampled_cluster_maxpool(*args)  # noqa: E731
    route = lambda: gathered_v2(*args)  # noqa: E731
    ab = {"fused": [], "route": []}
    for name in ("route", "fused", "fused", "route"):
        ab[name].append(time_ms(torch, fused if name == "fused" else route,
                                10, flush))
    us = whole_call_us(torch, fused, WHOLE_DBOF,
                       "dbof_sampled_cluster_maxpool")
    plain_ms = time_ms(torch, lambda: dbof_sampled_cluster_maxpool_plain(
        *args), 3, flush)

    def library():
        xs = torch.index_select(x.reshape(-1, FEATURE_DIM), 0, (
            torch.arange(BATCH, device=dev)[:, None] * FLAG_FRAMES
            + idx).reshape(-1)).reshape(BATCH, FRAMES, FEATURE_DIM)
        return dbof_library(torch, xs, w, *vec)

    library_ms = time_ms(torch, library, 5, flush)
    flops = 2.0 * BATCH * FRAMES * FEATURE_DIM * CLUSTERS
    nbytes = (BATCH * FRAMES * (FEATURE_DIM + 4) + FEATURE_DIM * CLUSTERS * 2
              + 4 * (2 * FEATURE_DIM + 2 * CLUSTERS) + BATCH * CLUSTERS * 4)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    fused_ms = statistics.median(ab["fused"])
    route_ms = statistics.median(ab["route"])
    say("kernel", f"dbof sampled A/B at B={BATCH} F={FLAG_FRAMES} S={FRAMES} "
                  f"(route, fused, fused, route): DbofModel's route (gather "
                  f"+ v2) {ab['route']} ms, the fused gather {ab['fused']} "
                  f"ms; median {route_ms:.4f} vs {fused_ms:.4f} ms")
    return {
        "name": "dbof_sampled_cluster_maxpool", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/dbof.cu",
        "replaces": "yt8m_tpu/kernels/dbof.py:439",
        "max_abs_err": err, "ms": us / 1e3, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "ms_events": fused_ms,
        "ms_gather_then_v2": route_ms, "on_main_path": False,
    }


def dequant_inputs(torch, gen, m, d, n, dev):
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE

    x = torch.randint(0, 256, (m, d), generator=gen, dtype=torch.uint8)
    w = torch.randn(d, n, generator=gen) * d ** -0.5
    scale = DEQUANT_SCALE * (0.5 + torch.rand(d, generator=gen))
    bias = DEQUANT_BIAS * scale + 0.1 * torch.randn(d, generator=gen)
    return [t.to(dev) for t in (x, w, scale, bias)]


def check_dequant_matmul(torch, gen, dev, flush) -> dict:
    from yt8m_tpu_torch.kernels.dequant_matmul import (
        compute_dtype,
        dequant_affine_matmul,
        dequant_affine_matmul_plain,
    )

    def rel(d):  # bf16 operands from D = 512, f32 below
        return 1e-3 if compute_dtype(d) == torch.bfloat16 else 1e-5

    # The old edge shapes, then M, N and D that cut the new tiles (128 x
    # 256 and the TMA store in bf16; 128 x 128 and the 16-byte loads in
    # f32), these from their own generator (the later phases keep their
    # inputs).
    edge_gen = torch.Generator().manual_seed(15)
    edges = [(gen, m, d, n) for m, d, n in (
        (37, 128, 200), (5, 64, 7), (70, 512, 130), (9, 1000, 1000),
        (4097, 1152, 257))]
    edges += [(edge_gen, m, d, n) for m in (1, 127, 129) for n in (7, 255, 257)
              for d in (512, 1000, 1152, 64, 128, 200)]
    worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
    for g, m, d, n in edges:
        args = dequant_inputs(torch, g, m, d, n, dev)
        err = rel_check(f"dequant_affine_matmul edge M={m} D={d} N={n}",
                        dequant_affine_matmul(*args),
                        dequant_affine_matmul_plain(*args), rel=rel(d),
                        abs_=1e-6)
        worst[compute_dtype(d)] = max(worst[compute_dtype(d)], err)
    say("kernel", f"dequant_affine_matmul {len(edges)} edge shapes: max|diff| "
                  f"{worst[torch.bfloat16]:.3e} bf16 (1e-3 * max|ref| + "
                  f"1e-6), {worst[torch.float32]:.3e} f32 (1e-5 * max|ref| "
                  f"+ 1e-6)")
    # The flagship's first LSTM input projection over raw frames (bf16),
    # and the 128 audio features' (f32).
    row = {}
    for m, d, n, peak, tag in ((FLAG_BATCH * FLAG_FRAMES, FEATURE_DIM, 4096,
                                PEAK_BF16_FLOPS, ""),
                               (FLAG_BATCH * FLAG_FRAMES, 128, 1024,
                                PEAK_F32_FLOPS, "_f32")):
        args = dequant_inputs(torch, gen, m, d, n, dev)
        got = dequant_affine_matmul(*args)
        want = dequant_affine_matmul_plain(*args)
        torch.cuda.synchronize()
        err = rel_check(f"dequant_affine_matmul M={m} D={d} N={n}", got,
                        want, rel=rel(d), abs_=1e-6)
        del got, want
        x, w, scale, bias = args
        dt = compute_dtype(d)

        def library():
            xa = (x.to(torch.float32) * scale + bias).to(dt)
            return torch.matmul(xa, w.to(dt)).to(torch.float32)

        ms = time_ms(torch, lambda: dequant_affine_matmul(*args), 5, flush)
        us = whole_call_us(torch, lambda: dequant_affine_matmul(*args),
                           ("dequant", "product_kernel", SHARED_LAUNCHES),
                           f"dequant_affine_matmul {dt}")
        plain_ms = time_ms(
            torch, lambda: dequant_affine_matmul_plain(*args), 3, flush)
        library_ms = time_ms(torch, library, 5, flush)
        bound_ms, bound_by = bound(2.0 * m * d * n,
                                   m * d + d * n * 4 + 8 * d + m * n * 4,
                                   peak)
        row.update({f"max_abs_err{tag}": err, f"ms{tag}": us / 1e3,
                    f"ms_events{tag}": ms, f"plain_ms{tag}": plain_ms,
                    f"bound_ms{tag}": bound_ms, f"bound_by{tag}": bound_by,
                    f"library_ms{tag}": library_ms})
        say("kernel", f"dequant_affine_matmul M={m} D={d} N={n} ({dt}): "
                      f"{us / 1e3:.4f} ms (profiler; events {ms:.4f}); bound "
                      f"{bound_ms:.4f} by {bound_by}; plain {plain_ms:.4f}; "
                      f"library {library_ms:.4f}")
        del args, x, w
        torch.cuda.empty_cache()
    row.update({
        "name": "dequant_affine_matmul", "route": "cuda",
        "source": "yt8m_tpu_torch/kernels/csrc/dequant_matmul.cu",
        "replaces": "yt8m_tpu/kernels/dequant_matmul.py:50",
        "on_main_path": False,
    })
    return row


# ---------------------------------------------------------------------------
# phase 3 (cont.): the f32 routes (--compute_dtype=float32)
# ---------------------------------------------------------------------------

# Nothing is rounded on either side: max|kernel - plain| <= 1e-5 max|ref|
# + 1e-5 (only the order of the f32 sums differs). NetVLAD's descriptor is
# L2-normalised over K*D values (about 1.8e-3 each at the serving shape),
# so its absolute term is 1e-8: a route that rounded x or Wc to bf16 would
# exceed it.
F32_REL = 1e-5
NETVLAD_F32_ABS = 1e-8


def f32_check(name, got, want, abs_=1e-5) -> float:
    return rel_check(name, got, want, rel=F32_REL, abs_=abs_)


def route_bound(flops, nbytes, peak, split_bytes=0, tf32x3=False) -> dict:
    """A route's bound_ms and bound_by at the peak rate of its operands'
    type. A 3xTF32 route (split_bytes > 0: the weights' split copies, read
    in place of the f32 weights; or tf32x3, a route that splits its
    operands on chip) does three TF32 products at the TF32 rate: that is
    its bound, and the bound at the card's f32 rate outside the tensor
    cores, which the route no longer uses, is kept as bound_fma_ms and
    bound_fma_by."""
    if not (split_bytes or tf32x3):
        ms, by = bound(flops, nbytes, peak)
        return {"bound_ms": ms, "bound_by": by}
    ms, by = bound(3 * flops, nbytes + split_bytes, PEAK_TF32_FLOPS)
    fma_ms, fma_by = bound(flops, nbytes, PEAK_F32_FLOPS)
    return {"bound_ms": ms, "bound_by": by, "bound_fma_ms": fma_ms,
            "bound_fma_by": fma_by}


def say_bound(r) -> str:
    fma = (f"; the FMA units' bound {r['bound_fma_ms']:.4f} by "
           f"{r['bound_fma_by']} at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s"
           if "bound_fma_ms" in r else "")
    return f"bound {r['bound_ms']:.4f} by {r['bound_by']}{fma}"


def f32_timing(torch, fn, plain, library, needle, flush, reps, flops,
               nbytes, split_bytes=0) -> dict:
    """A 3xTF32 route's times at its serving shape: CUDA events (median),
    the profiler's device time, the plain version's and the library
    yardstick's (the torch.matmul f32 graph, TF32 off), and its bound
    (route_bound: three TF32 products at the TF32 rate, the card's f32
    rate outside the tensor cores beside it)."""
    ms = time_ms(torch, fn, reps, flush)
    device_ms = device_us(torch, fn, needle) / 1e3
    plain_ms = time_ms(torch, plain, 3, flush)
    library_ms = time_ms(torch, library, 3, flush)
    return {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "arithmetic": "3xTF32",
            **route_bound(flops, nbytes, PEAK_F32_FLOPS, split_bytes,
                          tf32x3=True)}


def say_f32(name, shape, r) -> None:
    say("kernel", f"{name} f32 {shape}: ok, max|diff| {r['max_abs_err']:.3e}"
                  f"; {r['ms']:.4f} ms events, {r['device_ms']:.4f} ms "
                  f"profiler (plain {r['plain_ms']:.4f}, library "
                  f"{r['library_ms']:.4f}, {say_bound(r)})")


def f64_witness(torch, name, got, graph, want64, abs_=1e-5) -> dict:
    """The 3xTF32 route's and the f32 torch.matmul graph's max error
    against the same function with its products in float64, and the
    largest |value|: each f32 computation's own distance from the exact
    product."""
    top = want64.abs().max().item()
    r = {"route_vs_f64": (got.double() - want64).abs().max().item(),
         "graph_vs_f64": (graph.double() - want64).abs().max().item(),
         "max_abs_f64": top}
    say("witness", f"{name}: max|route - f64| {r['route_vs_f64']:.3e}, "
                   f"max|f32 graph - f64| {r['graph_vs_f64']:.3e} "
                   f"(max|f64| {top:.3e}; the check's bound "
                   f"{F32_REL * top + abs_:.3e})")
    return r


def depth_witness(torch, gen, dev) -> list:
    """The 3xTF32 product's error against depth: DBoF v2's f32 route at
    S = 1 with the identity affines, whose output is relu(x W) (each
    positive value one product of D terms), against float64 and beside
    the f32 graph, at D = 256 .. 16384, B=512, K=1024, f32 frames: the
    stages' sums on the FMA units keep it near the graph's at every D
    (one chain of wgmmas over D drifted linearly in D)."""
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool_plain,
        dbof_cluster_maxpool_v2,
    )
    from yt8m_tpu_torch.kernels.tf32 import split_weights

    rows = []
    b, k = 512, 1024
    for d in (256, 1152, 4096, 16384):
        x = torch.randn(b, 1, d, generator=gen).to(dev)
        w = (torch.randn(d, k, generator=gen) * d ** -0.5).to(dev)
        one, zero = torch.ones(d, device=dev), torch.zeros(d, device=dev)
        ak, bk = torch.ones(k, device=dev), torch.zeros(k, device=dev)
        got = dbof_cluster_maxpool_v2(x, w, one, zero, ak, bk,
                                      split_weights(w))
        graph = dbof_cluster_maxpool_plain(x, w, one, zero, ak, bk)
        want64 = torch.relu(x[:, 0].double() @ w.double())
        r = f64_witness(torch, f"3xTF32 depth D={d}", got, graph, want64)
        r["depth"] = d
        rows.append(r)
    return rows


def check_f32_dbof(torch, gen, dev, flush) -> dict:
    """DBoF v2's 3xTF32 route (W's split copy, as DbofModel's serving
    constants hold it) against the plain version at edge shapes, the
    padded-row hazard and the serving shape, its float64 witness there and
    the depth study."""
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool_plain,
        dbof_cluster_maxpool_v2,
    )
    from yt8m_tpu_torch.kernels.tf32 import split_weights

    def f32_inputs(b, s, d, k, dt):
        args = dbof_inputs(torch, gen, b, s, d, k, dt, dev)
        args[1] = args[1].float()
        return args

    def serve(x, w, *vec):
        return dbof_cluster_maxpool_v2(x, w, *vec, split_weights(w))

    for b, s, d, k, dt in ((7, 5, 64, 200, torch.uint8),
                           (9, 32, 96, 136, torch.float32),
                           (130, 31, 1152, 1000, torch.uint8),
                           (1, 1, 32, 8, torch.float32),
                           (9, 40, 160, 2056, torch.uint8),
                           (133, 17, 1152, 2056, torch.float32)):
        args = f32_inputs(b, s, d, k, dt)
        f32_check(f"dbof f32 edge B={b} S={s} D={d} K={k} {dt}",
                  serve(*args), dbof_cluster_maxpool_plain(*args))
    x, w, s_in, b_in, s_act, b_act = f32_inputs(6, 7, 64, 264, torch.uint8)
    got = serve(x, torch.full_like(w, -1.0), torch.ones_like(s_in),
                torch.full_like(b_in, 1.0), s_act,
                torch.full_like(b_act, 3.0))
    check(bool(torch.all(got == 0)),
          "dbof f32: padded frame rows leaked into the max")
    args = f32_inputs(BATCH, FRAMES, FEATURE_DIM, CLUSTERS, torch.uint8)
    x, w, s_in, b_in, s_act, b_act = args
    w_split = split_weights(w)
    got = dbof_cluster_maxpool_v2(*args, w_split)
    want = dbof_cluster_maxpool_plain(*args)
    torch.cuda.synchronize()
    err = f32_check("dbof_cluster_maxpool_v2 f32", got, want)
    # The same function with its product in float64, 256 videos at a time.
    want64 = torch.empty(BATCH, CLUSTERS, dtype=torch.float64, device=dev)
    for v0 in range(0, BATCH, 256):
        xa = x[v0:v0 + 256].to(torch.float32) * s_in + b_in
        act = torch.matmul(xa.double(), w.double())
        want64[v0:v0 + 256] = torch.amax(torch.relu(
            act * s_act.double() + b_act.double()), dim=1)
    witness = f64_witness(torch, f"dbof_cluster_maxpool_v2 f32 B={BATCH}",
                          got, want, want64)
    del got, want, want64

    def library():
        act = torch.matmul(x.to(torch.float32) * s_in + b_in, w)
        return torch.amax(torch.relu(act * s_act + b_act), dim=1)

    r = f32_timing(
        torch, lambda: dbof_cluster_maxpool_v2(*args, w_split),
        lambda: dbof_cluster_maxpool_plain(*args), library,
        ("input_affine_split", "dbof_cluster_maxpool_kernel"),
        flush, 5, 2.0 * BATCH * FRAMES * FEATURE_DIM * CLUSTERS,
        BATCH * FRAMES * FEATURE_DIM + FEATURE_DIM * CLUSTERS * 4
        + 4 * (2 * FEATURE_DIM + 2 * CLUSTERS) + BATCH * CLUSTERS * 4,
        split_bytes=FEATURE_DIM * CLUSTERS * 4)
    r["max_abs_err"] = err
    r["witness_f64"] = witness
    r["depth_witness"] = depth_witness(torch, gen, dev)
    say_f32("dbof_cluster_maxpool_v2",
            f"B={BATCH} S={FRAMES} D={FEATURE_DIM} K={CLUSTERS}", r)
    del args, x, w, w_split
    torch.cuda.empty_cache()
    return r


def moe_split(torch, wg, we):
    """The MoE head's f32 weights' split copies (MoeHead's f32 serving
    constants)."""
    from yt8m_tpu_torch.kernels.tf32 import split_weights

    return split_weights(wg), split_weights(we)


def moe_f64(torch, x, wg, we, be, m):
    """The MoE head's function with its products in float64."""
    b, c = x.shape[0], we.shape[1] // m
    g = torch.matmul(x.double(), wg.double())
    e = torch.matmul(x.double(), we.double()) + be.double()
    eg = torch.exp(torch.clamp(g, -80.0, 80.0)).reshape(b, c, m + 1)
    num = torch.sum(eg[..., :m] * torch.sigmoid(e.reshape(b, c, m)), -1)
    return num / torch.sum(eg, -1)


def check_f32_moe(torch, gen, dev, flush) -> dict:
    """The MoE head's 3xTF32 route (the weights' split copies) against
    the plain version at edge shapes and the flagship's serving shape,
    with its float64 witness there."""
    from yt8m_tpu_torch.kernels.moe_head import (
        moe_head_plain,
        moe_head_serving,
        pitched,
    )

    def f32_inputs(b, h, c, m):
        x, wg, we, be = moe_inputs(torch, gen, b, h, c, m, dev)
        return [x, pitched(wg.float()), pitched(we.float()), be]

    for b, h, c, m in ((37, 64, 83, 1), (70, 1000, 44, 2), (5, 999, 31, 16),
                       (130, 1024, CLASSES, 4), (9, 40, 300, 3),
                       (129, 37, 83, 5), (3, 2048, 4716, 17)):
        args = f32_inputs(b, h, c, m)
        f32_check(f"moe f32 edge B={b} H={h} C={c} M={m}",
                  moe_head_serving(*args, m, moe_split(torch, *args[1:3])),
                  moe_head_plain(*args, m))
    b, h = FLAG_BATCH, VLAD_HIDDEN + LSTM_CELLS
    args = f32_inputs(b, h, CLASSES, MIXTURES)
    split = moe_split(torch, *args[1:3])
    got = moe_head_serving(*args, MIXTURES, split)
    want = moe_head_plain(*args, MIXTURES)
    err = f32_check("moe_head_serving f32", got, want)
    witness = f64_witness(torch, f"moe_head_serving f32 B={b} H={h}", got,
                          want, moe_f64(torch, *args, MIXTURES))
    del got, want
    x, wg, we, be = args

    def library():
        g = torch.matmul(x, wg)
        e = torch.matmul(x, we) + be
        gating = torch.softmax(g.reshape(b, CLASSES, MIXTURES + 1), -1)
        experts = torch.sigmoid(e.reshape(b, CLASSES, MIXTURES))
        return torch.sum(gating[..., :MIXTURES] * experts, -1)

    cols = CLASSES * (2 * MIXTURES + 1)
    r = f32_timing(
        torch, lambda: moe_head_serving(*args, MIXTURES, split),
        lambda: moe_head_plain(*args, MIXTURES), library,
        ("split_tf32", "moe_head_kernel"), flush, 10, 2.0 * b * h * cols,
        b * h * 4 + h * cols * 4 + CLASSES * MIXTURES * 4 + b * CLASSES * 4,
        split_bytes=h * cols * 4)
    r["max_abs_err"] = err
    r["witness_f64"] = witness
    say_f32("moe_head_serving", f"B={b} H={h} C={CLASSES} M={MIXTURES}", r)
    return r


def vlad_f64(torch, x, nf, wc, scale, bias, centers):
    """NetVLAD's function in float64 from the plain version's f32 frames
    (uint8 dequantized in f32), 128 videos at a time."""
    from yt8m_tpu_torch.models.frame_utils import l2_normalize

    f = x.shape[1]
    outs = []
    for v0 in range(0, x.shape[0], 128):
        xf = x[v0:v0 + 128].to(torch.float32)
        if x.dtype == torch.uint8:
            xf = xf * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
        x64 = xf.double()
        act = torch.matmul(x64, wc.double()) * scale.double() + bias.double()
        live = (torch.arange(f, device=x.device)[None, :]
                < nf[v0:v0 + 128, None])
        assign = torch.softmax(act, dim=-1) * live[..., None]
        vlad = torch.matmul(assign.transpose(1, 2), x64)
        vlad = vlad - assign.sum(1)[..., None] * centers.double()
        outs.append(l2_normalize(l2_normalize(vlad, dim=2), dim=(1, 2)))
    return torch.cat(outs)


def check_f32_netvlad(torch, gen, dev, flush) -> dict:
    """NetVLAD's 3xTF32 route (Wc's split copy, as the models' serving
    constants hold it) against the plain version at edge shapes, the
    planted hazard and the serving shape, with its float64 witness
    there."""
    from yt8m_tpu_torch.kernels.netvlad import (
        netvlad_aggregate,
        netvlad_aggregate_plain,
    )
    from yt8m_tpu_torch.kernels.tf32 import split_weights
    from yt8m_tpu_torch.models.frame_utils import l2_normalize

    def f32_inputs(b, f, d, k, dt):
        args = vlad_inputs(torch, gen, b, f, d, k, dt, dev)
        args[2] = args[2].float()
        return args

    def serve(*args):
        return netvlad_aggregate(*args, split_weights(args[2]))

    for b, f, d, k, dt in ((5, 13, 128, 8, torch.uint8),
                           (4, 70, 100, 37, torch.float32),
                           (3, 130, 256, 512, torch.uint8),
                           (6, 65, 1001, 130, torch.float32),
                           (1, 1, 128, 64, torch.uint8)):
        args = f32_inputs(b, f, d, k, dt)
        got = serve(*args)
        f32_check(f"netvlad f32 edge B={b} F={f} D={d} K={k} {dt}", got,
                  netvlad_aggregate_plain(*args), abs_=NETVLAD_F32_ABS)
        if b > 1:
            check(bool(torch.all(got[1] == 0)),
                  "netvlad f32: num_frames = 0 is not a zero descriptor")
    b, f, d, k = FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM, VLAD_CLUSTERS
    x, nf, wc, scale, bias, centers = f32_inputs(b, f, d, k, torch.uint8)
    w_split = split_weights(wc)
    past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
    clean, x = pad_hazard(torch, x, past, 255)
    args = (x, nf, wc, scale, bias, centers)
    got = netvlad_aggregate(*args, w_split)
    check(torch.equal(got, netvlad_aggregate(clean, *args[1:], w_split)),
          "netvlad f32: frames past num_frames leaked")
    want = netvlad_aggregate_plain(*args)
    err = f32_check("netvlad_aggregate f32", got, want, abs_=NETVLAD_F32_ABS)
    witness = f64_witness(torch, f"netvlad_aggregate f32 B={b}", got, want,
                          vlad_f64(torch, *args), abs_=NETVLAD_F32_ABS)
    del got, want, clean
    live = torch.arange(f, device=dev)[None, :] < nf[:, None]

    def library():
        xf = x.to(torch.float32) * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
        act = torch.matmul(xf, wc) * scale + bias
        assign = torch.softmax(act, dim=-1) * live[..., None]
        vlad = torch.bmm(assign.transpose(1, 2), xf)
        vlad = vlad - assign.sum(1)[..., None] * centers
        return l2_normalize(l2_normalize(vlad, dim=2), dim=(1, 2))

    rows = int(live.sum())
    r = f32_timing(
        torch, lambda: netvlad_aggregate(*args, w_split),
        lambda: netvlad_aggregate_plain(*args), library, "nv_",
        flush, 10, 4.0 * rows * d * k,
        rows * d + d * k * 4 + k * d * 4 + 8 * k + b * k * d * 4 + 4 * b,
        split_bytes=d * k * 4)
    r["max_abs_err"] = err
    r["witness_f64"] = witness
    say_f32("netvlad_aggregate", f"B={b} F={f} D={d} K={k} uint8 ({rows} "
                                 f"live frames)", r)
    torch.cuda.empty_cache()
    return r


def attention_f64(torch, x, nf, q):
    """Attention pooling's function in float64 from the plain version's
    f32 frames (uint8 dequantized in f32)."""
    xf = x.to(torch.float32)
    if x.dtype == torch.uint8:
        xf = xf * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
    x64 = xf.double()
    f = x.shape[1]
    live = torch.arange(f, device=x.device)[None, :] < nf.long()[:, None]
    scores = torch.where(live[..., None], torch.matmul(x64, q.double()),
                         -1e9)
    return torch.matmul(torch.softmax(scores, dim=1).transpose(1, 2), x64)


def check_f32_attention(torch, gen, dev, flush) -> dict:
    """Attention pooling's 3xTF32 route against the plain version at edge
    shapes, the planted hazard and the serving shape, with its float64
    witness there."""
    from yt8m_tpu_torch.kernels.attention_pool import (
        attention_pool,
        attention_pool_plain,
    )

    def f32_inputs(b, f, d, h, dt):
        x, nf, q = attention_inputs(torch, gen, b, f, d, h, dt, dev)
        return [x, nf, q.float()]

    for b, f, d, h, dt in ((5, 13, 32, 4, torch.uint8),
                           (3, 70, 1001, 3, torch.float32),
                           (4, 20, 64, 19, torch.uint8),
                           (2, 1, 8, 1, torch.float32),
                           (6, FLAG_FRAMES, FEATURE_DIM, 16, torch.uint8),
                           (6, FLAG_FRAMES, FEATURE_DIM, 16, torch.float32)):
        args = f32_inputs(b, f, d, h, dt)
        f32_check(f"attention f32 edge B={b} F={f} D={d} H={h} {dt}",
                  attention_pool(*args), attention_pool_plain(*args))
    b, f, d, h = FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM, ATTN_HEADS
    x, nf, q = f32_inputs(b, f, d, h, torch.uint8)
    past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
    past[nf <= 0] = False  # an empty video averages all its rows
    clean, x = pad_hazard(torch, x, past, 255)
    got = attention_pool(x, nf, q)
    check(torch.equal(got, attention_pool(clean, nf, q)),
          "attention_pool f32: frames past num_frames leaked")
    want = attention_pool_plain(x, nf, q)
    err = f32_check("attention_pool f32", got, want)
    witness = f64_witness(torch, f"attention_pool f32 B={b}", got, want,
                          attention_f64(torch, x, nf, q))
    del got, want, clean
    live = torch.arange(f, device=dev)[None, :] < nf[:, None]
    live[nf <= 0] = True

    def library():
        xf = x.to(torch.float32) * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
        scores = torch.matmul(xf, q).masked_fill(~live[..., None], -1e9)
        return torch.bmm(torch.softmax(scores, dim=1).transpose(1, 2), xf)

    # The frames the kernel reads (live ones; all F of an empty video),
    # the count of the bound's bytes and operations.
    rows = int(live.sum())
    r = f32_timing(
        torch, lambda: attention_pool(x, nf, q),
        lambda: attention_pool_plain(x, nf, q), library,
        "attention_pool_kernel", flush, 10, 4.0 * rows * d * h,
        rows * d + d * h * 4 + b * h * d * 4 + 4 * b)
    r["max_abs_err"] = err
    r["witness_f64"] = witness
    say_f32("attention_pool", f"B={b} F={f} D={d} H={h} uint8 ({rows} "
                              f"frames read)", r)
    return r


def check_f32_routes(torch, gen, dev, flush) -> dict:
    """The four f32 routes against their plain versions at small, odd and
    ragged shapes and at their serving shapes, with their times: {row
    name: the route's numbers}."""
    return {"dbof_cluster_maxpool_v2": check_f32_dbof(torch, gen, dev, flush),
            "moe_head_serving": check_f32_moe(torch, gen, dev, flush),
            "netvlad_aggregate": check_f32_netvlad(torch, gen, dev, flush),
            "attention_pool": check_f32_attention(torch, gen, dev, flush)}


# ---------------------------------------------------------------------------
# phase 3 (cont.): the shapes past the kernels' old limits
# ---------------------------------------------------------------------------

# The MoE head at M > 16, NetVLAD serving and netvlad_core at K > 512, at
# the serving shape B=512 (the flagship's H=2048 for the MoE, F=300,
# D=1152 with uint8 frames for NetVLAD) and the training shape B=256.
NEW_MIXTURES = (17, 32, 200)
NEW_VLAD_CLUSTERS = (520, 1024, 2048)
NEW_CORE_CLUSTERS = (520, 1024)


def shape_row(shape, route, err, fn, plain, library, needle, flush, reps,
              flops, nbytes, peak, split_bytes=0) -> dict:
    """A new shape's numbers: the max error, CUDA-event and profiler
    times, the plain version's and the torch.matmul graph's, the bound
    (route_bound)."""
    import torch

    ms = time_ms(torch, fn, reps, flush)
    device_ms = device_us(torch, fn, needle) / 1e3
    plain_ms = time_ms(torch, plain, 3, flush)
    library_ms = time_ms(torch, library, 3, flush)
    row = {"shape": shape, "route": route, "max_abs_err": err, "ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           **route_bound(flops, nbytes, peak, split_bytes)}
    say("kernel", f"{shape} {route}: ok, max|diff| {err:.3e}; {ms:.4f} ms "
                  f"events, {device_ms:.4f} ms profiler (plain {plain_ms:.4f},"
                  f" torch.matmul graph {library_ms:.4f}, {say_bound(row)})")
    return row


def check_new_moe(torch, g, dev, flush) -> list:
    """moe_head_serving at M = 17 (the run-time tile), 32 and 200 (chunks
    of 120 mixtures), bf16 and f32 routes, at the flagship's B=512,
    H=2048, C=4716, against the plain version; gate logits past +-80 in
    an edge case of each route."""
    from yt8m_tpu_torch.kernels.moe_head import (
        moe_head_plain,
        moe_head_serving,
    )

    def normal_pitched(rows, cols, std, dtype):
        # pitched()'s layout drawn in place: no full-size temporaries (the
        # f32 gates alone are 7.8 GB at M=200).
        buf = torch.zeros(rows, -(-cols // 8) * 8, dtype=dtype, device=dev)
        return buf[:, :cols].normal_(0.0, std, generator=g)

    def inputs(b, h, c, m, dtype, scale=1.0):
        x = torch.randn(b, h, device=dev, generator=g).abs()
        wg = normal_pitched(h, c * (m + 1), scale * h ** -0.5, dtype)
        we = normal_pitched(h, c * m, h ** -0.5, dtype)
        be = 0.1 * torch.randn(c * m, device=dev, generator=g)
        return [x, wg, we, be]

    def serve(x, wg, we, be, m, split=None):
        # The f32 route reads the weights' split copies (the model's
        # serving constants); made here where the call does not pass them.
        if wg.dtype == torch.float32 and split is None:
            split = moe_split(torch, wg, we)
        return moe_head_serving(x, wg, we, be, m, split)

    rows = []
    for dtype, route in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rel, abs_ = (1e-3, 1e-5) if route == "bf16" else (F32_REL, 1e-5)
        for m in (122, 240, 241):  # a chunk's edges, the dummy alone
            args = inputs(37, 96, 83, m, dtype)
            rel_check(f"moe {route} edge M={m}", serve(*args, m),
                      moe_head_plain(*args, m), rel, abs_)
        args = inputs(16, 64, 40, 200, dtype, scale=400.0)
        got = serve(*args, 200)
        check(bool(torch.isfinite(got).all()),
              f"moe {route} M=200: non-finite with gate logits past 80")
        rel_check(f"moe {route} M=200 clamp case", got,
                  moe_head_plain(*args, 200), rel, abs_)
        b, h, c = FLAG_BATCH, VLAD_HIDDEN + LSTM_CELLS, CLASSES
        for m in NEW_MIXTURES:
            args = inputs(b, h, c, m, dtype)
            split = moe_split(torch, *args[1:3]) if route == "f32" else None
            err = rel_check(f"moe_head_serving {route} M={m}",
                            serve(*args, m, split),
                            moe_head_plain(*args, m), rel, abs_)
            x, wg, we, be = args

            def library(x=x, wg=wg, we=we, be=be, m=m):
                xa = x.to(dtype)
                gl = torch.matmul(xa, wg).to(torch.float32)
                el = torch.matmul(xa, we).to(torch.float32) + be
                gating = torch.softmax(gl.reshape(b, c, m + 1), -1)
                experts = torch.sigmoid(el.reshape(b, c, m))
                return torch.sum(gating[..., :m] * experts, -1)

            cols = c * (2 * m + 1)
            wbytes = 2 if route == "bf16" else 4
            rows.append(shape_row(
                f"moe_head_serving B={b} H={h} C={c} M={m}", route, err,
                lambda args=args, m=m, split=split: serve(*args, m, split),
                lambda args=args, m=m: moe_head_plain(*args, m), library,
                "moe_" if route == "bf16" else ("split_tf32",
                                                "moe_head_kernel"),
                flush, 5, 2.0 * b * h * cols,
                b * h * 4 + h * cols * wbytes + c * m * 4 + b * c * 4,
                PEAK_BF16_FLOPS if route == "bf16" else PEAK_F32_FLOPS,
                split_bytes=0 if route == "bf16" else h * cols * 4))
            del args, x, wg, we, be, library, split
            torch.cuda.empty_cache()
    return rows


def check_new_netvlad(torch, g, dev, flush) -> list:
    """netvlad_aggregate at K = 520, 1024 and 2048 (the logits tiled over
    K, the softmax in a second launch), bf16 and f32 routes, at B=512,
    F=300, D=1152 with uint8 frames: frames past num_frames planted
    (255; the result bit for bit that of zeros there), a video with no
    frame, a cluster no frame is assigned to; padded clusters (K = 1020,
    bias -1e30) at a small batch; the bf16 rounding witness at K=1024.
    The f32 route reads Wc's split copy (3xTF32: the logits tiled over K
    above 256)."""
    from yt8m_tpu_torch.kernels.netvlad import (
        netvlad_aggregate,
        netvlad_aggregate_plain,
    )
    from yt8m_tpu_torch.kernels.tf32 import split_weights
    from yt8m_tpu_torch.models.frame_utils import l2_normalize

    def inputs(b, f, d, k, wdtype):
        x = torch.randint(0, 256, (b, f, d), device=dev, dtype=torch.uint8,
                          generator=g)
        nf = torch.randint(1, f + 1, (b,), device=dev, dtype=torch.int32,
                           generator=g)
        nf[:3] = torch.tensor([f, 0, 1], dtype=torch.int32, device=dev)
        wc = (torch.randn(d, k, device=dev, generator=g) * d ** -0.5).to(
            wdtype)
        scale = 0.5 + torch.rand(k, device=dev, generator=g)
        bias = 0.3 * torch.randn(k, device=dev, generator=g)
        centers = torch.randn(k, d, device=dev, generator=g) * d ** -0.5
        return [x, nf, wc, scale, bias, centers]

    def serve(*args):
        # The f32 route reads Wc's split copy (the models' serving
        # constant).
        wc = args[2]
        return netvlad_aggregate(*args, split_weights(wc)
                                 if wc.dtype == torch.float32 else None)

    rows = []
    for wdtype, route in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        rel, abs_ = ((VLAD_REL, 1e-6) if route == "bf16"
                     else (F32_REL, NETVLAD_F32_ABS))
        # Padded clusters: K = 1020 runs as 1024, 4 of bias -1e30.
        args = inputs(16, 130, 256, 1020, wdtype)
        got = serve(*args)
        check(got.shape == (16, 1020, 256), f"netvlad {route} K=1020 shape")
        rel_check(f"netvlad {route} K=1020 (padded clusters)", got,
                  netvlad_aggregate_plain(*args), rel, abs_)
        b, f, d = FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM
        for k in NEW_VLAD_CLUSTERS:
            x, nf, wc, scale, bias, centers = inputs(b, f, d, k, wdtype)
            bias[7] = -1e4  # cluster 7: no frame is assigned to it
            past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
            clean, x = pad_hazard(torch, x, past, 255)
            args = (x, nf, wc, scale, bias, centers)
            got = serve(*args)
            check(torch.equal(got, serve(clean, *args[1:])),
                  f"netvlad {route} K={k}: frames past num_frames leaked")
            check(bool(torch.isfinite(got).all())
                  and bool(torch.all(got[1] == 0))
                  and bool(torch.all(got[:, 7] == 0)),
                  f"netvlad {route} K={k}: non-finite, or a video with no "
                  f"frame or an unassigned cluster not zeros")
            err = rel_check(f"netvlad_aggregate {route} K={k}", got,
                            netvlad_aggregate_plain(*args), rel, abs_)
            del got, clean
            if route == "bf16" and k == 1024:
                vlad_rounding_witness(torch, f"netvlad_aggregate K={k}",
                                      args)
            live = torch.arange(f, device=dev)[None, :] < nf[:, None]

            def library(args=args, live=live):
                x, _, wc, scale, bias, centers = args
                xf = x.to(torch.float32) * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
                xw = xf.to(wc.dtype)
                act = torch.matmul(xw, wc).to(torch.float32) * scale + bias
                a = torch.softmax(act, -1) * live[..., None]
                vlad = torch.matmul(a.to(wc.dtype).transpose(1, 2),
                                    xw).to(torch.float32)
                vlad = vlad - a.sum(1)[..., None] * centers
                return l2_normalize(l2_normalize(vlad, dim=2), dim=(1, 2))

            rows_live = int(nf.clamp(0, f).sum())
            wbytes = 2 if route == "bf16" else 4
            split = split_weights(wc) if route == "f32" else None
            rows.append(shape_row(
                f"netvlad_aggregate B={b} F={f} D={d} K={k} uint8 "
                f"({rows_live} live frames)", route, err,
                lambda args=args, split=split: netvlad_aggregate(*args,
                                                                 split),
                lambda args=args: netvlad_aggregate_plain(*args), library,
                "nv_", flush, 5, 4.0 * rows_live * d * k,
                rows_live * d + d * k * wbytes + k * d * 4 + 8 * k
                + b * k * d * 4 + 4 * b,
                PEAK_BF16_FLOPS if route == "bf16" else PEAK_F32_FLOPS,
                split_bytes=0 if route == "bf16" else d * k * 4))
            del args, x, wc, centers, library, split
            torch.cuda.empty_cache()
    return rows


def check_new_core(torch, g, dev, flush) -> list:
    """netvlad_core (--netvlad_fused_train) at K = 520 and 1024 at the
    training shape B=256, F=300, D=1152: the forward (fewer staged rows a
    chunk) and the backward (tiles of 512 clusters, then the row launch's
    softmax VJP) against the plain versions, the hazards past num_frames
    bit for bit, a second run bit for bit."""
    from yt8m_tpu_torch.kernels import netvlad_train as tnt

    rows = []
    b, f, d = TRAIN_BATCH, FLAG_FRAMES, FEATURE_DIM
    for k in NEW_CORE_CLUSTERS:
        act = 1.5 * torch.randn(b, f, k, device=dev, generator=g)
        x = (torch.randint(0, 256, (b, f, d), device=dev, generator=g)
             .to(torch.float32) * (4.0 / 255.0) + (4.0 / 512.0 - 2.0))
        nf = torch.randint(1, f + 1, (b,), device=dev, dtype=torch.int32,
                           generator=g)
        nf[:3] = torch.tensor([f, 0, 1], dtype=torch.int32, device=dev)
        centers = torch.randn(k, d, device=dev, generator=g) * d ** -0.5
        dvlad = torch.randn(b, k, d, device=dev, generator=g)
        past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
        clean_a, act = pad_hazard(torch, act, past, 3e4)
        clean_x, x = pad_hazard(torch, x, past, -1e5)
        args = [act, x, nf, centers]
        vlad, a_sum = tnt.netvlad_core_forward(*args)
        dact, dx = tnt.netvlad_core_backward(*args, dvlad)
        pv, pa = tnt.netvlad_core_plain_forward(*args)
        pda, pdx = tnt.netvlad_core_plain_backward(*args, dvlad)
        name = f"netvlad_core B={b} F={f} D={d} K={k}"
        err = max(rel_check(f"{name} {what}", got, want, rel=1e-3, abs_=1e-6)
                  for what, got, want in (("vlad", vlad, pv),
                                          ("a_sum", a_sum, pa),
                                          ("dact", dact, pda),
                                          ("dx", dx, pdx)))
        del pv, pa, pda, pdx
        clean = [clean_a, clean_x, nf, centers]
        again = tnt.netvlad_core_forward(*args)
        check(torch.equal(again[0], vlad) and torch.equal(again[1], a_sum)
              and torch.equal(tnt.netvlad_core_backward(*args, dvlad)[0],
                              dact),
              f"{name}: a second run is not bit for bit the first")
        check(all(torch.equal(p, q) for p, q in zip(
            tnt.netvlad_core_forward(*clean), (vlad, a_sum)))
            and torch.equal(tnt.netvlad_core_backward(*clean, dvlad)[0],
                            dact)
            and bool(torch.all(dact[past] == 0))
            and bool(torch.all(dx[past] == 0))
            and bool(torch.all(vlad[1] == 0)),
            f"{name}: frames past num_frames moved a result")
        del vlad, a_sum, dact, dx, again, clean, clean_a, clean_x
        mask = past.logical_not()[:, :, None]

        def library(act=act, x=x, centers=centers, dvlad=dvlad, mask=mask):
            a = act.detach().requires_grad_()
            p = torch.softmax(a, -1) * mask
            v = torch.matmul(p.to(torch.bfloat16).transpose(1, 2),
                             x.to(torch.bfloat16)).to(torch.float32)
            (v - p.sum(1)[:, :, None] * centers).backward(dvlad)

        def kernel(args=args, dvlad=dvlad):
            tnt.netvlad_core_forward(*args)
            tnt.netvlad_core_backward(*args, dvlad, False)

        def plain(args=args, dvlad=dvlad):
            tnt.netvlad_core_plain_forward(*args)
            tnt.netvlad_core_plain_backward(*args, dvlad, False)

        live = int(nf.clamp(0, f).sum())
        flops = 4.0 * live * k * d
        nbytes = (2 * (live * (k + d) * 4 + 4 * b + k * d * 4
                       + b * k * d * 4) + b * k * 4 + b * f * k * 4)
        row = shape_row(f"{name} ({live} live frames) forward + backward",
                        "bf16", err, kernel, plain, library, "vlad_", flush,
                        5, flops, nbytes, PEAK_BF16_FLOPS)
        row["ms_forward"] = time_ms(
            torch, lambda args=args: tnt.netvlad_core_forward(*args), 5,
            flush)
        row["ms_backward"] = time_ms(
            torch, lambda args=args, dvlad=dvlad: tnt.netvlad_core_backward(
                *args, dvlad, False), 5, flush)
        say("kernel", f"{name}: forward {row['ms_forward']:.4f} ms, "
                      f"backward without dx {row['ms_backward']:.4f} ms")
        rows.append(row)
        del args, act, x, centers, dvlad, library, kernel, plain
        torch.cuda.empty_cache()
    return rows


NEW_NEXTVLAD_CLUSTERS = (264, 520)


def nan_scratch(torch, fn):
    """fn() with every f32 tensor that torch.empty makes (the kernels'
    scratch and outputs) filled with NaN first."""
    real = torch.empty

    def empty(*args, **kwargs):
        t = real(*args, **kwargs)
        return t.fill_(float("nan")) if t.dtype == torch.float32 else t

    torch.empty = empty
    try:
        return fn()
    finally:
        torch.empty = real


def check_new_nextvlad(torch, g, dev, flush) -> list:
    """nextvlad_aggregate at K = 264 and 520 (above 256: the Logits launch
    and the wide softmax) at B=512, F=300, D=1152, G=8, lambda=2 with
    uint8 frames: frames past num_frames planted (255; the result bit for
    bit that of zeros there), a video with no frame, a padded cluster (K
    = 264 runs as Kp = 320; K = 520 as 576), a NaN-filled scratch giving
    the same bits; within 2^-7 * max|ref| of the plain version."""
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels import nextvlad as tnv

    b, f, d, lam, gr = (FLAG_BATCH, FLAG_FRAMES, FEATURE_DIM, NEXTVLAD_LAMBDA,
                        NEXTVLAD_GROUPS)
    de, p = lam * d, lam * d // gr
    rows = []
    for k in NEW_NEXTVLAD_CLUSTERS:
        gen = torch.Generator().manual_seed(k)
        x, nf, *w = nextvlad_inputs(torch, gen, b, f, d, lam, gr, k,
                                    torch.uint8, dev)
        past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
        clean, x = pad_hazard(torch, x, past, 255)
        layout = tnv.kernel_layout(*w, gr)
        got = tnv.nextvlad_aggregate(x, nf, *w, gr, layout=layout)
        check(torch.equal(got, tnv.nextvlad_aggregate(clean, nf, *w, gr,
                                                      layout=layout)),
              f"nextvlad K={k}: frames past num_frames leaked")
        check(bool(torch.isfinite(got).all()) and bool(torch.all(got[1] == 0)),
              f"nextvlad K={k}: non-finite, or num_frames=0 not zeros")
        nan_run = nan_scratch(torch, lambda: tnv.launch_forward(
            x, nf, layout)[0])
        check(torch.equal(nan_run, got),
              f"nextvlad K={k}: a NaN-filled scratch changed the output")
        del nan_run, clean
        err = rel_check(f"nextvlad_aggregate K={k}", got,
                        tnv.nextvlad_aggregate_plain(x, nf, *w, gr),
                        NEXTVLAD_REL, 1e-6)
        del got
        live = torch.arange(f, device=dev)[None, :] < nf[:, None]
        mask = live[:, :, None, None]
        bf = torch.bfloat16
        we_b, wa_b, wc_b = w[0].to(bf), w[1].to(bf), w[3].to(bf)

        def library(x=x, w=w, mask=mask, we_b=we_b, wa_b=wa_b, wc_b=wc_b,
                    k=k):
            xb = (x.to(torch.float32) * DEQUANT_SCALE + DEQUANT_BIAS).to(bf)
            xe = torch.matmul(xb, we_b)
            alpha = torch.sigmoid(torch.matmul(xe, wa_b).float() + w[2])
            act = torch.matmul(xe, wc_b).float().reshape(b, f, gr, k)
            a = torch.softmax(act, -1) * alpha[..., None] * mask
            vlad = torch.bmm(a.to(bf).reshape(b, f * gr, k).transpose(1, 2),
                             xe.reshape(b, f * gr, p)).float()
            vlad = vlad - a.sum((1, 2))[:, :, None] * w[4]
            return torch.nn.functional.normalize(vlad, dim=2, eps=1e-6)

        real = int(live.sum())
        kp = -(-k // 64) * 64
        # Inputs once, the output once; the bound counts no scratch.
        nbytes = (real * d + 4 * b + (d * de + de * gr + de * gr * k) * 2
                  + 4 * gr + k * p * 4 + b * k * p * 4)
        row = shape_row(
            f"nextvlad_aggregate B={b} F={f} D={d} G={gr} K={k} (Kp={kp}) "
            f"uint8 ({real} live frames)", "bf16", err,
            lambda x=x, nf=nf, w=w, layout=layout: tnv.nextvlad_aggregate(
                x, nf, *w, gr, layout=layout),
            lambda x=x, nf=nf, w=w: tnv.nextvlad_aggregate_plain(x, nf, *w,
                                                                 gr),
            library, "nxv_", flush, 5, nextvlad_flops(real, d, de, gr, k),
            nbytes, PEAK_BF16_FLOPS)
        split = device_kernels(torch, lambda x=x, nf=nf, w=w, layout=layout:
                               tnv.nextvlad_aggregate(x, nf, *w, gr,
                                                      layout=layout), "nxv_")
        row["device_ms_by_launch"] = {n: us / 1e3 for n, us in split.items()}
        say("kernel", f"nextvlad_aggregate K={k} by launch (profiler ms): "
            + launch_split(split))
        rows.append(row)
        del x, nf, w, layout, library, mask, live
        torch.cuda.empty_cache()
    return rows


def check_new_nextvlad_train(torch, g, dev, flush) -> list:
    """nextvlad_aggregate_train at K = 264 and 520 (above 256: the wide
    d_assign and its row VJP) at the training shape B=256, F=300: the
    forward and the five weight gradients within 2^-7 * max|ref| of the
    plain versions, a second run bit for bit, frames past num_frames
    leave every gradient bit for bit."""
    from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
    from yt8m_tpu_torch.kernels import nextvlad_train as tnt
    from yt8m_tpu_torch.kernels.nextvlad import nextvlad_aggregate_plain

    b, f, d, lam, gr = (TRAIN_BATCH, FLAG_FRAMES, FEATURE_DIM,
                        NEXTVLAD_LAMBDA, NEXTVLAD_GROUPS)
    de, p = lam * d, lam * d // gr
    rows = []
    for k in NEW_NEXTVLAD_CLUSTERS:
        gen = torch.Generator().manual_seed(k + 1)
        args = nextvlad_inputs(torch, gen, b, f, d, lam, gr, k, torch.uint8,
                               dev)
        x, nf, *w = args
        dy = torch.randn(b, k, p, generator=gen).to(dev)
        out, grads = nextvlad_train_grads(torch, args, gr, dy)
        errs = [rel_check(f"nextvlad_train K={k} forward", out,
                          nextvlad_aggregate_plain(*args, gr), NEXTVLAD_REL,
                          1e-6)]
        want = tnt.nextvlad_aggregate_train_plain_backward(*args, dy, gr)
        for name, got, ref in zip(("dWe", "dWa", "dab", "dWc", "dcenters"),
                                  grads, want):
            errs.append(rel_check(f"nextvlad_train K={k} {name}", got, ref,
                                  NEXTVLAD_REL, 1e-6))
        del want
        again = nextvlad_train_grads(torch, args, gr, dy)[1]
        check(all(torch.equal(a, c) for a, c in zip(grads, again)),
              f"nextvlad_train K={k}: a second run gave other gradient bits")
        past = torch.arange(f, device=dev)[None, :] >= nf[:, None]
        clean, loud = pad_hazard(torch, x, past, 255)
        a = nextvlad_train_grads(torch, [clean, nf, *w], gr, dy)[1]
        c = nextvlad_train_grads(torch, [loud, nf, *w], gr, dy)[1]
        check(all(torch.equal(p_, q_) for p_, q_ in zip(a, c)),
              f"nextvlad_train K={k}: frames past num_frames moved a "
              f"gradient")
        del a, c, again, clean, loud, out, grads
        live = past.logical_not()
        mask = live[:, :, None, None]
        bf = torch.bfloat16

        def library(x=x, w=w, mask=mask, dy=dy, k=k):
            ws = [t.detach().requires_grad_() for t in w]
            xb = (x.to(torch.float32) * DEQUANT_SCALE + DEQUANT_BIAS).to(bf)
            xe = torch.matmul(xb, ws[0].to(bf))
            alpha = torch.sigmoid(torch.matmul(xe, ws[1].to(bf)).float()
                                  + ws[2])
            act = torch.matmul(xe, ws[3].to(bf)).float().reshape(b, f, gr, k)
            a = torch.softmax(act, -1) * alpha[..., None] * mask
            vlad = torch.bmm(a.to(bf).reshape(b, f * gr, k).transpose(1, 2),
                             xe.reshape(b, f * gr, p)).float()
            vlad = vlad - a.sum((1, 2))[:, :, None] * ws[4]
            torch.nn.functional.normalize(vlad, dim=2, eps=1e-6).backward(dy)

        real = int(live.sum())
        f_flops = nextvlad_flops(real, d, de, gr, k)
        b_flops = 2.0 * real * (2 * gr * k * p + 2 * de * (gr * k + gr)
                                + d * de)
        nbytes = (real * d + 4 * b + (d * de + de * gr + de * gr * k) * 2 * 2
                  + 4 * gr + k * p * 4 + 2 * b * k * p * 4)
        row = shape_row(
            f"nextvlad_aggregate_train B={b} F={f} G={gr} K={k} ({real} live "
            f"frames) forward + backward", "bf16", max(errs),
            lambda args=args, dy=dy: nextvlad_train_grads(torch, args, gr, dy),
            lambda args=args, dy=dy: tnt.nextvlad_aggregate_train_plain_backward(
                *args, dy, gr),
            library, "nxv_", flush, 5, f_flops + b_flops, nbytes,
            PEAK_BF16_FLOPS)
        rows.append(row)
        del args, x, nf, w, dy, library, mask, live
        torch.cuda.empty_cache()
    return rows


def check_new_shapes(torch, dev, flush) -> dict:
    """Rows 2, 8, 9, 15 and 16 past their old limits (their own generator
    on the card: the other phases keep their inputs): {row name: [shape
    rows]}."""
    g = torch.Generator(device=dev).manual_seed(2121)
    return {"moe_head_serving": check_new_moe(torch, g, dev, flush),
            "netvlad_aggregate": check_new_netvlad(torch, g, dev, flush),
            "netvlad_core": check_new_core(torch, g, dev, flush),
            "nextvlad_aggregate": check_new_nextvlad(torch, g, dev, flush),
            "nextvlad_aggregate_train": check_new_nextvlad_train(
                torch, g, dev, flush)}


# ---------------------------------------------------------------------------
# phase 4: serving end to end, DbofModel and the flagship
# ---------------------------------------------------------------------------


def make_model(torch, seed: int, int8: bool = False, dtype="bfloat16"):
    """DbofModel at the reference width, weights from a seed, BN
    statistics and biases drawn; `int8` is --dbof_int8_serving, `dtype`
    --compute_dtype."""
    from yt8m_tpu_torch.models import ModelHParams, get_model

    hp = ModelHParams(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=300,
        dbof_cluster_size=CLUSTERS, dbof_hidden_size=HIDDEN,
        iterations=FRAMES, moe_num_mixtures=MIXTURES,
        compute_dtype=dtype, dbof_int8_serving=int8,
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


def perturb_vectors(torch, model, gen) -> None:
    """Non-trivial BatchNorm statistics and affines, recurrent and expert
    biases: every 1-D parameter and buffer drawn from `gen`."""
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
            else:  # BN shifts, recurrent and expert biases
                t.copy_(0.1 * torch.randn(n, generator=gen))
    model.invalidate_serving()


def make_flagship_model(torch, seed: int, fused_train: bool = False,
                        dtype="bfloat16", clusters=VLAD_CLUSTERS,
                        mixtures=MIXTURES, on_card=False):
    """NetVladLstmModel at the JAX package's default widths (or at
    `clusters` and `mixtures`), weights from a seed drawn on the card
    (card_init), non-trivial BatchNorm statistics and biases, on the CPU
    (`on_card`: left on the card); `fused_train` is
    --netvlad_fused_train."""
    from yt8m_tpu_torch.models import ModelHParams

    hp = ModelHParams(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=FLAG_FRAMES,
        netvlad_cluster_size=clusters, netvlad_hidden_size=VLAD_HIDDEN,
        netvlad_add_batch_norm=True, netvlad_gating=True,
        lstm_cells=LSTM_CELLS, lstm_layers=LSTM_LAYERS, lstm_pooling="last",
        moe_num_mixtures=mixtures, compute_dtype=dtype,
        netvlad_fused_train=fused_train,
    )
    model = card_init(torch, "NetVladLstmModel", hp, seed)
    return hp, model if on_card else model.cpu()


def card_init(torch, name, hp, seed):
    """`name` built and its weights drawn on the card from a seed (a
    card generator), its 1-D parameters and BN statistics from a CPU
    generator of the same seed, in eval mode on the card (on the CPU
    where there is none): a CPU draw takes ~18 s a billion parameters,
    and the makers run for every path, both sides of each comparison."""
    from yt8m_tpu_torch.models import get_model

    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    with torch.device(dev):
        model = get_model(name, hp)
        model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    perturb_vectors(torch, model, torch.Generator().manual_seed(seed))
    return model.eval()


def make_gru_model(torch, seed: int):
    """GruModel at the JAX package's defaults (GRU 2 x 1024 over all 300
    frames masked by num_frames, last pooling, MoE M=2 over 4716, bf16),
    weights from a seed, biases drawn."""
    from yt8m_tpu_torch.models import ModelHParams, get_model

    hp = ModelHParams(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=FLAG_FRAMES,
        gru_cells=GRU_CELLS, gru_layers=GRU_LAYERS, lstm_pooling="last",
        moe_num_mixtures=MIXTURES, compute_dtype="bfloat16",
    )
    model = get_model("GruModel", hp)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    perturb_vectors(torch, model, gen)
    with torch.no_grad():  # the gate biases around their initial 1
        for name, t in model.named_parameters():
            if name.endswith("gate_bias"):
                t.add_(1.0)
    model.invalidate_serving()
    return hp, model.eval()


def make_attention_model(torch, seed: int, dtype="bfloat16"):
    """AttentionPoolingModel at the JAX package's defaults (8 heads over
    all 300 frames masked by num_frames, hidden 512 with BN, MoE M=2 over
    4716, bf16), weights from a seed, non-trivial BN statistics."""
    from yt8m_tpu_torch.models import ModelHParams, get_model

    hp = ModelHParams(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=FLAG_FRAMES,
        attention_heads=ATTN_HEADS, attention_hidden_size=ATTN_HIDDEN,
        moe_num_mixtures=MIXTURES, compute_dtype=dtype,
    )
    model = get_model("AttentionPoolingModel", hp)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    perturb_vectors(torch, model, gen)
    return hp, model.eval()


def make_nextvlad_model(torch, seed: int, dtype="bfloat16",
                        clusters=NEXTVLAD_CLUSTERS):
    """NeXtVladModel at the JAX package's defaults (lambda=2, G=8, K=128
    (or `clusters`) over all 300 frames masked by num_frames, hidden 1024
    with BN and context gating, MoE M=2 over 4716, bf16), weights from a
    seed, BN statistics and biases drawn."""
    from yt8m_tpu_torch.models import ModelHParams, get_model

    hp = ModelHParams(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=FLAG_FRAMES,
        nextvlad_expansion=NEXTVLAD_LAMBDA, nextvlad_groups=NEXTVLAD_GROUPS,
        nextvlad_cluster_size=clusters,
        nextvlad_hidden_size=NEXTVLAD_HIDDEN, moe_num_mixtures=MIXTURES,
        compute_dtype=dtype,
    )
    model = get_model("NeXtVladModel", hp)
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    perturb_vectors(torch, model, gen)
    return hp, model.eval()


def make_zoo_model(name: str, **hparams):
    """A maker of `name` at the JAX package's default widths (MoE M=2 over
    4716 classes, bf16; frame models over all 300 frames masked by
    num_frames, video-level ones over mean_rgb + mean_audio, D=1152; other
    `hparams` where given), weights from a seed drawn on the card
    (card_init), every 1-D parameter and BN statistic drawn; on the
    CPU."""

    def make(torch, seed: int):
        from yt8m_tpu_torch.models import ModelHParams

        hp = ModelHParams(**{
            **dict(vocab_size=CLASSES, feature_dim=FEATURE_DIM,
                   max_frames=FLAG_FRAMES, moe_num_mixtures=MIXTURES,
                   compute_dtype="bfloat16"), **hparams})
        return hp, card_init(torch, name, hp, seed).cpu()

    return make


# The rest of the zoo: the kernels each model's serving path launches.
ZOO_PATHS = {
    "LogisticModel": ("exact_topk",),
    "MoeModel": ("moe_head_serving", "exact_topk"),
    "ChainMoeModel": ("moe_head_serving", "exact_topk"),
    "FrameLevelLogisticModel": ("exact_topk",),
    "GatedDbofModel": ("dbof_cluster_maxpool_v2", "moe_head_serving",
                       "exact_topk"),
    "SoftDbofModel": ("moe_head_serving", "exact_topk"),
    "LayerNormLstmModel": ("moe_head_serving", "exact_topk"),
    "FrameCnnModel": ("moe_head_serving", "exact_topk"),
    "NetFVModel": ("moe_head_serving", "exact_topk"),
    "ChainFrameModel": ("moe_head_serving", "exact_topk"),
    "ChainNetVladModel": ("netvlad_aggregate", "moe_head_serving",
                          "exact_topk"),
    "DeepCombineChainModel": ("moe_head_serving", "exact_topk"),
}
VIDEO_LEVEL = ("LogisticModel", "MoeModel", "ChainMoeModel")
CHAIN_STAGES = 3  # the JAX default --chain_stages
# Exact launches a batch (a serving step) where a path's count is part of
# its contract: a chain's stages each launch the MoE head, GatedDbofModel
# keeps DbofModel's fused kernel, the layer-norm LSTM runs its scan graph
# (no recurrence launch, as in the JAX package), SoftDbofModel the unfused
# graph.
PER_BATCH = {
    "ChainMoeModel": {"moe_head_serving": CHAIN_STAGES},
    "ChainFrameModel": {"moe_head_serving": CHAIN_STAGES},
    "ChainNetVladModel": {"moe_head_serving": CHAIN_STAGES,
                          "netvlad_aggregate": 1},
    "DeepCombineChainModel": {"moe_head_serving": CHAIN_STAGES},
    "GatedDbofModel": {"dbof_cluster_maxpool_v2": 1, "moe_head_serving": 1},
    "SoftDbofModel": {"dbof_cluster_maxpool_v2": 0, "moe_head_serving": 1},
    "LayerNormLstmModel": {"lstm_recurrence": 0, "moe_head_serving": 1},
    "LogisticModel": {"moe_head_serving": 0},
    "FrameLevelLogisticModel": {"moe_head_serving": 0},
}
# --compute_dtype=float32: each path's launches a batch, all of the f32
# routes where a kernel runs (the recurrence runs its scan graph and
# NeXtVLAD the JAX model's plain graph at float32, as in the JAX package).
F32 = "--compute_dtype=float32"
# Card vs CPU at float32: max|diff| <= 1e-5 * max|ref| of the
# probabilities (nothing is rounded to bf16; only the order of the f32
# sums differs on the two devices).
F32_CARD_VS_CPU = 1e-5
F32_PER_BATCH = {
    f"DbofModel {F32}": {"dbof_cluster_maxpool_v2": 1,
                         "moe_head_serving": 1},
    f"NetVladLstmModel {F32}": {"netvlad_aggregate": 1, "lstm_recurrence": 0,
                                "moe_head_serving": 1},
    f"AttentionPoolingModel {F32}": {"attention_pool": 1,
                                     "moe_head_serving": 1},
    f"NeXtVladModel {F32}": {"nextvlad_aggregate": 0, "moe_head_serving": 1},
    f"ChainNetVladModel {F32}": {"netvlad_aggregate": 1,
                                 "moe_head_serving": CHAIN_STAGES},
}
PER_BATCH.update(F32_PER_BATCH)
# The shapes past the kernels' old limits, and --moe_head_pallas=false
# (the plain head serves: no MoE launch).
WIDE_CLUSTERS, WIDE_MIXTURES = 1024, 32
WIDE_FLAGSHIP = (f"NetVladLstmModel --netvlad_cluster_size={WIDE_CLUSTERS} "
                 f"--moe_num_mixtures={WIDE_MIXTURES}")
# One chain stage (the default's depth, 3, cut): M=32 is what it holds.
WIDE_CHAIN = (f"ChainMoeModel --moe_num_mixtures={WIDE_MIXTURES} "
              f"--chain_stages=1")
PLAIN_MOE = "MoeModel --moe_head_pallas=false"
WIDE_NEXTVLAD_CLUSTERS = 520
WIDE_NEXTVLAD = f"NeXtVladModel --nextvlad_cluster_size={WIDE_NEXTVLAD_CLUSTERS}"
PER_BATCH.update({
    WIDE_NEXTVLAD: {"nextvlad_aggregate": 1, "moe_head_serving": 1},
    WIDE_FLAGSHIP: {"netvlad_aggregate": 1, "lstm_recurrence": LSTM_LAYERS,
                    "moe_head_serving": 1},
    WIDE_CHAIN: {"moe_head_serving": 1},
    PLAIN_MOE: {"moe_head_serving": 0},
})

# A path's name is the model's, then the CLI flags it runs with; the
# kernels it must launch.
PATHS = {
    "DbofModel": (make_model, ("dbof_cluster_maxpool_v2",
                               "moe_head_serving", "exact_topk")),
    "DbofModel --dbof_int8_serving": (
        lambda torch, seed: make_model(torch, seed, int8=True),
        ("dbof_cluster_maxpool_int8", "moe_head_serving", "exact_topk")),
    "NetVladLstmModel": (make_flagship_model, ("netvlad_aggregate",
                                               "lstm_recurrence",
                                               "moe_head_serving",
                                               "exact_topk")),
    "GruModel": (make_gru_model, ("gru_recurrence", "moe_head_serving",
                                  "exact_topk")),
    "AttentionPoolingModel": (make_attention_model, ("attention_pool",
                                                     "moe_head_serving",
                                                     "exact_topk")),
    "NeXtVladModel": (make_nextvlad_model, ("nextvlad_aggregate",
                                            "moe_head_serving",
                                            "exact_topk")),
    **{name: (make_zoo_model(name), names)
       for name, names in ZOO_PATHS.items()},
    f"DbofModel {F32}": (
        lambda torch, seed: make_model(torch, seed, dtype="float32"),
        ("dbof_cluster_maxpool_v2", "moe_head_serving", "exact_topk")),
    f"NetVladLstmModel {F32}": (
        lambda torch, seed: make_flagship_model(torch, seed,
                                                dtype="float32"),
        ("netvlad_aggregate", "moe_head_serving", "exact_topk")),
    f"AttentionPoolingModel {F32}": (
        lambda torch, seed: make_attention_model(torch, seed,
                                                 dtype="float32"),
        ("attention_pool", "moe_head_serving", "exact_topk")),
    f"NeXtVladModel {F32}": (
        lambda torch, seed: make_nextvlad_model(torch, seed, dtype="float32"),
        ("moe_head_serving", "exact_topk")),
    f"ChainNetVladModel {F32}": (
        make_zoo_model("ChainNetVladModel", compute_dtype="float32"),
        ("netvlad_aggregate", "moe_head_serving", "exact_topk")),
    WIDE_FLAGSHIP: (
        lambda torch, seed: make_flagship_model(
            torch, seed, clusters=WIDE_CLUSTERS, mixtures=WIDE_MIXTURES),
        ("netvlad_aggregate", "lstm_recurrence", "moe_head_serving",
         "exact_topk")),
    WIDE_CHAIN: (make_zoo_model("ChainMoeModel",
                                moe_num_mixtures=WIDE_MIXTURES,
                                chain_stages=1),
                 ("moe_head_serving", "exact_topk")),
    PLAIN_MOE: (make_zoo_model("MoeModel", moe_head_pallas=False),
                ("exact_topk",)),
    WIDE_NEXTVLAD: (
        lambda torch, seed: make_nextvlad_model(
            torch, seed, clusters=WIDE_NEXTVLAD_CLUSTERS),
        ("nextvlad_aggregate", "moe_head_serving", "exact_topk")),
}


def reader_flags(model_name: str) -> list:
    """The reader flags of a path: video-level mean_rgb + mean_audio, or
    the frame-level rgb + audio records."""
    if model_name in VIDEO_LEVEL:
        return ["--frame_features=false",
                "--feature_names=mean_rgb,mean_audio",
                "--feature_sizes=1024,128"]
    return ["--frame_features=true", "--feature_names=rgb,audio",
            "--feature_sizes=1024,128"]


def kernel_wrappers():
    from yt8m_tpu_torch.kernels.attention_pool import attention_pool
    from yt8m_tpu_torch.kernels.dbof import (
        dbof_cluster_maxpool,
        dbof_cluster_maxpool_int8,
        dbof_cluster_maxpool_v2,
        dbof_sampled_cluster_maxpool,
    )
    from yt8m_tpu_torch.kernels.dequant_matmul import dequant_affine_matmul
    from yt8m_tpu_torch.kernels.gru import gru_recurrence
    from yt8m_tpu_torch.kernels.gru_train import (
        gru_train_backward,
        gru_train_forward,
    )
    from yt8m_tpu_torch.kernels.lstm import lstm_recurrence
    from yt8m_tpu_torch.kernels.lstm_train import (
        lstm_train_backward,
        lstm_train_forward,
    )
    from yt8m_tpu_torch.kernels.moe_head import moe_head_serving
    from yt8m_tpu_torch.kernels.netvlad import netvlad_aggregate
    from yt8m_tpu_torch.kernels.netvlad_train import (
        netvlad_core_backward,
        netvlad_core_forward,
    )
    from yt8m_tpu_torch.kernels.nextvlad import nextvlad_aggregate
    from yt8m_tpu_torch.kernels.nextvlad_train import (
        nextvlad_train_backward,
        nextvlad_train_forward,
    )
    from yt8m_tpu_torch.kernels.topk import exact_topk

    return {fn.__name__: fn for fn in (
        dbof_cluster_maxpool_v2, moe_head_serving, exact_topk,
        netvlad_aggregate, lstm_recurrence, lstm_train_forward,
        lstm_train_backward, netvlad_core_forward, netvlad_core_backward,
        gru_recurrence, gru_train_forward, gru_train_backward,
        attention_pool, nextvlad_aggregate, nextvlad_train_forward,
        nextvlad_train_backward, dbof_cluster_maxpool_int8,
        dbof_cluster_maxpool, dbof_sampled_cluster_maxpool,
        dequant_affine_matmul)}


def zero_launches():
    wrappers = kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
        if hasattr(fn, "launches_f32"):
            fn.launches_f32 = 0
    return wrappers


def read_launches(torch, wrappers) -> dict:
    """Each wrapper's launches, and under "<name>:f32" those of its f32
    route (--compute_dtype=float32), which `launches` counts too."""
    torch.cuda.synchronize()
    out = {name: fn.launches for name, fn in wrappers.items()}
    out.update({f"{name}:f32": fn.launches_f32
                for name, fn in wrappers.items()
                if hasattr(fn, "launches_f32")})
    return out


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


def compare_with_cpu(torch, model, make, data_pattern, dev,
                     frame_level=True, rel=None) -> float:
    """Probabilities of 8 videos on the card vs the same model on the CPU
    (with the same sampled frames where the model samples): within 2e-3,
    or with `rel` (the f32 paths) within rel * max|ref|."""
    from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig

    rc = (ReaderConfig("rgb,audio", "1024,128", frame_features=True,
                       num_classes=CLASSES) if frame_level else
          ReaderConfig("mean_rgb,mean_audio", "1024,128",
                       frame_features=False, num_classes=CLASSES))
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
    limit = 2e-3 if rel is None else rel * cpu.abs().max().item()
    check(err <= limit, f"card vs CPU probabilities: max|diff| {err:.3e} > "
                        f"{limit:.3e}")
    top = torch.sort(cpu, dim=1, descending=True).values
    for i in range(8):
        if top[i, TOP_K - 1] - top[i, TOP_K] > 2e-3:
            a = set(torch.topk(gpu[i], TOP_K).indices.tolist())
            b = set(torch.topk(cpu[i], TOP_K).indices.tolist())
            check(a == b, f"video {i}: top-{TOP_K} sets differ card vs CPU")
    return err


def end_to_end(torch, dev, data, path) -> dict:
    """The inference CLI over the records under `data` on `path` (a model
    and its flags), its launch counts set to 0 just before and read just
    after: frame-level `test-*` records, or video-level `video-*` ones
    for a video-level model."""
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.convert import save_checkpoint

    make, names = PATHS[path]
    model_name, *flags = path.split()
    frame_level = model_name not in VIDEO_LEVEL
    split = "test" if frame_level else "video"
    hp, model = make(torch, seed=0)
    tag = "_".join(path.replace("-", "").split())
    run = os.path.join(os.path.dirname(data), f"run_{tag}")
    save_checkpoint(run, model, model_name, hp, frame_features=frame_level,
                    feature_names=("rgb,audio" if frame_level
                                   else "mean_rgb,mean_audio"),
                    feature_sizes="1024,128",
                    num_classes=CLASSES, max_frames=300,
                    label_loss="CrossEntropyLoss")
    out_csv = os.path.join(os.path.dirname(data), f"{tag}.csv")
    argv = [
        f"--input_data_pattern={data}/{split}-*.tfrecord",
        f"--train_dir={run}", f"--output_file={out_csv}",
        f"--batch_size={E2E_BATCH}", f"--top_k={TOP_K}",
        *reader_flags(model_name), f"--model={model_name}",
        f"--device={dev.type}", *flags,
    ]
    t0 = time.perf_counter()
    wrappers = zero_launches()
    stats = one_card(inference_cli)(argv)
    launches = read_launches(torch, wrappers)
    say("e2e", f"{path} inference CLI: {stats['num_videos']} videos, "
               f"{stats['videos_per_sec']:.1f} videos/s (batch {E2E_BATCH}, "
               f"reader included); launches {launches}")
    for name in names:
        check(launches[name] > 0,
              f"{name} was not launched on the {path} path")
    batches = -(-E2E_VIDEOS // E2E_BATCH)
    for name, per_batch in PER_BATCH.get(path, {}).items():
        check(launches[name] == per_batch * batches,
              f"{path}: {launches[name]} {name} launches in {batches} "
              f"batches, want {per_batch} a batch")
    if "--dbof_int8_serving" in flags:
        check(launches["dbof_cluster_maxpool_int8"] == batches
              and launches["dbof_cluster_maxpool_v2"] == 0,
              f"{path}: want {batches} int8 and 0 v2 launches")
    f32 = F32 in flags
    for name in ("dbof_cluster_maxpool_v2", "moe_head_serving",
                 "netvlad_aggregate", "attention_pool"):
        # Every launch of these is of the f32 route at float32, and of
        # the bf16 one else.
        want = launches[name] if f32 else 0
        check(launches[f"{name}:f32"] == want,
              f"{path}: {launches[f'{name}:f32']} of {launches[name]} "
              f"{name} launches took the f32 route, want {want}")
    check(stats["num_videos"] == E2E_VIDEOS, "video count")
    check(stats["nonfinite_predictions"] == 0, "non-finite predictions")
    check(check_csv(out_csv) == E2E_VIDEOS, "CSV line count")
    say("e2e", f"{path} CSV ok: {E2E_VIDEOS} lines of {TOP_K} pairs")
    cli_s = time.perf_counter() - t0
    rel = F32_CARD_VS_CPU if f32 else None
    err = compare_with_cpu(torch, model.to(dev), make,
                           f"{data}/{split}-*.tfrecord", dev, frame_level,
                           rel)
    say("e2e", f"{path} 8 videos card vs CPU: max|diff| {err:.3e} "
               + (f"<= {rel} * max|ref|" if f32 else "<= 2e-3"))
    del model
    shutil.rmtree(run, ignore_errors=True)
    return {"launches": launches, "videos_per_sec": stats["videos_per_sec"],
            "cli_s": cli_s, "max_abs_err": err}


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
    if model_name in VIDEO_LEVEL:
        feats = torch.rand(batch, FEATURE_DIM, device=dev, generator=gen)
    else:
        feats = torch.randint(0, 256, (batch, 300, FEATURE_DIM), device=dev,
                              dtype=torch.uint8, generator=gen)
    nf = torch.randint(FRAMES, 301, (batch,), device=dev, dtype=torch.int32,
                       generator=gen)
    step = make_topk_predict_step(model, TOP_K)
    for _ in range(2):
        step(feats, nf, gen)
    wrappers = zero_launches()
    step(feats, nf, gen)
    launches = {k: v for k, v in read_launches(torch, wrappers).items() if v}
    say("step", f"{model_name} launches in one step: {launches}")
    for name, want in PER_BATCH.get(model_name, {}).items():
        check(launches.get(name, 0) == want,
              f"{model_name} serving step: {launches.get(name, 0)} {name} "
              f"launches, want {want}")
    if model_name.endswith("--dbof_int8_serving"):
        check(launches.get("dbof_cluster_maxpool_int8") == 1
              and "dbof_cluster_maxpool_v2" not in launches,
              "int8 serving step: want 1 int8 and 0 v2 launches")
    # The persistent recurrences: one launch a layer.
    layers = {"NetVladLstmModel": ("lstm_recurrence", LSTM_LAYERS),
              "GruModel": ("gru_recurrence", GRU_LAYERS)}
    if model_name in layers:
        fn, want = layers[model_name]
        check(launches.get(fn) == want,
              f"{model_name} serving step: {launches.get(fn)} {fn} "
              f"launches, want {want} (one a layer)")
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

    # A step of ~100 ms or more fills a window alone (the profiler's
    # processing of a slow step's many small launches takes a minute).
    idle = profile_window(torch, "step", f"{model_name} serving",
                          lambda: step(feats, nf, gen),
                          1 if step_ms > 100 else 3)
    del model, feats
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"step_ms": step_ms, "idle_share": idle, "launches": launches}


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
        # The window loses the kernels launched as it opens (the first
        # step's first kernels, read on the card): a small kernel of no
        # interest goes first, outside the timed window.
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
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


def train_flagship(torch, dev, fused: bool = False) -> dict:
    """The flagship at full width trained through make_train_step, with
    the plain VLAD training graph or (`fused`, --netvlad_fused_train) the
    netvlad_core kernels: the training path, its launch counts set to 0
    just before the 10 steps and read just after."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState, clip_gradient_norms
    from yt8m_tpu_torch.train.step import make_train_step

    name = "NetVladLstmModel" + (" --netvlad_fused_train" if fused else "")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_flagship_model(torch, seed=0, fused_train=fused)[1]
    model = model.to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    state = TrainState(model, global_batch_size=TRAIN_BATCH)  # config defaults
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=1)
    wrappers = zero_launches()
    _, losses = timed_steps(torch, step, state, batch, TRAIN_STEPS)
    launches = read_launches(torch, wrappers)
    say("train", f"{name} B={TRAIN_BATCH} ({n_params} parameters, "
                 f"bf16, TF32 off, Adam, per-variable clip 1.0): "
                 f"{TRAIN_STEPS} steps on one batch, losses "
                 f"{[round(x, 4) for x in losses]}; launches {launches}, a "
                 f"step: {launches['lstm_train_forward'] // TRAIN_STEPS} "
                 f"forward and {launches['lstm_train_backward'] // TRAIN_STEPS}"
                 f" backward recurrence launches (one a layer each), "
                 f"{launches['netvlad_core_forward'] / TRAIN_STEPS:g} + "
                 f"{launches['netvlad_core_backward'] / TRAIN_STEPS:g} "
                 f"netvlad_core")
    check(all(math.isfinite(x) for x in losses), "training loss not finite")
    check(losses[-1] < losses[0], "training loss did not fall over 10 steps")
    for fn in ("lstm_train_forward", "lstm_train_backward"):
        check(launches[fn] == TRAIN_STEPS * LSTM_LAYERS,
              f"{fn}: {launches[fn]} launches, want one a layer a step: "
              f"{TRAIN_STEPS} x {LSTM_LAYERS}")
    for fn in ("netvlad_core_forward", "netvlad_core_backward"):
        check(launches[fn] == (TRAIN_STEPS if fused else 0),
              f"{fn}: {launches[fn]} launches in {TRAIN_STEPS} steps of "
              f"{name}")
    times, _ = timed_steps(torch, step, state, batch, 5)
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("train", f"{name} B={TRAIN_BATCH} training step: median "
                 f"{step_ms:.3f} ms of {[round(t, 3) for t in times]} -> "
                 f"{TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; peak memory "
                 f"{peak:.2f} GiB")
    idle = profile_window(torch, "train", f"{name} training",
                          lambda: step(state, batch), 1)
    if fused:
        del state, model, batch
        torch.cuda.empty_cache()
        return {"launches": launches, "step_ms": step_ms, "idle_share": idle,
                "peak_gib": peak}
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
    return {"launches": launches, "step_ms": step_ms, "idle_share": idle,
            "peak_gib": peak}


WIDE_TRAIN_STEPS = 3


def train_wide_flagship(torch, dev) -> dict:
    """The flagship at K=1024 and M=32 with --netvlad_fused_train (the
    assignment past one block of netvlad_core, the MoE head through its
    plain training graph) trained through make_train_step at B=256, its
    launch counts set to 0 just before the steps and read just after: a
    finite loss, the step time, one netvlad_core launch each way a
    step."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_flagship_model(torch, seed=0, fused_train=True,
                                clusters=WIDE_CLUSTERS,
                                mixtures=WIDE_MIXTURES,
                                on_card=True)[1].train()
    n_params = sum(p.numel() for p in model.parameters())
    state = TrainState(model, global_batch_size=TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=5)
    wrappers = zero_launches()
    times, losses = timed_steps(torch, step, state, batch, WIDE_TRAIN_STEPS)
    launches = read_launches(torch, wrappers)
    check(all(math.isfinite(x) for x in losses),
          f"{WIDE_FLAGSHIP} training loss not finite: {losses}")
    for fn in ("netvlad_core_forward", "netvlad_core_backward"):
        check(launches[fn] == WIDE_TRAIN_STEPS,
              f"{fn}: {launches[fn]} launches in {WIDE_TRAIN_STEPS} steps, "
              f"want one a step")
    step_ms = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("train", f"{WIDE_FLAGSHIP} --netvlad_fused_train B={TRAIN_BATCH} "
                 f"({n_params} parameters, bf16, Adam): losses "
                 f"{[round(x, 4) for x in losses]}, step "
                 f"{[round(t, 3) for t in times]} ms (median of the last "
                 f"{WIDE_TRAIN_STEPS - 1}: {step_ms:.3f}); peak memory "
                 f"{peak:.2f} GiB; netvlad_core launches "
                 f"{launches['netvlad_core_forward']} + "
                 f"{launches['netvlad_core_backward']}")
    del state, model, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak}


def train_wide_nextvlad(torch, dev) -> dict:
    """NeXtVladModel at K=520 (the wide trainable kernels) trained fused
    (the default --nextvlad_train_fused) through make_train_step at B=256,
    its launch counts set to 0 just before the steps and read just after:
    a finite loss, the step time, one launch each way a step."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_nextvlad_model(torch, seed=0,
                                clusters=WIDE_NEXTVLAD_CLUSTERS)[1]
    model = model.to(dev).train()
    state = TrainState(model, global_batch_size=TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=6)
    wrappers = zero_launches()
    times, losses = timed_steps(torch, step, state, batch, WIDE_TRAIN_STEPS)
    launches = read_launches(torch, wrappers)
    check(all(math.isfinite(x) for x in losses),
          f"{WIDE_NEXTVLAD} training loss not finite: {losses}")
    for fn in ("nextvlad_train_forward", "nextvlad_train_backward"):
        check(launches[fn] == WIDE_TRAIN_STEPS,
              f"{fn}: {launches[fn]} launches in {WIDE_TRAIN_STEPS} steps, "
              f"want one a step")
    step_ms = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("train", f"{WIDE_NEXTVLAD} fused B={TRAIN_BATCH} (bf16, Adam): "
                 f"losses {[round(x, 4) for x in losses]}, step "
                 f"{[round(t, 3) for t in times]} ms (median of the last "
                 f"{WIDE_TRAIN_STEPS - 1}: {step_ms:.3f}); peak memory "
                 f"{peak:.2f} GiB; launches "
                 f"{launches['nextvlad_train_forward']} + "
                 f"{launches['nextvlad_train_backward']}")
    del state, model, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak}


def train_dbof(torch, dev, dtype="bfloat16") -> dict:
    """DbofModel at bench_train.py's B=512, K=8192: no kernel in training
    (the plain graph), a few steps, a finite loss and the step time; at
    float32 (true f32: TF32 off) also a falling loss."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    model = make_model(torch, seed=0, dtype=dtype)[1].to(dev).train()
    state = TrainState(model, global_batch_size=DBOF_TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, DBOF_TRAIN_BATCH, seed=2)
    gen = torch.Generator(device=dev).manual_seed(3)
    warm = timed_steps(torch, step, state, batch, 2, gen)[1]
    times, losses = timed_steps(torch, step, state, batch, 5, gen)
    check(all(math.isfinite(x) for x in losses), "DbofModel loss not finite")
    if dtype == "float32":
        check(losses[-1] < warm[0], f"DbofModel f32 loss did not fall: "
                                    f"{warm + losses}")
    step_ms = statistics.median(times)
    say("train", f"DbofModel {dtype} B={DBOF_TRAIN_BATCH} K={CLUSTERS} "
                 f"training step: median {step_ms:.3f} ms of "
                 f"{[round(t, 3) for t in times]} -> "
                 f"{DBOF_TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; losses "
                 f"{[round(x, 4) for x in warm + losses]}")
    del state, model, batch
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "losses": warm + losses}


# The optimizers of the JAX package's make_optimizer beyond Adam with an
# f32 moment and SGD: (--optimizer, --adam_mu_dtype); Adam with the f32
# moment is the baseline of their state's bytes.
NEW_OPTIMIZERS = (("AdafactorOptimizer", "float32"),
                  ("RMSPropOptimizer", "float32"),
                  ("AdagradOptimizer", "float32"),
                  ("AdamOptimizer", "bfloat16"))
OPTIMIZER_STEPS = 3


def state_bytes(optimizer) -> int:
    """The bytes of an optimizer's state tensors (the step counts too)."""
    return sum(t.numel() * t.element_size()
               for st in optimizer.state.values() for t in st.values()
               if hasattr(t, "numel"))


def train_optimizers(torch, dev) -> dict:
    """The flagship at full width (B=256) for 3 steps under each new
    optimizer and under Adam f32 from the same weights and batch: finite
    losses, the step time (median of the last two) and the optimizer
    state's bytes beside Adam f32's."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    model = make_flagship_model(torch, seed=0)[1].to(dev).train()
    init = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=2)
    out = {}
    for name, mu in (("AdamOptimizer", "float32"), *NEW_OPTIMIZERS):
        model.load_state_dict(init)
        state = TrainState(model, optimizer=name, adam_mu_dtype=mu,
                           global_batch_size=TRAIN_BATCH)
        times, losses = timed_steps(torch, step, state, batch,
                                    OPTIMIZER_STEPS)
        check(all(math.isfinite(x) for x in losses),
              f"flagship under {name} ({mu}): loss not finite: {losses}")
        key = name if mu == "float32" else f"{name} mu={mu}"
        out[key] = {"step_ms": statistics.median(times[1:]),
                    "state_bytes": state_bytes(state.optimizer),
                    "losses": losses}
        del state
        torch.cuda.empty_cache()
    base = out["AdamOptimizer"]["state_bytes"]
    for key, r in out.items():
        r["state_vs_adam"] = r["state_bytes"] / base
        say("train", f"flagship B={TRAIN_BATCH} under {key}: step "
                     f"{r['step_ms']:.3f} ms (median of the last "
                     f"{OPTIMIZER_STEPS - 1}), state {r['state_bytes'] / 1e9:.4f}"
                     f" GB = {r['state_vs_adam']:.4f} x Adam f32's; losses "
                     f"{[round(x, 4) for x in r['losses']]}")
    for key in ("AdafactorOptimizer", "AdamOptimizer mu=bfloat16"):
        check(out[key]["state_bytes"] < base,
              f"{key}: state {out[key]['state_bytes']} B not below Adam "
              f"f32's {base} B")
    del model, init, batch
    torch.cuda.empty_cache()
    return out


def optimizers_card_vs_cpu(torch, dev) -> dict:
    """One training step of the flagship on 8 videos: its gradients from
    one backward on the card, then each new optimizer's update of the same
    weights with the same gradients on the card and on the CPU. Each
    parameter's move within 1e-5 * max|move on the CPU| + 2^-23 *
    max|parameter|: the same f32 elementwise arithmetic (the clip's
    float64 norms and the factored means are summed in another order),
    and the new weight w + u rounded to f32, where a last-bit difference
    in u can move the rounded weight one f32 step of itself (2.98e-8
    read on a weight near 0.3 whose Adafactor move was 1.9e-3 at most,
    above 1e-5 of the move)."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import compute_loss

    batch = train_batch(torch, dev, 8, seed=4)
    card = make_flagship_model(torch, seed=0)[1].to(dev).train()
    total, _, _, _ = compute_loss(card, batch, get_loss("CrossEntropyLoss"))
    total.backward()
    # The moves and their differences are taken in float64 on the card:
    # the same arithmetic as on the host, without its copies.
    init = {n: p.detach().clone() for n, p in card.named_parameters()}
    grads = {n: p.grad.detach().clone() for n, p in card.named_parameters()}
    host = make_flagship_model(torch, seed=0)[1].train()
    worst = {}
    for name, mu in NEW_OPTIMIZERS:
        moves = []
        for model, d in ((card, dev), (host, torch.device("cpu"))):
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(init[n])
                    p.grad = grads[n].to(d, copy=True)
            state = TrainState(model, optimizer=name, adam_mu_dtype=mu,
                               global_batch_size=TRAIN_BATCH)
            state.apply_gradients()
            moves.append({n: p.detach().to(dev).double() - init[n].double()
                          for n, p in model.named_parameters()})
            del state
        key = name if mu == "float32" else f"{name} mu={mu}"
        err = 0.0
        for n, want in moves[1].items():
            got = moves[0][n]
            e = (got - want).abs().max().item()
            limit = (1e-5 * want.abs().max().item() + 2.0 ** -23 * (
                init[n].abs().max().item() + want.abs().max().item()))
            check(e <= limit, f"{key} card vs CPU: {n} moved {e:.3e} apart "
                              f"> {limit:.3e}")
            err = max(err, e / max(want.abs().max().item(), 1e-30))
        worst[key] = err
        say("train", f"flagship one step under {key}, 8 videos, card vs "
                     f"CPU on the same gradients: every parameter's move "
                     f"within {err:.3e} of its largest (bound 1e-5 of it "
                     f"plus one f32 step of the weights)")
        del moves
    del card, host, init, grads, batch
    torch.cuda.empty_cache()
    return worst


def train_gru(torch, dev) -> dict:
    """GruModel at full width trained through make_train_step (B=256 as
    bench_train.py trains the LSTM family, bf16, Adam at the config
    defaults): the trainable GRU kernels' path, its launch counts set to
    0 just before the 10 steps and read just after."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_gru_model(torch, seed=0)[1].to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    state = TrainState(model, global_batch_size=TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=1)
    wrappers = zero_launches()
    _, losses = timed_steps(torch, step, state, batch, TRAIN_STEPS)
    launches = read_launches(torch, wrappers)
    say("train", f"GruModel B={TRAIN_BATCH} ({n_params} parameters, bf16, "
                 f"Adam, per-variable clip 1.0): {TRAIN_STEPS} steps on one "
                 f"batch, losses {[round(x, 4) for x in losses]}; launches "
                 f"{launches}, a step: "
                 f"{launches['gru_train_forward'] // TRAIN_STEPS} forward and "
                 f"{launches['gru_train_backward'] // TRAIN_STEPS} backward "
                 f"recurrence launches (one a layer each)")
    check(all(math.isfinite(x) for x in losses), "GruModel loss not finite")
    check(losses[-1] < losses[0], "GruModel loss did not fall over 10 steps")
    want = TRAIN_STEPS * GRU_LAYERS
    for fn in ("gru_train_forward", "gru_train_backward"):
        check(launches[fn] == want, f"{fn}: {launches[fn]} launches, want "
                                    f"one a layer a step: {want}")
    times, _ = timed_steps(torch, step, state, batch, 5)
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("train", f"GruModel B={TRAIN_BATCH} training step: median "
                 f"{step_ms:.3f} ms of {[round(t, 3) for t in times]} -> "
                 f"{TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; peak memory "
                 f"{peak:.2f} GiB")
    idle = profile_window(torch, "train", "GruModel training",
                          lambda: step(state, batch), 1)
    del state, model, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "idle_share": idle,
            "peak_gib": peak}


def train_attention(torch, dev) -> None:
    """AttentionPoolingModel at full width, B=256: the plain training
    graph (the JAX package trains it without its kernel), a few steps, a
    finite loss, no attention_pool launch, the step time."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    model = make_attention_model(torch, seed=0)[1].to(dev).train()
    state = TrainState(model, global_batch_size=TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=2)
    wrappers = zero_launches()
    timed_steps(torch, step, state, batch, 2)
    times, losses = timed_steps(torch, step, state, batch, 5)
    launches = read_launches(torch, wrappers)
    check(all(math.isfinite(x) for x in losses),
          "AttentionPoolingModel loss not finite")
    check(launches["attention_pool"] == 0,
          "AttentionPoolingModel training launched the serving kernel")
    step_ms = statistics.median(times)
    say("train", f"AttentionPoolingModel B={TRAIN_BATCH} training step "
                 f"(plain graph): median {step_ms:.3f} ms of "
                 f"{[round(t, 3) for t in times]} -> "
                 f"{TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; losses "
                 f"{[round(x, 4) for x in losses]}")
    del state, model, batch
    torch.cuda.empty_cache()


def train_nextvlad(torch, dev) -> dict:
    """NeXtVladModel at full width trained through make_train_step (B=256,
    bf16, Adam at the config defaults, the fused aggregation by default):
    the trainable NeXtVLAD kernels' path, its launch counts set to 0 just
    before the 10 steps and read just after."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = make_nextvlad_model(torch, seed=0)[1].to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    state = TrainState(model, global_batch_size=TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=1)
    wrappers = zero_launches()
    _, losses = timed_steps(torch, step, state, batch, TRAIN_STEPS)
    launches = read_launches(torch, wrappers)
    say("train", f"NeXtVladModel B={TRAIN_BATCH} ({n_params} parameters, "
                 f"bf16, Adam, per-variable clip 1.0): {TRAIN_STEPS} steps on "
                 f"one batch, losses {[round(x, 4) for x in losses]}; "
                 f"launches {launches}")
    check(all(math.isfinite(x) for x in losses),
          "NeXtVladModel loss not finite")
    check(losses[-1] < losses[0],
          "NeXtVladModel loss did not fall over 10 steps")
    for fn in ("nextvlad_train_forward", "nextvlad_train_backward"):
        check(launches[fn] == TRAIN_STEPS,
              f"{fn}: {launches[fn]} launches in {TRAIN_STEPS} steps")
    check(launches["nextvlad_aggregate"] == 0,
          "NeXtVladModel training launched the serving wrapper")
    times, _ = timed_steps(torch, step, state, batch, 5)
    step_ms = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("train", f"NeXtVladModel B={TRAIN_BATCH} training step: median "
                 f"{step_ms:.3f} ms of {[round(t, 3) for t in times]} -> "
                 f"{TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; peak memory "
                 f"{peak:.2f} GiB")
    idle = profile_window(torch, "train", "NeXtVladModel training",
                          lambda: step(state, batch), 1)
    del state, model, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "idle_share": idle,
            "peak_gib": peak}


ZOO_TRAIN_STEPS = 8


def train_zoo(torch, dev, name, fused=False) -> dict:
    """`name` at the JAX defaults trained through make_train_step (B=256,
    bf16, Adam at the config defaults) for ZOO_TRAIN_STEPS steps on one
    batch, its launch counts set to 0 just before and read just after: a
    falling loss, the median time of the last six steps, the peak memory;
    `fused` is --netvlad_fused_train (1 + 1 netvlad_core launches a step,
    else none). No serving kernel launches in training."""
    from yt8m_tpu_torch.models import ModelHParams, get_model
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    label = name + (" --netvlad_fused_train" if fused else "")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hp = ModelHParams(vocab_size=CLASSES, feature_dim=FEATURE_DIM,
                      max_frames=FLAG_FRAMES, moe_num_mixtures=MIXTURES,
                      compute_dtype="bfloat16", netvlad_fused_train=fused)
    model = get_model(name, hp)
    gen = torch.Generator().manual_seed(0)
    model.reset_parameters(gen)
    perturb_vectors(torch, model, gen)
    model = model.to(dev).train()
    n_params = sum(p.numel() for p in model.parameters())
    state = TrainState(model, global_batch_size=TRAIN_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"),
                           aux_loss_weight=hp.chain_aux_loss_weight)
    batch = train_batch(torch, dev, TRAIN_BATCH, seed=1)
    wrappers = zero_launches()
    times, losses = timed_steps(torch, step, state, batch, ZOO_TRAIN_STEPS)
    launches = read_launches(torch, wrappers)
    step_ms = statistics.median(times[2:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say("train", f"{label} B={TRAIN_BATCH} ({n_params} parameters, bf16, "
                 f"Adam): {ZOO_TRAIN_STEPS} steps on one batch, losses "
                 f"{[round(x, 4) for x in losses]}; step median "
                 f"{step_ms:.3f} ms of the last {len(times) - 2} "
                 f"{[round(t, 3) for t in times[2:]]} -> "
                 f"{TRAIN_BATCH / step_ms * 1e3:.0f} videos/s; peak memory "
                 f"{peak:.2f} GiB; launches "
                 f"{ {k: v for k, v in launches.items() if v} }")
    check(all(math.isfinite(x) for x in losses), f"{label} loss not finite")
    check(losses[-1] < losses[0],
          f"{label} loss did not fall over {ZOO_TRAIN_STEPS} steps")
    want = ZOO_TRAIN_STEPS if fused else 0
    for fn in ("netvlad_core_forward", "netvlad_core_backward"):
        check(launches[fn] == want,
              f"{label}: {launches[fn]} {fn} launches, want {want}")
    for fn in ("moe_head_serving", "netvlad_aggregate",
               "dbof_cluster_maxpool_v2", "exact_topk"):
        check(launches[fn] == 0, f"{label} training launched {fn}")
    del state, model, batch
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": step_ms, "peak_gib": peak,
            "losses": losses}


def train_card_vs_cpu(torch, dev, make=None, name="flagship") -> None:
    """One training forward and backward of `make`'s model (the flagship
    by default) on 8 videos, on the card and on the CPU, from the same
    weights and batch (bf16): the loss and each parameter's gradient
    norm, summed in float64 (the CPU's float32 norm of the VLAD hidden
    FC's 302 M-element gradient is off by percents)."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.step import compute_loss

    make = make or make_flagship_model
    batch = {k: v.cpu() for k, v in train_batch(torch, dev, 8, seed=4).items()}
    batch["num_frames"][:3] = torch.tensor([300, 1, 57], dtype=torch.int32)
    results = []
    for d in (dev, torch.device("cpu")):
        model = make(torch, seed=0)[1].to(d).train()
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
    check(loss_err <= 2e-3, f"{name} training loss card {gpu_loss} vs CPU "
                            f"{cpu_loss}")
    worst, worst_name = 0.0, ""
    for n, v in cpu.items():
        e = abs(gpu[n] - v) / max(v, 1e-6)
        check(e <= 2e-2, f"{name} gradient norm of {n}: card {gpu[n]:.6e} "
                         f"vs CPU {v:.6e}")
        if e > worst:
            worst, worst_name = e, n
    say("train", f"one {name} training step, 8 videos, card vs CPU: loss "
                 f"{gpu_loss:.6f} vs {cpu_loss:.6f} ({loss_err:.2e} "
                 f"relative, bound 2e-3); gradient norms of {len(cpu)} "
                 f"parameters within {worst:.2e} relative ({worst_name}; "
                 f"bound 2e-2)")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: the reference workflow through the port's CLIs
# ---------------------------------------------------------------------------

WF_TRAIN_VIDEOS = 256
WF_EVAL_VIDEOS = 128


class LogLines(logging.Handler):
    """The messages the port logs at INFO and above, kept in order."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def find(self, pattern):
        return [m for m in map(re.compile(pattern).search, self.messages)
                if m]


def eval_loss_card_vs_cpu(torch, dev, run, data) -> float:
    """Per-video loss of 8 eval videos from the restored checkpoint, on
    the card and on the CPU: the largest relative difference."""
    from yt8m_tpu_torch.config import EvalConfig
    from yt8m_tpu_torch.convert import load_model
    from yt8m_tpu_torch.data.readers import BatchIterator
    from yt8m_tpu_torch.train.loop import reader_config_from, to_device
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.step import make_eval_step
    from yt8m_tpu_torch.utils.flags import apply_recorded_model_flags

    cfg = EvalConfig(train_dir=run)
    apply_recorded_model_flags(cfg, [])
    batch = next(iter(BatchIterator(data, reader_config_from(cfg),
                                    batch_size=8)))
    losses = []
    for d in (dev, torch.device("cpu")):
        model = load_model(run, cfg.model, cfg.resolved_hparams(), d)
        _, per_ex = make_eval_step(model, get_loss(cfg.label_loss))(
            to_device(batch, d))
        losses.append(per_ex.double().cpu())
        del model
    gpu, cpu = losses
    err = ((gpu - cpu).abs() / cpu.abs().clamp_min(1e-6)).max().item()
    check(err <= 2e-3, f"eval loss card vs CPU: {err:.3e} relative")
    return err


def workflow_data(work) -> str:
    """Synthetic frame-level TFRecords for the workflows (lengths 30-300):
    WF_TRAIN_VIDEOS train and WF_EVAL_VIDEOS eval videos under `work`."""
    from yt8m_tpu_torch.data.synthetic import write_dataset

    data = os.path.join(work, "workflow_data")
    t0 = time.perf_counter()
    write_dataset(data, "train", num_shards=2,
                  videos_per_shard=WF_TRAIN_VIDEOS // 2, frame_level=True,
                  num_classes=CLASSES, seed=5, min_frames=30)
    write_dataset(data, "validate", num_shards=2,
                  videos_per_shard=WF_EVAL_VIDEOS // 2, frame_level=True,
                  num_classes=CLASSES, seed=6, min_frames=30)
    free = shutil.disk_usage(work).free / 2 ** 30
    say("workflow", f"wrote {WF_TRAIN_VIDEOS} train and {WF_EVAL_VIDEOS} "
                    f"eval videos in {time.perf_counter() - t0:.1f} s; "
                    f"{free:.1f} GiB free on the build disk")
    return data


def cli_workflow(torch, dev, work, data) -> dict:
    """train -> resume -> eval -> inference through the port's CLIs with
    the flagship at full width and --netvlad_fused_train, on the
    workflow's TFRecords under `data`; launch counts set to 0 before each
    CLI and read after it."""
    from yt8m_tpu_torch.cli import eval as eval_cli
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.train.checkpoint import dir_bytes, step_dirs

    run = os.path.join(work, "workflow_run")
    reader = ["--frame_features=true", "--feature_names=rgb,audio",
              "--feature_sizes=1024,128", f"--num_classes={CLASSES}",
              f"--device={dev.type}"]
    train = [
        f"--train_data_pattern={data}/train-*.tfrecord", f"--train_dir={run}",
        f"--batch_size={TRAIN_BATCH}", "--save_checkpoint_every_n_steps=2",
        "--max_checkpoints_to_keep=1", "--log_every_n_steps=1",
        "--model=NetVladLstmModel", f"--netvlad_cluster_size={VLAD_CLUSTERS}",
        f"--netvlad_hidden_size={VLAD_HIDDEN}", f"--lstm_cells={LSTM_CELLS}",
        f"--lstm_layers={LSTM_LAYERS}", f"--moe_num_mixtures={MIXTURES}",
        "--netvlad_fused_train", "--compute_dtype=bfloat16",
    ] + reader
    logs = LogLines()
    logger = logging.getLogger("yt8m_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(logs)
    launches = {}
    try:
        for steps in (2, 4):
            wrappers = zero_launches()
            t0 = time.perf_counter()
            last = one_card(train_cli)(train + [f"--max_steps={steps}"])
            launches[f"train to {steps}"] = read_launches(torch, wrappers)
            gc.collect()
            torch.cuda.empty_cache()
            say("workflow", f"cli.train --max_steps={steps}: at step {last} "
                            f"in {time.perf_counter() - t0:.1f} s; "
                            f"checkpoints {step_dirs(run)}")
            check(last == steps and step_dirs(run) == [steps],
                  f"cli.train --max_steps={steps}: step {last}, "
                  f"checkpoints {step_dirs(run)}")
            got = launches[f"train to {steps}"]
            for fn, want in (("netvlad_core_forward", 2),
                             ("netvlad_core_backward", 2),
                             ("lstm_train_forward", 2 * LSTM_LAYERS),
                             ("lstm_train_backward", 2 * LSTM_LAYERS)):
                check(got[fn] == want, f"cli.train to {steps}: {fn} "
                                       f"launched {got[fn]} times, want {want}")
        check([int(m.group(1)) for m in logs.find(
            r"restoring checkpoint at step (\d+)")] == [2],
            "the second cli.train did not resume at step 2")
        losses = [float(m.group(2)) for m in logs.find(
            r"training step (\d+) \| Loss: (\S+)")]
        check(len(losses) == 4 and all(map(math.isfinite, losses)),
              f"training log lines: {losses}")
        saves = [(float(m.group(2)), float(m.group(3))) for m in logs.find(
            r"saved checkpoint step (\d+) \(([\d.]+) GB\) in ([\d.]+) s")]
        restores = [float(m.group(1)) for m in logs.find(
            r"restored checkpoint step \d+ in ([\d.]+) s")]
        size = dir_bytes(os.path.join(run, "4")) / 1e9
        say("workflow", f"losses {losses}; checkpoint {size:.3f} GB on "
                        f"disk, saves {[t for _, t in saves]} s, restore "
                        f"{restores} s")

        wrappers = zero_launches()
        out_eval = one_card(eval_cli)([
            f"--eval_data_pattern={data}/validate-*.tfrecord",
            f"--train_dir={run}", "--run_once", f"--batch_size={E2E_BATCH}",
            f"--device={dev.type}"])
        launches["eval"] = read_launches(torch, wrappers)
        mean_ap = float(sum(out_eval["aps"]) / len(out_eval["aps"]))
        say("workflow", f"cli.eval: step {out_eval['step']}, GAP "
                        f"{out_eval['gap']:.5f}, Hit@1 "
                        f"{out_eval['avg_hit_at_one']:.5f}, PERR "
                        f"{out_eval['avg_perr']:.5f}, mAP {mean_ap:.5f}, "
                        f"loss {out_eval['avg_loss']:.5f}, "
                        f"{out_eval['videos_per_sec']:.1f} videos/s; launches "
                        f"{launches['eval']}")
        check(out_eval["step"] == 4 and out_eval["nonfinite_predictions"] == 0,
              "cli.eval: step or non-finite predictions")
        for key, value in (("GAP", out_eval["gap"]), ("mAP", mean_ap),
                           ("Hit@1", out_eval["avg_hit_at_one"])):
            check(math.isfinite(value) and 0.0 <= value <= 1.0,
                  f"cli.eval {key} = {value}")
        for fn in ("exact_topk", "netvlad_aggregate", "lstm_recurrence",
                   "moe_head_serving"):
            check(launches["eval"][fn] > 0, f"cli.eval did not launch {fn}")

        wrappers = zero_launches()
        out_csv = os.path.join(work, "workflow.csv")
        stats = one_card(inference_cli)([
            f"--input_data_pattern={data}/validate-*.tfrecord",
            f"--train_dir={run}", f"--output_file={out_csv}",
            f"--batch_size={E2E_BATCH}", f"--top_k={TOP_K}",
            f"--device={dev.type}"])
        launches["inference"] = read_launches(torch, wrappers)
        check(stats["nonfinite_predictions"] == 0
              and check_csv(out_csv) == WF_EVAL_VIDEOS,
              "cli.inference: CSV or non-finite predictions")
        say("workflow", f"cli.inference: {stats['num_videos']} videos, "
                        f"{stats['videos_per_sec']:.1f} videos/s, CSV ok; "
                        f"launches {launches['inference']}")
        err = eval_loss_card_vs_cpu(torch, dev, run,
                                    f"{data}/validate-*.tfrecord")
        say("workflow", f"8 eval videos from the step-4 checkpoint, card vs "
                        f"CPU: per-video loss within {err:.3e} relative "
                        f"(bound 2e-3)")
    finally:
        logger.removeHandler(logs)
        shutil.rmtree(run, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "checkpoint_gb": size,
            "save_s": [t for _, t in saves], "restore_s": restores}


ASYNC_STEPS = (3, 4)  # trained to 3, a checkpoint a step; resumed to 4


def async_workflow(torch, dev, work, data) -> dict:
    """--async_checkpoint against synchronous saves: DbofModel at the
    reference width (B=256) through cli.train, a checkpoint every step, to
    step 3, then resumed to step 4, once with each; the seconds each save
    held the training thread (the Trainer's log line): a mid-run async
    save holds it for the host copy, the run's last save until it is on
    disk, as in orbax."""
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.train.checkpoint import step_dirs

    out = {}
    logs = LogLines()
    logger = logging.getLogger("yt8m_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(logs)
    try:
        for mode in ("sync", "async"):
            run = os.path.join(work, f"{mode}_run")
            train = [
                f"--train_data_pattern={data}/train-*.tfrecord",
                f"--train_dir={run}", f"--batch_size={TRAIN_BATCH}",
                "--save_checkpoint_every_n_steps=1",
                "--max_checkpoints_to_keep=1", "--log_every_n_steps=1",
                *DBOF_FLAGS, "--compute_dtype=bfloat16",
                "--frame_features=true", "--feature_names=rgb,audio",
                "--feature_sizes=1024,128", f"--num_classes={CLASSES}",
                f"--device={dev.type}"]
            if mode == "async":
                train.append("--async_checkpoint")
            logs.messages.clear()
            for steps in ASYNC_STEPS:
                last = one_card(train_cli)(train + [f"--max_steps={steps}"])
                check(last == steps and step_dirs(run) == [steps]
                      and not [n for n in os.listdir(run)
                               if n.startswith(".")],
                      f"cli.train {mode} --max_steps={steps}: step {last}, "
                      f"{sorted(os.listdir(run))}")
            check([int(m.group(1)) for m in logs.find(
                r"restoring checkpoint at step (\d+)")] == [ASYNC_STEPS[0]],
                f"cli.train {mode} did not resume at step {ASYNC_STEPS[0]}")
            losses = [float(m.group(2)) for m in logs.find(
                r"training step (\d+) \| Loss: (\S+)")]
            check(len(losses) == ASYNC_STEPS[-1]
                  and all(map(math.isfinite, losses)),
                  f"cli.train {mode} log lines: {losses}")
            held = [[float(t) for t in m.group(1).split(", ")]
                    for m in logs.find(r"\(([\d., ]+) s a save\)")]
            writes = [float(m.group(1)) for m in logs.find(
                r"saved checkpoint step \d+ \([\d.]+ GB\) in ([\d.]+) s")]
            out[mode] = {"held_s": held, "write_s": writes, "losses": losses}
            shutil.rmtree(run, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        logger.removeHandler(logs)
    # Each run's saves but its last (force_save's, durable before return).
    mid = {mode: [t for run in r["held_s"] for t in run[:-1]]
           for mode, r in out.items()}
    say("workflow", f"DbofModel cli.train to {ASYNC_STEPS[0]}, resumed to "
                    f"{ASYNC_STEPS[1]}, a checkpoint a step: the saves held "
                    f"the training thread {out['async']['held_s']} s with "
                    f"--async_checkpoint (the writer took "
                    f"{out['async']['write_s']} s on its thread), "
                    f"{out['sync']['held_s']} s synchronously; mid-run saves "
                    f"median {statistics.median(mid['async']):.3f} s against "
                    f"{statistics.median(mid['sync']):.3f} s; losses "
                    f"{out['async']['losses']} and {out['sync']['losses']}")
    out["mid_run_median_s"] = {k: statistics.median(v) for k, v in mid.items()}
    return out


def default_workflow(torch, dev, work) -> dict:
    """The starter workflow with the CLIs' defaults: cli.train with no
    --model and no --frame_features (LogisticModel over mean_rgb, 4716
    classes, batch 1024, 5 epochs, the card) on video-level records, then
    cli.eval (--run_once is the default) and cli.inference; launch counts
    set to 0 before each CLI and read after it. LogisticModel launches no
    kernel but top-k (exact_topk: eval's sorted_topk, inference's
    serving_topk)."""
    from yt8m_tpu_torch.cli import eval as eval_cli
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.data.synthetic import write_dataset

    data = os.path.join(work, "video_level")
    write_dataset(data, "train", num_shards=2,
                  videos_per_shard=WF_TRAIN_VIDEOS // 2, seed=7)
    write_dataset(data, "validate", num_shards=2,
                  videos_per_shard=WF_EVAL_VIDEOS // 2, seed=8)
    run = os.path.join(work, "default_run")
    launches, seconds = {}, {}
    try:
        wrappers = zero_launches()
        t0 = time.perf_counter()
        last = one_card(train_cli)([
            f"--train_data_pattern={data}/train-*.tfrecord",
            f"--train_dir={run}"])
        seconds["train"] = time.perf_counter() - t0
        launches["train"] = read_launches(torch, wrappers)
        with open(os.path.join(run, "model_flags.json")) as f:
            recorded = json.load(f)
        say("workflow", f"default cli.train: {recorded['model']} at step "
                        f"{last} in {seconds['train']:.1f} s (frame_features "
                        f"{recorded['frame_features']}, "
                        f"{recorded['feature_names']}, batch 1024)")
        check(recorded["model"] == "LogisticModel"
              and recorded["frame_features"] is False and last >= 1,
              f"default cli.train: {recorded['model']} at step {last}")

        wrappers = zero_launches()
        t0 = time.perf_counter()
        out_eval = one_card(eval_cli)([
            f"--eval_data_pattern={data}/validate-*.tfrecord",
            f"--train_dir={run}"])
        seconds["eval"] = time.perf_counter() - t0
        launches["eval"] = read_launches(torch, wrappers)
        mean_ap = float(sum(out_eval["aps"]) / len(out_eval["aps"]))
        say("workflow", f"default cli.eval: step {out_eval['step']}, GAP "
                        f"{out_eval['gap']:.5f}, Hit@1 "
                        f"{out_eval['avg_hit_at_one']:.5f}, mAP "
                        f"{mean_ap:.5f}, {out_eval['videos_per_sec']:.1f} "
                        f"videos/s in {seconds['eval']:.1f} s")
        check(out_eval["step"] == last
              and out_eval["nonfinite_predictions"] == 0,
              "default cli.eval: step or non-finite predictions")
        for key, value in (("GAP", out_eval["gap"]), ("mAP", mean_ap),
                           ("Hit@1", out_eval["avg_hit_at_one"])):
            check(math.isfinite(value) and 0.0 <= value <= 1.0,
                  f"default cli.eval {key} = {value}")

        wrappers = zero_launches()
        out_csv = os.path.join(work, "default.csv")
        t0 = time.perf_counter()
        stats = one_card(inference_cli)([
            f"--input_data_pattern={data}/validate-*.tfrecord",
            f"--train_dir={run}", f"--output_file={out_csv}"])
        seconds["inference"] = time.perf_counter() - t0
        launches["inference"] = read_launches(torch, wrappers)
        check(stats["nonfinite_predictions"] == 0
              and check_csv(out_csv) == WF_EVAL_VIDEOS,
              "default cli.inference: CSV or non-finite predictions")
        for cli in ("eval", "inference"):
            check(launches[cli]["exact_topk"] > 0,
                  f"default cli.{cli} did not launch exact_topk")
        say("workflow", f"default cli.inference: {stats['num_videos']} "
                        f"videos, {stats['videos_per_sec']:.1f} videos/s in "
                        f"{seconds['inference']:.1f} s, CSV ok; launches "
                        f"{ {k: v for k, v in launches['inference'].items() if v} }")
    finally:
        shutil.rmtree(run, ignore_errors=True)
    return {"launches": launches, "seconds": seconds}


def short_workflow(torch, dev, work, data, model, flags, train_want,
                   serve, serve_flags=(), serve_absent=()) -> dict:
    """train -> eval -> inference through the port's CLIs with `model` at
    full width (2 steps at B=256, a checkpoint at step 2) on the
    workflow's TFRecords under `data`: `train_want` maps each training
    kernel to its launches in the 2 steps, `serve` names the kernels eval
    and inference (run with `serve_flags`) must launch and `serve_absent`
    those they must not; launch counts set to 0 before each CLI and read
    after it."""
    from yt8m_tpu_torch.cli import eval as eval_cli
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.train.checkpoint import dir_bytes, step_dirs

    run = os.path.join(work, f"{model}_run")
    reader = ["--frame_features=true", "--feature_names=rgb,audio",
              "--feature_sizes=1024,128", f"--num_classes={CLASSES}",
              f"--device={dev.type}"]
    launches = {}
    try:
        wrappers = zero_launches()
        t0 = time.perf_counter()
        last = one_card(train_cli)([
            f"--train_data_pattern={data}/train-*.tfrecord",
            f"--train_dir={run}", f"--batch_size={TRAIN_BATCH}",
            "--max_steps=2", "--save_checkpoint_every_n_steps=2",
            "--max_checkpoints_to_keep=1", "--log_every_n_steps=1",
            f"--model={model}", f"--moe_num_mixtures={MIXTURES}",
            "--compute_dtype=bfloat16"] + flags + reader)
        launches["train"] = read_launches(torch, wrappers)
        train_s = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        size = dir_bytes(os.path.join(run, "2")) / 1e9
        say("workflow", f"{model} cli.train --max_steps=2: at step {last} in "
                        f"{train_s:.1f} s; checkpoint {size:.3f} GB; "
                        f"launches {launches['train']}")
        check(last == 2 and step_dirs(run) == [2],
              f"{model} cli.train: step {last}, checkpoints "
              f"{step_dirs(run)}")
        for fn, want in train_want.items():
            check(launches["train"][fn] == want,
                  f"{model} cli.train: {fn} launched "
                  f"{launches['train'][fn]} times, want {want}")

        wrappers = zero_launches()
        out_eval = one_card(eval_cli)([
            f"--eval_data_pattern={data}/validate-*.tfrecord",
            f"--train_dir={run}", "--run_once", f"--batch_size={E2E_BATCH}",
            f"--device={dev.type}", *serve_flags])
        launches["eval"] = read_launches(torch, wrappers)
        mean_ap = float(sum(out_eval["aps"]) / len(out_eval["aps"]))
        say("workflow", f"{model} cli.eval: step {out_eval['step']}, GAP "
                        f"{out_eval['gap']:.5f}, Hit@1 "
                        f"{out_eval['avg_hit_at_one']:.5f}, mAP "
                        f"{mean_ap:.5f}, {out_eval['videos_per_sec']:.1f} "
                        f"videos/s; launches {launches['eval']}")
        check(out_eval["step"] == 2 and out_eval["nonfinite_predictions"] == 0,
              f"{model} cli.eval: step or non-finite predictions")
        for key, value in (("GAP", out_eval["gap"]), ("mAP", mean_ap),
                           ("Hit@1", out_eval["avg_hit_at_one"])):
            check(math.isfinite(value) and 0.0 <= value <= 1.0,
                  f"{model} cli.eval {key} = {value}")

        wrappers = zero_launches()
        out_csv = os.path.join(work, f"{model}_workflow.csv")
        stats = one_card(inference_cli)([
            f"--input_data_pattern={data}/validate-*.tfrecord",
            f"--train_dir={run}", f"--output_file={out_csv}",
            f"--batch_size={E2E_BATCH}", f"--top_k={TOP_K}",
            f"--device={dev.type}", *serve_flags])
        launches["inference"] = read_launches(torch, wrappers)
        check(stats["nonfinite_predictions"] == 0
              and check_csv(out_csv) == WF_EVAL_VIDEOS,
              f"{model} cli.inference: CSV or non-finite predictions")
        for fn in serve:
            check(launches["eval"][fn] > 0 and launches["inference"][fn] > 0,
                  f"{model} cli.eval or cli.inference did not launch {fn}")
        for fn in serve_absent:
            check(launches["eval"][fn] == 0
                  and launches["inference"][fn] == 0,
                  f"{model} cli.eval or cli.inference launched {fn}")
        say("workflow", f"{model} cli.inference: {stats['num_videos']} "
                        f"videos, {stats['videos_per_sec']:.1f} videos/s, CSV"
                        f" ok; launches {launches['inference']}")
    finally:
        shutil.rmtree(run, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "train_s": train_s, "checkpoint_gb": size}


def optimizer_workflow(torch, dev, work, data) -> dict:
    """cli.train with --optimizer=AdafactorOptimizer
    --compute_dtype=float32 (DbofModel at the reference width, B=256) to
    step 2, then again to step 4, resumed at step 2: the optimizer's
    factored state round-trips (the step-4 checkpoint's state counts 4
    steps a parameter and holds the factored moments); then
    cli.inference serves the run at --compute_dtype=float32 (a serving
    knob, not taken from the recorded flags, as in the JAX package) on
    the f32 routes."""
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.train.checkpoint import OPTIMIZER_FILE, step_dirs

    run = os.path.join(work, "adafactor_f32_run")
    reader = ["--frame_features=true", "--feature_names=rgb,audio",
              "--feature_sizes=1024,128", f"--num_classes={CLASSES}",
              f"--device={dev.type}"]
    train = [f"--train_data_pattern={data}/train-*.tfrecord",
             f"--train_dir={run}", f"--batch_size={TRAIN_BATCH}",
             "--save_checkpoint_every_n_steps=2",
             "--max_checkpoints_to_keep=1", "--log_every_n_steps=1",
             "--optimizer=AdafactorOptimizer", F32, *DBOF_FLAGS] + reader
    logs = LogLines()
    logger = logging.getLogger("yt8m_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(logs)
    try:
        t0 = time.perf_counter()
        for steps in (2, 4):
            last = one_card(train_cli)(train + [f"--max_steps={steps}"])
            check(last == steps and step_dirs(run) == [steps],
                  f"Adafactor f32 cli.train --max_steps={steps}: step "
                  f"{last}, checkpoints {step_dirs(run)}")
        train_s = time.perf_counter() - t0
        check([int(m.group(1)) for m in logs.find(
            r"restoring checkpoint at step (\d+)")] == [2],
            "Adafactor f32: the second cli.train did not resume at step 2")
        losses = [float(m.group(2)) for m in logs.find(
            r"training step (\d+) \| Loss: (\S+)")]
        check(len(losses) == 4 and all(map(math.isfinite, losses)),
              f"Adafactor f32 training log lines: {losses}")
        saved = torch.load(os.path.join(run, "4", OPTIMIZER_FILE),
                           map_location="cpu", weights_only=False)["state"]
        steps_seen = {int(st["step"]) for st in saved.values()}
        factored = sum("v_row" in st for st in saved.values())
        check(steps_seen == {4} and factored > 0,
              f"Adafactor f32: the step-4 optimizer state counts steps "
              f"{steps_seen}, {factored} factored moments")
        gc.collect()
        torch.cuda.empty_cache()
        wrappers = zero_launches()
        out_csv = os.path.join(work, "adafactor_f32.csv")
        stats = one_card(inference_cli)([
            f"--input_data_pattern={data}/validate-*.tfrecord",
            f"--train_dir={run}", f"--output_file={out_csv}",
            f"--batch_size={E2E_BATCH}", f"--top_k={TOP_K}",
            f"--device={dev.type}", F32])
        launches = read_launches(torch, wrappers)
        check(stats["nonfinite_predictions"] == 0
              and check_csv(out_csv) == WF_EVAL_VIDEOS,
              "Adafactor f32 cli.inference: CSV or non-finite predictions")
        for name in ("dbof_cluster_maxpool_v2", "moe_head_serving"):
            check(launches[name] > 0
                  and launches[f"{name}:f32"] == launches[name],
                  f"Adafactor f32 cli.inference: {name} launches "
                  f"{launches[name]}, f32 route {launches[f'{name}:f32']}")
        say("workflow", f"DbofModel {F32} --optimizer=AdafactorOptimizer: "
                        f"cli.train to 2, resumed to 4 in {train_s:.1f} s, "
                        f"losses {losses}; the step-4 optimizer state: "
                        f"{len(saved)} parameters at step 4, {factored} "
                        f"factored; cli.inference {stats['num_videos']} "
                        f"videos, {stats['videos_per_sec']:.1f} videos/s "
                        f"on the f32 routes")
    finally:
        logger.removeHandler(logs)
        shutil.rmtree(run, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": {"inference": launches}, "losses": losses}


# ---------------------------------------------------------------------------
# phase 8: the readers, and the ensemble -> distillation -> boosting
# workflow through the CLIs
# ---------------------------------------------------------------------------

READER_SHARDS = 8
READER_VIDEOS = 384
READERS = 4  # --num_readers of the fan-out readers
# The ensemble: DbofModel first, the flagship second; launches a batch of
# each kernel when it serves (the MoE head once a member, the LSTM once a
# layer).
ENSEMBLE_PER_BATCH = {"dbof_cluster_maxpool_v2": 1, "moe_head_serving": 2,
                      "netvlad_aggregate": 1, "lstm_recurrence": 2,
                      "exact_topk": 1}
ENSEMBLE_WEIGHTS = (1.0, 2.0)
MEMBER_STEPS = 2
# The members' widths (the JAX defaults, and DbofModel's reference width).
DBOF_FLAGS = ("--model=DbofModel", f"--dbof_cluster_size={CLUSTERS}",
              f"--dbof_hidden_size={HIDDEN}", f"--iterations={FRAMES}",
              f"--moe_num_mixtures={MIXTURES}")
FLAGSHIP_FLAGS = ("--model=NetVladLstmModel",
                  f"--netvlad_cluster_size={VLAD_CLUSTERS}",
                  f"--netvlad_hidden_size={VLAD_HIDDEN}",
                  f"--lstm_cells={LSTM_CELLS}", f"--lstm_layers={LSTM_LAYERS}",
                  f"--moe_num_mixtures={MIXTURES}")
STUDENT_STEPS = 4
STUDENT_BATCH = 64


def reader_phase(torch, dev, work) -> dict:
    """Frame-level videos/s of the Python reader, the native one, the
    threaded fan-out and the process fan-out over READER_VIDEOS videos in
    READER_SHARDS shards (30-300 frames, batch E2E_BATCH, every video once
    asserted, the reader that ran asserted); then DbofModel at the
    reference width through cli.inference at batch E2E_BATCH over the same
    records with the Python reader and with the native one."""
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.convert import save_checkpoint
    from yt8m_tpu_torch.data import pipeline
    from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
    from yt8m_tpu_torch.data.synthetic import write_dataset

    data = os.path.join(work, "reader_data")
    write_dataset(data, "test", num_shards=READER_SHARDS,
                  videos_per_shard=READER_VIDEOS // READER_SHARDS,
                  frame_level=True, num_classes=CLASSES, seed=9,
                  min_frames=30)
    pattern = f"{data}/test-*.tfrecord"
    rc = ReaderConfig("rgb,audio", "1024,128", frame_features=True,
                      num_classes=CLASSES)
    makers = {
        "python": lambda: BatchIterator(pattern, rc, E2E_BATCH),
        "native": lambda: pipeline.make_batch_iterator(pattern, rc,
                                                       E2E_BATCH),
        "threaded": lambda: pipeline.make_batch_iterator(
            pattern, rc, E2E_BATCH, num_readers=READERS),
        "processes": lambda: pipeline.make_batch_iterator(
            pattern, rc, E2E_BATCH, num_readers=READERS,
            reader_processes=True),
    }
    rates, first = {}, {}
    for kind, make in makers.items():
        t0 = time.perf_counter()
        it = make()
        check(pipeline.reader_kind(it) == kind,
              f"reader {kind}: got {pipeline.reader_kind(it)}")
        ids = []
        for b in it:
            if not ids:
                first[kind] = time.perf_counter() - t0
                t1 = time.perf_counter()
            ids += [v for v, m in zip(b["id"], b["batch_mask"]) if m]
        rates[kind] = (len(ids) / (time.perf_counter() - t0),
                       (len(ids) - E2E_BATCH) / (time.perf_counter() - t1))
        check(len(ids) == READER_VIDEOS == len(set(ids)),
              f"reader {kind}: {len(ids)} videos, {len(set(ids))} distinct")
    say("reader", "frame-level videos/s (batch "
                  f"{E2E_BATCH}, {READER_VIDEOS} videos in {READER_SHARDS} "
                  f"shards, {READERS} readers for the fan-outs; all in, "
                  "then after the first batch, and the first batch's "
                  "seconds): " + ", ".join(
                      f"{k} {v[0]:.1f}, {v[1]:.1f} ({first[k]:.2f} s)"
                      for k, v in rates.items()))
    hp, model = make_model(torch, seed=0)
    run = os.path.join(work, "reader_run")
    save_checkpoint(run, model, "DbofModel", hp, frame_features=True,
                    feature_names="rgb,audio", feature_sizes="1024,128",
                    num_classes=CLASSES, max_frames=300,
                    label_loss="CrossEntropyLoss")
    del model
    cli = {}
    real = pipeline.get_native_lib
    for kind in ("python", "native"):
        if kind == "python":  # the fallback, as where g++ is missing
            pipeline.get_native_lib = lambda: None
        try:
            stats = one_card(inference_cli)([
                f"--input_data_pattern={pattern}", f"--train_dir={run}",
                f"--output_file={work}/reader_{kind}.csv",
                f"--batch_size={E2E_BATCH}", f"--device={dev.type}"])
        finally:
            pipeline.get_native_lib = real
        check(stats["reader"] == kind and stats["num_videos"] == READER_VIDEOS
              and stats["nonfinite_predictions"] == 0,
              f"DbofModel cli.inference with the {kind} reader: {stats}")
        check(check_csv(f"{work}/reader_{kind}.csv") == READER_VIDEOS,
              "reader CSV")
        cli[kind] = stats["videos_per_sec"]
    say("reader", f"DbofModel cli.inference (batch {E2E_BATCH}, reference "
                  f"width): {cli['python']:.1f} videos/s with the Python "
                  f"reader, {cli['native']:.1f} with the native one")
    shutil.rmtree(run, ignore_errors=True)
    shutil.rmtree(data, ignore_errors=True)
    return {"videos_per_sec": rates, "cli_videos_per_sec": cli}


def losses_since(logs, n: int) -> list:
    """The training losses logged after the first `n` messages."""
    pattern = re.compile(r"training step (\d+) \| Loss: (\S+)")
    return [float(m.group(2)) for m in map(pattern.search, logs.messages[n:])
            if m]


def ensemble_step_ms(torch, dev, runs) -> dict:
    """The ensemble's serving step against its members' steps on the same
    frames on the card (B=FLAG_BATCH, host clock around a synchronised
    step, median of 5, members in turn with the ensemble)."""
    from yt8m_tpu_torch.config import InferenceConfig
    from yt8m_tpu_torch.infer.ensemble_serve import build_ensemble
    from yt8m_tpu_torch.infer.predict import make_topk_predict_step

    cfg = InferenceConfig(frame_features=True, feature_names="rgb,audio",
                          feature_sizes="1024,128", num_classes=CLASSES,
                          ensemble_train_dirs=",".join(runs),
                          ensemble_weights=",".join(map(str,
                                                        ENSEMBLE_WEIGHTS)))
    ens = build_ensemble(cfg, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randint(0, 256, (FLAG_BATCH, 300, FEATURE_DIM), device=dev,
                          dtype=torch.uint8, generator=g)
    nf = torch.randint(FRAMES, 301, (FLAG_BATCH,), device=dev,
                       dtype=torch.int32, generator=g)
    steps = {"DbofModel": make_topk_predict_step(ens.members[0], TOP_K),
             "NetVladLstmModel": make_topk_predict_step(ens.members[1],
                                                        TOP_K),
             "ensemble": make_topk_predict_step(ens, TOP_K)}
    times = {k: [] for k in steps}
    for _ in range(2):  # warm-up
        for step in steps.values():
            step(feats, nf)
    torch.cuda.synchronize()
    for _ in range(5):
        for k, step in steps.items():
            t0 = time.perf_counter()
            step(feats, nf)
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t0) * 1e3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    total = ms["DbofModel"] + ms["NetVladLstmModel"]
    say("ensemble", f"serving step B={FLAG_BATCH} (median of 5): DbofModel "
                    f"{ms['DbofModel']:.3f} ms, NetVladLstmModel "
                    f"{ms['NetVladLstmModel']:.3f} ms, sum {total:.3f}; the "
                    f"ensemble {ms['ensemble']:.3f} ms "
                    f"({ms['ensemble'] / total:.3f} of the sum)")
    del ens, feats
    torch.cuda.empty_cache()
    return {**ms, "ratio": ms["ensemble"] / total}


def ensemble_workflow(torch, dev, work, data) -> dict:
    """read -> dump -> ensemble -> distill / boost -> serve through the
    port's CLIs on the workflow's records under `data`, with the launch
    counts set to 0 before each CLI and read after it:
    (i) cli.train of two members, DbofModel at the reference width and
    the flagship at the JAX defaults (MEMBER_STEPS steps at batch
    E2E_BATCH, a checkpoint a step); (ii) their dense probability dumps
    on the train split through cli.inference, and DbofModel's sparse
    top-64; (iii) cli.ensemble --fit_weights to a CSV; (iv) the ensemble
    served on the card through cli.inference --ensemble_train_dirs with
    the launches a batch of ENSEMBLE_PER_BATCH, its dense dump against
    the host average of the members' dumps, 8 videos against the same
    ensemble on the CPU, its step against its members' steps; (v) the
    distill records from the ensemble's dump (top 64 kept) and a flagship
    student with --netvlad_fused_train and MixedCrossEntropyDistillLoss;
    (vi) boost weights from DbofModel's dump (ensemble.boosting) and
    DbofModel trained with them; (vii) the mean of DbofModel's last two
    checkpoints served."""
    import numpy as np

    from yt8m_tpu_torch.cli import ensemble as ensemble_cli
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.config import InferenceConfig
    from yt8m_tpu_torch.ensemble import average, boosting, distill
    from yt8m_tpu_torch.ensemble.checkpoints import (
        average_checkpoint_weights,
    )
    from yt8m_tpu_torch.infer.ensemble_serve import build_ensemble
    from yt8m_tpu_torch.infer.predict import inference
    from yt8m_tpu_torch.models import ModelHParams, get_model
    from yt8m_tpu_torch.train.checkpoint import step_dirs

    reader = ["--frame_features=true", "--feature_names=rgb,audio",
              "--feature_sizes=1024,128", f"--num_classes={CLASSES}"]
    on_dev = [f"--device={dev.type}"]
    # flags, and the checkpoints each member keeps: DbofModel's two serve
    # averaged in (vii); the flagship's (~4.5 GB with Adam) is written once.
    members = {"DbofModel": (["--save_checkpoint_every_n_steps=1",
                              *DBOF_FLAGS],
                             list(range(1, MEMBER_STEPS + 1))),
               "NetVladLstmModel": (["--save_checkpoint_every_n_steps="
                                     f"{MEMBER_STEPS}", *FLAGSHIP_FLAGS],
                                    [MEMBER_STEPS])}
    runs = {m: os.path.join(work, f"member_{m}") for m in members}
    logs = LogLines()
    logger = logging.getLogger("yt8m_tpu_torch")
    logger.setLevel(logging.INFO)
    logger.addHandler(logs)
    launches, seconds = {}, {}

    def cli_run(name, fn, argv):
        wrappers = zero_launches()
        t0 = time.perf_counter()
        out = fn(argv)
        seconds[name] = time.perf_counter() - t0
        launches[name] = read_launches(torch, wrappers)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    try:
        # (i) two members
        for m, (flags, kept) in members.items():
            n = len(logs.messages)
            last = cli_run(f"train {m}", one_card(train_cli), [
                f"--train_data_pattern={data}/train-*.tfrecord",
                f"--train_dir={runs[m]}", f"--batch_size={E2E_BATCH}",
                f"--max_steps={MEMBER_STEPS}", "--log_every_n_steps=1",
                *flags, *reader, *on_dev])
            losses = losses_since(logs, n)
            check(last == MEMBER_STEPS and step_dirs(runs[m]) == kept
                  and len(losses) == MEMBER_STEPS
                  and all(map(math.isfinite, losses)),
                  f"member {m}: step {last}, {step_dirs(runs[m])}, {losses}")
            say("ensemble", f"member {m} cli.train: {MEMBER_STEPS} steps at "
                            f"batch {E2E_BATCH} in "
                            f"{seconds[f'train {m}']:.1f} s, losses {losses}")
        check(launches["train NetVladLstmModel"]["lstm_train_forward"]
              == MEMBER_STEPS * LSTM_LAYERS, "flagship member: LSTM launches")
        # (ii) dumps on the train split
        dumps = {m: os.path.join(work, f"dump_{m}") for m in members}
        for m in members:
            stats = cli_run(f"dump {m}", one_card(inference_cli), [
                f"--input_data_pattern={data}/train-*.tfrecord",
                f"--train_dir={runs[m]}", f"--output_probabilities_dir="
                f"{dumps[m]}", "--output_file=", f"--batch_size={E2E_BATCH}",
                *on_dev])
            check(stats["num_videos"] == WF_TRAIN_VIDEOS
                  and stats["nonfinite_predictions"] == 0
                  and stats["reader"] == "native",
                  f"dump of {m}: {stats}")
        sparse = os.path.join(work, "dump_sparse")
        cli_run("sparse dump", one_card(inference_cli), [
            f"--input_data_pattern={data}/train-*.tfrecord",
            f"--train_dir={runs['DbofModel']}",
            f"--output_probabilities_dir={sparse}", "--output_file=",
            "--output_probabilities_topk=64", f"--batch_size={E2E_BATCH}",
            *on_dev])
        batches = -(-WF_TRAIN_VIDEOS // E2E_BATCH)
        check(launches["sparse dump"]["exact_topk"] == batches
              and launches["dump DbofModel"]["exact_topk"] == 0,
              "dumps: top-k launches")
        ids, dense = average.load_prediction_dir(dumps["DbofModel"])
        sids, sdense = average.load_prediction_dir(sparse)
        # The sparse dump keeps each video's 64 largest of the dense
        # dump's values (the same model, batches and frame draws).
        top = np.sort(dense, axis=1)[:, -64:]
        check(sids == ids and np.array_equal(
            np.sort(sdense, axis=1)[:, -64:], top),
            "sparse dump: not the top 64 of the dense dump")
        say("ensemble", f"dumps: {len(ids)} videos a member, dense "
                        f"{dense.shape}, sparse top-64; seconds "
                        f"{[round(seconds[k], 1) for k in seconds if 'dump' in k]}")
        # (iii) the host ensemble of the dumps
        out_csv = os.path.join(work, "ensemble.csv")
        res = cli_run("cli.ensemble", ensemble_cli.main, [
            f"--member_dirs={dumps['DbofModel']},{dumps['NetVladLstmModel']}",
            "--fit_weights", f"--eval_labels_pattern={data}/train-*.tfrecord",
            "--frame_features", f"--num_classes={CLASSES}",
            f"--output_file={out_csv}"])
        check(check_csv(out_csv) == WF_TRAIN_VIDEOS
              and 0.0 <= res["gap"] <= 1.0, "cli.ensemble CSV or GAP")
        say("ensemble", f"cli.ensemble --fit_weights: weights "
                        f"{res['weights']}, GAP {res['gap']:.5f}, CSV ok in "
                        f"{seconds['cli.ensemble']:.1f} s")
        # (iv) the ensemble served on the card
        ens_flags = [f"--ensemble_train_dirs={runs['DbofModel']},"
                     f"{runs['NetVladLstmModel']}",
                     "--ensemble_weights=" + ",".join(map(str,
                                                          ENSEMBLE_WEIGHTS))]
        ens_dump = os.path.join(work, "dump_ensemble")
        ens_csv = os.path.join(work, "ensemble_served.csv")
        stats = cli_run("serve ensemble", one_card(inference_cli), [
            f"--input_data_pattern={data}/train-*.tfrecord",
            f"--output_probabilities_dir={ens_dump}",
            f"--output_file={ens_csv}", f"--batch_size={E2E_BATCH}",
            *ens_flags, *reader, *on_dev])
        got = launches["serve ensemble"]
        for fn, per in ENSEMBLE_PER_BATCH.items():
            check(got[fn] == per * batches,
                  f"ensemble: {got[fn]} {fn} launches in {batches} batches, "
                  f"want {per} a batch")
        check(stats["nonfinite_predictions"] == 0
              and check_csv(ens_csv) == WF_TRAIN_VIDEOS,
              "served ensemble: CSV or non-finite predictions")
        eids, ens = average.load_prediction_dir(ens_dump)
        _, aligned = average.align_members(
            [(eids, ens)] + [average.load_prediction_dir(dumps[m])
                             for m in members])
        host = average.weighted_average(aligned[1:], ENSEMBLE_WEIGHTS)
        dump_err = float(abs(ens - host).max())
        scale = float(abs(host).max())
        check(dump_err <= 1e-5 * scale,
              f"served ensemble vs the host average of the member dumps: "
              f"max|diff| {dump_err:.3e} > 1e-5 * {scale:.3e}")
        say("ensemble", f"served on the card: {stats['num_videos']} videos, "
                        f"{stats['videos_per_sec']:.1f} videos/s, launches a "
                        f"batch { {k: got[k] // batches for k in ENSEMBLE_PER_BATCH} }; "
                        f"dump vs the host average of the members' dumps: "
                        f"max|diff| {dump_err:.3e} (bound 1e-5 * {scale:.3e})")
        cfg = InferenceConfig(frame_features=True, feature_names="rgb,audio",
                              feature_sizes="1024,128", num_classes=CLASSES,
                              ensemble_train_dirs=ens_flags[0].split("=")[1],
                              ensemble_weights=ens_flags[1].split("=")[1])
        cpu_ens = build_ensemble(cfg, torch.device("cpu"))
        gpu_ens = build_ensemble(cfg, dev)
        err = compare_with_cpu(torch, gpu_ens,
                               lambda torch, seed: (None, cpu_ens),
                               f"{data}/validate-*.tfrecord", dev)
        del cpu_ens, gpu_ens
        gc.collect()
        torch.cuda.empty_cache()
        say("ensemble", f"8 videos card vs CPU: max|diff| {err:.3e} <= 2e-3")
        step = ensemble_step_ms(torch, dev, [runs[m] for m in members])
        # (v) distillation from the ensemble's dump
        teacher = distill.teacher_from_prediction_dir(ens_dump)
        records = os.path.join(work, "distill_data")
        n = distill.write_distill_dataset(f"{data}/train-*.tfrecord", teacher,
                                          records, frame_level=True,
                                          top_k_sparsify=64)
        check(n == WF_TRAIN_VIDEOS, f"distill records: {n} annotated")
        n = len(logs.messages)
        student = os.path.join(work, "student")
        cli_run("train student", one_card(train_cli), [
            f"--train_data_pattern={records}/train-*.tfrecord",
            f"--train_dir={student}", f"--batch_size={STUDENT_BATCH}",
            f"--max_steps={STUDENT_STEPS}", "--log_every_n_steps=1",
            f"--save_checkpoint_every_n_steps={STUDENT_STEPS}",
            *FLAGSHIP_FLAGS, "--netvlad_fused_train",
            "--distill_data_pattern=teacher",
            "--label_loss=MixedCrossEntropyDistillLoss", *reader, *on_dev])
        losses = losses_since(logs, n)
        got = launches["train student"]
        check(len(losses) == STUDENT_STEPS and all(map(math.isfinite, losses))
              and losses[-1] < losses[0],
              f"distilled student: losses {losses}")
        for fn, want in (("netvlad_core_forward", STUDENT_STEPS),
                         ("netvlad_core_backward", STUDENT_STEPS),
                         ("lstm_train_forward", STUDENT_STEPS * LSTM_LAYERS),
                         ("lstm_train_backward",
                          STUDENT_STEPS * LSTM_LAYERS)):
            check(got[fn] == want, f"student: {fn} launched {got[fn]} "
                                   f"times, want {want}")
        say("ensemble", f"distilled flagship student (--netvlad_fused_train, "
                        f"MixedCrossEntropyDistillLoss, batch "
                        f"{STUDENT_BATCH}): losses {losses} in "
                        f"{seconds['train student']:.1f} s")
        shutil.rmtree(student, ignore_errors=True)
        shutil.rmtree(records, ignore_errors=True)
        # (vi) boosting from DbofModel's train dump
        weights = os.path.join(work, "boost_weights.npz")
        boosting.main([f"--predictions_dir={dumps['DbofModel']}",
                       f"--train_data_pattern={data}/train-*.tfrecord",
                       f"--output={weights}", f"--num_classes={CLASSES}"])
        check(len(boosting.load_boost_weights(weights)) == WF_TRAIN_VIDEOS,
              "boost weights")
        n = len(logs.messages)
        cli_run("train boosted", one_card(train_cli), [
            f"--train_data_pattern={data}/train-*.tfrecord",
            f"--train_dir={work}/boosted", f"--batch_size={STUDENT_BATCH}",
            f"--max_steps={STUDENT_STEPS}", "--log_every_n_steps=1",
            f"--save_checkpoint_every_n_steps={STUDENT_STEPS}",
            *DBOF_FLAGS, f"--boost_weights_file={weights}",
            *reader, *on_dev])
        losses = losses_since(logs, n)
        check(len(losses) == STUDENT_STEPS and all(map(math.isfinite, losses))
              and losses[-1] < losses[0], f"boosted DbofModel: {losses}")
        say("ensemble", f"boosted DbofModel (--boost_weights_file): losses "
                        f"{losses}")
        shutil.rmtree(f"{work}/boosted", ignore_errors=True)
        # (vii) the mean of DbofModel's last two checkpoints, served
        hp = ModelHParams(vocab_size=CLASSES, feature_dim=FEATURE_DIM,
                          max_frames=300, dbof_cluster_size=CLUSTERS,
                          dbof_hidden_size=HIDDEN, iterations=FRAMES,
                          moe_num_mixtures=MIXTURES)
        model = average_checkpoint_weights(runs["DbofModel"],
                                           get_model("DbofModel", hp),
                                           last_n=2)
        avg_csv = os.path.join(work, "averaged.csv")
        wrappers = zero_launches()
        stats = inference(InferenceConfig(
            input_data_pattern=f"{data}/validate-*.tfrecord",
            output_file=avg_csv, batch_size=E2E_BATCH,
            frame_features=True, feature_names="rgb,audio",
            feature_sizes="1024,128", num_classes=CLASSES,
            device=dev.type), model=model.to(dev).eval())
        launches["averaged checkpoints"] = read_launches(torch, wrappers)
        check(stats["nonfinite_predictions"] == 0
              and check_csv(avg_csv) == WF_EVAL_VIDEOS
              and launches["averaged checkpoints"][
                  "dbof_cluster_maxpool_v2"] == -(-WF_EVAL_VIDEOS // E2E_BATCH),
              "the averaged checkpoints: CSV, non-finite or launches")
        say("ensemble", f"DbofModel's last two checkpoints averaged and "
                        f"served: {stats['num_videos']} videos, CSV ok")
        del model
    finally:
        logger.removeHandler(logs)
        for run in runs.values():
            shutil.rmtree(run, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds, "step": step}


# ---------------------------------------------------------------------------
# phase 9: serving export (infer/export.py) and cli.parity
# ---------------------------------------------------------------------------

# The paths exported at their serving widths and held, in a fresh process,
# to the eager serving step at two batch sizes; the rest of the zoo cut to
# fit the run's time (one recurrent and convolutional layer, 10 frames,
# 32 VLAD/FV clusters: at the JAX defaults the 27 programs took 19.8 s to
# export at most (LayerNormLstmModel's unrolled 300-step scan 198.0 s),
# up to 5.0 GB each, and 133.1 s to load and serve; at 30 frames its scan
# took 19.0 s, the f32 flagship's 16.0) serving 8 videos.
EXPORT_PATHS = {
    "DbofModel": (BATCH, 128),
    "DbofModel --dbof_int8_serving": (BATCH, 128),
    "NetVladLstmModel": (FLAG_BATCH, 128),
    "NeXtVladModel": (FLAG_BATCH, 128),
}
EXPORT_ZOO_VIDEOS = 8
EXPORT_ZOO_CUT = dict(lstm_layers=1, gru_layers=1, cnn_layers=1,
                      max_frames=10, netvlad_cluster_size=32)


def export_zoo_paths() -> dict:
    """{path: maker} of every registry model not in EXPORT_PATHS at the
    JAX defaults cut by EXPORT_ZOO_CUT, and the f32 flagship (its LSTM a
    Python scan the program unrolls), ChainNetVladModel and
    AttentionPoolingModel at f32 (the 3xTF32 routes of rows 8 and 14)."""
    from yt8m_tpu_torch.models.registry import list_models

    out = {name: make_zoo_model(name, **EXPORT_ZOO_CUT)
           for name in list_models() if name not in EXPORT_PATHS}
    for name in ("NetVladLstmModel", "ChainNetVladModel",
                 "AttentionPoolingModel"):
        out[f"{name} {F32}"] = make_zoo_model(
            name, compute_dtype="float32", **EXPORT_ZOO_CUT)
    return out


def our_kernel_names() -> tuple:
    """The __global__ kernels of the port's CUDA sources."""
    names = set()
    csrc = os.path.join(REPO, "yt8m_tpu_torch", "kernels", "csrc")
    for fname in os.listdir(csrc):
        with open(os.path.join(csrc, fname)) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                r"(\w+)\s*\(", f.read()))
    return tuple(sorted(names))


def kernel_counts(torch, fn) -> dict:
    """{kernel: launches} of the port's kernels in one call of fn, by the
    profiler: each kernel's most over windows (a window can lose a kernel,
    never add one) until two were whole (see bracketed_window), eight at
    most."""
    names = our_kernel_names()
    best, whole_windows = {}, 0
    for attempt in range(8):
        prof, whole = bracketed_window(torch, fn, 0.02 * (attempt % 4 + 1))
        seen = {}
        for e in prof.key_averages():
            if e.self_device_time_total <= 0:
                continue
            hit = [n for n in names if re.search(rf"\b{n}\b", e.key)]
            if hit:
                # Two instances of one template are two keys of a name.
                key = max(hit, key=len)
                seen[key] = seen.get(key, 0) + e.count
        for key, n in seen.items():
            best[key] = max(best.get(key, 0), n)
        whole_windows += whole
        if whole_windows == 2:
            break
    return best


def export_inputs(torch, path: str, b: int, seed: int, frames: int = 300):
    """A path's serving inputs at batch b, drawn on the card from a seed
    (the same tensors in any process)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    model_name = path.split()[0]
    if model_name in VIDEO_LEVEL:
        feats = torch.rand(b, FEATURE_DIM, device="cuda", generator=g)
    else:
        feats = torch.randint(0, 256, (b, frames, FEATURE_DIM), device="cuda",
                              dtype=torch.uint8, generator=g)
    nf = torch.randint(1, frames + 1, (b,), device="cuda", dtype=torch.int32,
                       generator=g)
    return feats, nf


def step_ms(torch, fn, reps=5) -> float:
    """Median CUDA-event time of fn (a serving call) over reps runs."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def export_path(torch, dev, work, path, make, batches, timed) -> dict:
    """Export `path` (batch_size=0) and record the eager serving step's
    top-20 (a generator seeded 0 a call) and launches at each batch size,
    for the fresh process to hold the program to."""
    from yt8m_tpu_torch.infer.export import PROGRAM, export_model
    from yt8m_tpu_torch.infer.predict import make_serving_step

    model_name, *flags = path.split()
    hp, model = make(torch, seed=0)
    model = model.to(dev).eval()
    tag = "_".join(path.replace("-", "").replace("=", "").split())
    out_dir = os.path.join(work, "export", tag)
    step = make_serving_step(model, csv_top_k=TOP_K)
    entry = {"path": path, "dir": out_dir, "batches": list(batches),
             "timed": timed, "eager": {}, "frames": hp.max_frames}
    for b in batches:
        feats, nf = export_inputs(torch, path, b, seed=b,
                                  frames=hp.max_frames)

        def eager(feats=feats, nf=nf):
            return step(feats, nf, torch.Generator(device=dev).manual_seed(
                0))["csv"]

        values, indices = eager()
        wrappers = zero_launches()
        eager()
        launches = {k: v for k, v in read_launches(torch, wrappers).items()
                    if v}
        ref = os.path.join(work, "export", f"{tag}_{b}.pt")
        torch.save({"values": values.cpu(), "indices": indices.cpu()}, ref)
        entry["eager"][str(b)] = {"ref": ref, "launches": launches}
        del feats, nf, values, indices
    state_bytes = sum(t.numel() * t.element_size()
                      for t in model.state_dict().values())
    t0 = time.perf_counter()
    export_model(out_dir, model_name, hp, model, batch_size=0, top_k=TOP_K)
    entry["export_s"] = time.perf_counter() - t0
    entry["program_bytes"] = os.path.getsize(os.path.join(out_dir, PROGRAM))
    entry["state_dict_bytes"] = state_bytes
    say("export", f"{path}: exported in {entry['export_s']:.1f} s (trace "
                  f"and save), program.pt2 {entry['program_bytes'] / 1e6:.1f}"
                  f" MB, state dict {state_bytes / 1e6:.1f} MB (x"
                  f"{entry['program_bytes'] / state_bytes:.3f})")
    del model, step
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def serve_exports(manifest: str) -> int:
    """In a fresh process: load each exported program (load_serving),
    serve its batches, and write beside the manifest each program's top-20
    equality with the eager step's and its launches a batch; on the timed
    paths, the eager step rebuilt here from the same seed (its top-20
    equal to the first process's), and both steps' kernels a batch by the
    profiler and times (the entry point of the subprocess of
    export_phase)."""
    import torch

    from yt8m_tpu_torch.infer.export import load_serving
    from yt8m_tpu_torch.infer.predict import make_serving_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(manifest) as f:
        entries = json.load(f)
    results = []
    for entry in entries:
        t0 = time.perf_counter()
        serve, meta = load_serving(entry["dir"], device="cuda")
        res = {"path": entry["path"], "load_s": time.perf_counter() - t0,
               "batch_size": meta["batch_size"], "by_batch": {}}
        if entry["timed"]:
            # The eager step again, from the same seed: its kernels and
            # time are read beside the program's in this young process
            # (in the long-lived one, the profiler's windows lost the
            # flagship's NetVLAD launches, eight windows in a row).
            model = PATHS[entry["path"]][0](torch, seed=0)[1]
            eager_step = make_serving_step(model.to("cuda").eval(),
                                           csv_top_k=TOP_K)
        for b in entry["batches"]:
            feats, nf = export_inputs(torch, entry["path"], b, seed=b,
                                      frames=entry["frames"])

            def call(feats=feats, nf=nf):
                return serve(feats, nf)

            values, indices = call()
            again = call()
            ref = torch.load(entry["eager"][str(b)]["ref"])
            rec = {
                "equal": bool(torch.equal(values.cpu(), ref["values"])
                              and torch.equal(indices.cpu(),
                                              ref["indices"])),
                "deterministic": bool(torch.equal(values, again[0])
                                      and torch.equal(indices, again[1])),
                "max_abs_diff": float((values.cpu() - ref["values"]).abs()
                                      .max()),
                "indices_equal": float((indices.cpu() == ref["indices"])
                                       .float().mean()),
            }
            wrappers = zero_launches()
            call()
            rec["launches"] = {k: v for k, v in
                               read_launches(torch, wrappers).items() if v}
            if entry["timed"]:
                def eager(feats=feats, nf=nf):
                    return eager_step(feats, nf, torch.Generator(
                        device="cuda").manual_seed(0))["csv"]

                ev, ei = eager()
                rec["eager_equal"] = bool(
                    torch.equal(ev.cpu(), ref["values"])
                    and torch.equal(ei.cpu(), ref["indices"]))
                rec["kernels"] = kernel_counts(torch, call)
                rec["eager_kernels"] = kernel_counts(torch, eager)
                rec["ms"] = step_ms(torch, call)
                rec["eager_ms"] = step_ms(torch, eager)
                del ev, ei
            res["by_batch"][str(b)] = rec
            del feats, nf, values, indices, again
        results.append(res)
        if entry["timed"]:
            del model, eager_step
        del serve
        gc.collect()
        torch.cuda.empty_cache()
    with open(manifest + ".out", "w") as f:
        json.dump(results, f)
    return 0


def trainer_export(torch, dev, work, data) -> dict:
    """cli.train of DbofModel with --export_model_steps=2 for 2 steps:
    train_dir/export/step_2 must exist; its eager reference is the step-2
    checkpoint served by the eager step (8 videos)."""
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.convert import load_model
    from yt8m_tpu_torch.infer.predict import make_serving_step

    run = os.path.join(work, "export_run")
    t0 = time.perf_counter()
    last = one_card(train_cli)([
        f"--train_data_pattern={data}/train-*.tfrecord", f"--train_dir={run}",
        "--batch_size=64", "--max_steps=2", "--export_model_steps=2",
        "--model=DbofModel", "--frame_features=true",
        "--feature_names=rgb,audio", "--feature_sizes=1024,128",
        f"--num_classes={CLASSES}", f"--device={dev.type}"])
    out_dir = os.path.join(run, "export", "step_2")
    check(last == 2 and os.path.isdir(out_dir),
          f"cli.train --export_model_steps=2: no {out_dir}")
    say("export", f"cli.train DbofModel --export_model_steps=2: "
                  f"{out_dir} written, {time.perf_counter() - t0:.1f} s "
                  f"with the 2 steps")
    with open(os.path.join(run, "model_flags.json")) as f:
        flags = json.load(f)
    from yt8m_tpu_torch.models import ModelHParams

    hp = ModelHParams(**{k: v for k, v in flags["hparams"].items()})
    model = load_model(run, "DbofModel", hp, dev)
    step = make_serving_step(model, csv_top_k=TOP_K)
    feats, nf = export_inputs(torch, "DbofModel", EXPORT_ZOO_VIDEOS,
                              seed=EXPORT_ZOO_VIDEOS)
    values, indices = step(feats, nf, torch.Generator(device=dev).manual_seed(
        0))["csv"]
    ref = os.path.join(work, "export", "trainer_step_2.pt")
    torch.save({"values": values.cpu(), "indices": indices.cpu()}, ref)
    del model, step
    torch.cuda.empty_cache()
    return {"path": "DbofModel", "dir": out_dir, "frames": 300,
            "batches": [EXPORT_ZOO_VIDEOS], "timed": False,
            "eager": {str(EXPORT_ZOO_VIDEOS): {"ref": ref, "launches": {}}}}


def export_phase(torch, dev, work, data) -> dict:
    """Phase 9's export half: the EXPORT_PATHS at their serving widths,
    the zoo at a small depth and the trainer's periodic export, all
    served by a fresh python3 process; each program's top-20 must equal
    the eager step's (a generator seeded 0), bit for bit, with the same
    launches a batch (and, on the timed paths, the same kernels a batch
    by the profiler); eager and exported videos/s beside each other."""
    os.makedirs(os.path.join(work, "export"), exist_ok=True)
    entries = [export_path(torch, dev, work, path, PATHS[path][0], batches,
                           True)
               for path, batches in EXPORT_PATHS.items()]
    for path, make in export_zoo_paths().items():
        entries.append(export_path(torch, dev, work, path, make,
                                   (EXPORT_ZOO_VIDEOS,), False))
    entries.append(trainer_export(torch, dev, work, data))
    manifest = os.path.join(work, "export", "manifest.json")
    with open(manifest, "w") as f:
        json.dump(entries, f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.serve_exports(sys.argv[1]))", manifest],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the fresh serving process failed "
                                f"({proc.returncode}): {proc.stderr[-3000:]}")
    with open(manifest + ".out") as f:
        results = json.load(f)
    say("export", f"the fresh process loaded and served {len(results)} "
                  f"programs in {time.perf_counter() - t0:.1f} s")
    summary = {}
    for entry, res in zip(entries, results):
        path = entry["path"]
        for b, rec in res["by_batch"].items():
            eager = entry["eager"][b]
            check(rec["equal"], f"exported {path} B={b}: top-20 differs from "
                                f"the eager step's (max|diff| "
                                f"{rec['max_abs_diff']:.3e}, indices equal "
                                f"{rec['indices_equal']:.4f})")
            check(rec["deterministic"], f"exported {path} B={b}: two calls "
                                        f"differ")
            if entry["timed"]:
                check(rec["launches"] == eager["launches"],
                      f"exported {path} B={b}: launches {rec['launches']}, "
                      f"eager {eager['launches']}")
                check(rec["eager_equal"],
                      f"{path} B={b}: the eager step rebuilt in the fresh "
                      f"process gives another top-20")
                check(rec["kernels"] == rec["eager_kernels"],
                      f"exported {path} B={b}: kernels {rec['kernels']}, "
                      f"eager {rec['eager_kernels']}")
                eager_ms = rec["eager_ms"]
                say("export", f"{path} B={b}: exported = eager bit for bit; "
                              f"launches {rec['launches']}; kernels "
                              f"{rec['kernels']}; eager {eager_ms:.3f} ms "
                              f"({int(b) / eager_ms * 1e3:.0f} videos/s), "
                              f"exported {rec['ms']:.3f} ms "
                              f"({int(b) / rec['ms'] * 1e3:.0f} videos/s)")
                summary.setdefault(path, {
                    "export_s": entry["export_s"],
                    "program_mb": entry["program_bytes"] / 1e6,
                    "state_dict_mb": entry["state_dict_bytes"] / 1e6,
                    "load_s": res["load_s"]})[f"B={b}"] = {
                        "eager_ms": eager_ms, "exported_ms": rec["ms"],
                        "launches": rec["launches"]}
        if not entry["timed"]:
            summary.setdefault("zoo", {})[path] = {
                "export_s": entry.get("export_s"),
                "program_mb": entry.get("program_bytes", 0) / 1e6}
    say("export", "the rest of the zoo (one recurrent layer), "
                  f"{EXPORT_ZOO_VIDEOS} videos each, exported = eager bit "
                  "for bit; export seconds: " + ", ".join(
                      f"{p} {r['export_s']:.1f}"
                      for p, r in summary["zoo"].items()
                      if r["export_s"] is not None))
    say("export", "summary " + json.dumps(summary))
    shutil.rmtree(os.path.join(work, "export"), ignore_errors=True)
    return summary


def parity_phase(work, data) -> dict:
    """cli.parity on the workflow's inference CSV against itself, with the
    eval labels from the TFRecords: every delta 0, pass, exit 0."""
    import io
    from contextlib import redirect_stdout

    from yt8m_tpu_torch.cli import parity

    csv_path = os.path.join(work, "workflow.csv")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = parity.main([f"--reference_predictions={csv_path}",
                          f"--our_predictions={csv_path}",
                          f"--labels={data}/validate-*.tfrecord",
                          f"--num_classes={CLASSES}", f"--top_k={TOP_K}"])
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(rc == 0 and report["pass"] and report["videos_compared"]
          == WF_EVAL_VIDEOS and all(v == 0 for v in report["delta"].values()),
          f"cli.parity of the workflow CSV against itself: rc {rc}, {report}")
    say("parity", f"cli.parity workflow.csv vs itself over "
                  f"{report['videos_compared']} videos: GAP "
                  f"{report['ours']['gap']:.6f}, every delta 0, exit {rc}")
    return report


# ---------------------------------------------------------------------------
# phase 10: multi-GPU training, eval and inference (parallel/)
# ---------------------------------------------------------------------------

PARALLEL_BATCH = TRAIN_BATCH  # the global batch of (a) and (b)
PARALLEL_STEPS = 3
# Shards the VLAD hidden FC (K*D x hidden = 294,912 x 1024 = 3.02e8
# elements; dim 0 divides by 2 and 4) and nothing else: the next largest
# variable, the MoE gates, holds 2.9e7.
FSDP_MIN_SIZE = 100_000_000
SHARED_RANKS = 2      # (b): ranks that share one card over gloo
SHARED_STEPS = 1
# (b)'s bounds against the one-device step, from the same weights on the
# same global batches (SGD): the loss within 2e-3 relative; each
# variable's (and BN statistic's) move, as a norm, within 2e-2
# relative of the one-device move's, the flagship's bf16 bound
# (tests/test_torch_train.py; the card-vs-CPU gradient norms below); and
# its largest element deviation within max(2e-2, 2 x the witness's) of
# its largest element move. The ranks' half batches run the kernels'
# batch reductions (netvlad_core's dcenters, the LSTM's dW_h), the
# gradient sums and the BN moments in another order (and the inline BN's
# variance as max(E[x^2] - E[x]^2, 0), as the JAX manual step does); a
# last-bit difference before a bf16 rounding moves an operand one bf16
# step. The witness is the one-device step from the same weights moved
# one float32 step each, up or down at random: float32 noise of the size
# of another summation order. At the seed's saturated start (loss
# ~1.9e3) it moved elements of two steps' moves by up to 0.12 of their
# variable's largest (the VLAD hidden FC, read on the card), so the
# element bound follows the witness. (b) takes one step of each kind,
# its depth cut for the script's time.
SHARED_LOSS_REL = 2e-3
SHARED_MOVE_REL = 2e-2
# (d): the tensor-parallel step (--model_parallel) on TP_RANKS ranks
# sharing one card over gloo, a (1, 2) grid, TP_STEPS SGD steps of
# DbofModel and of the fused flagship on one global batch, against the
# one-device step at (b)'s bounds and witness.
TP_RANKS = 2
TP_STEPS = 3
PARALLEL_TRAIN_VIDEOS = 32
PARALLEL_EVAL_VIDEOS = 16
PARALLEL_CLI_BATCH = 16
PARALLEL_DEADLINE_S = 600.0  # each spawned group of phase 10


def one_card(cli):
    """`cli`'s main at one rank (--num_devices=1): phases 1-9 measure one
    card, and on a machine with several the CLIs' default would start a
    rank on each."""
    def main(argv):
        return cli.main([*argv, "--num_devices=1"])

    return main


def flagship_hparams(fused: bool = True) -> dict:
    """The flagship's ModelHParams fields at the JAX defaults (bf16)."""
    return dict(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=FLAG_FRAMES,
        netvlad_cluster_size=VLAD_CLUSTERS, netvlad_hidden_size=VLAD_HIDDEN,
        netvlad_add_batch_norm=True, netvlad_gating=True,
        lstm_cells=LSTM_CELLS, lstm_layers=LSTM_LAYERS, lstm_pooling="last",
        moe_num_mixtures=MIXTURES, compute_dtype="bfloat16",
        netvlad_fused_train=fused)


def dbof_hparams() -> dict:
    """DbofModel's ModelHParams fields at __graft_entry__.py:35-46's widths
    (bf16)."""
    return dict(
        vocab_size=CLASSES, feature_dim=FEATURE_DIM, max_frames=300,
        moe_num_mixtures=MIXTURES, dbof_cluster_size=CLUSTERS,
        dbof_hidden_size=HIDDEN, iterations=FRAMES,
        compute_dtype="bfloat16")


def seeded_model(torch, dev, name: str, hparams: dict, seed: int,
                 bn_axis: str = ""):
    """`name` drawn on `dev` from a seed, as the replay harness
    (parallel/replay.py) draws it on each rank, in training mode."""
    from yt8m_tpu_torch.models import ModelHParams, get_model

    with torch.device(dev):
        model = get_model(name, ModelHParams(**hparams, bn_axis=bn_axis))
    model.reset_parameters(torch.Generator(device=dev).manual_seed(seed))
    return model.train()


def seeded_flagship(torch, dev, seed: int, bn_axis: str = ""):
    return seeded_model(torch, dev, "NetVladLstmModel", flagship_hparams(),
                        seed, bn_axis)


def comm_share(torch, fn) -> tuple:
    """(NCCL kernels' device ms, all kernels' device ms) of one fn() by
    the profiler; (None, None) where it saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0
               and not e.is_user_annotation]
    if not kernels:
        return None, None
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    comm = sum(e.self_device_time_total for e in kernels
               if "nccl" in e.key.lower()) / 1e3
    return comm, total


def parallel_modes(world: int) -> list:
    """(a)'s modes at `world` ranks: (name, fsdp_min_size,
    model_parallel): data-parallel, FSDP, and tensor-parallel at each mp
    of 2 and 4 that divides the ranks."""
    return [("ddp", 0, 1), ("fsdp", FSDP_MIN_SIZE, 1)] + [
        (f"tp{mp}", 0, mp) for mp in (2, 4)
        if mp <= world and world % mp == 0]


def parallel_rank(steps: int, device_type: str) -> dict:
    """One rank of phase 10 (a), over NCCL: the flagship at full width
    with --netvlad_fused_train, `steps` data-parallel steps (every
    variable replicated), then `steps` with --fsdp_min_size=FSDP_MIN_SIZE,
    then `steps` tensor-parallel at each model_parallel of
    parallel_modes (a (world // mp, mp) grid; a data block's rows on its
    mp ranks), each from the seed-0 weights, on this rank's block of one
    repeated global batch (Adam, the config defaults). At one rank the
    first data-parallel step is held bit for bit to make_train_step's."""
    import torch

    from yt8m_tpu_torch.parallel import distributed
    from yt8m_tpu_torch.parallel.mesh import DATA_AXIS, shard_batch
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import ParallelTrainState, TrainState
    from yt8m_tpu_torch.train.step import (
        make_parallel_train_step,
        make_train_step,
    )

    world, rank = distributed.process_count(), distributed.process_index()
    dev = distributed.rank_device(device_type)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = train_batch(torch, dev, PARALLEL_BATCH, seed=1)
    local = shard_batch(full, rank, world)
    axis = DATA_AXIS if world > 1 else ""
    out = {"rank": rank, "world": world, "device": str(dev),
           "name": torch.cuda.get_device_name(dev)}
    if world == 1:
        model = seeded_flagship(torch, dev, 0)
        state = TrainState(model, global_batch_size=PARALLEL_BATCH)
        # Only the metrics are kept: the returned state would hold the
        # reference's model, gradients and Adam moments (5.55 GiB) in
        # the peak of the steps below.
        metrics = make_train_step(get_loss("CrossEntropyLoss"))(state,
                                                                local)[1]
        ref = {"loss": metrics["loss"].item(),
               "params": {n: p.detach().cpu()
                          for n, p in model.named_parameters()}}
        del state, model, metrics
        torch.cuda.empty_cache()
    for mode, fsdp, mp in parallel_modes(world):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        blocks = world // mp
        rows = shard_batch(full, rank // mp, blocks) if mp > 1 else local
        model = seeded_flagship(torch, dev, 0, axis if blocks > 1 else "")
        state = ParallelTrainState(model, fsdp_min_size=fsdp,
                                   model_parallel=mp,
                                   global_batch_size=PARALLEL_BATCH)
        step = make_parallel_train_step(get_loss("CrossEntropyLoss"))
        wrappers = zero_launches()
        times, losses = timed_steps(torch, step, state, rows, steps)
        launches = read_launches(torch, wrappers)
        r = {"losses": losses, "step_ms": statistics.median(times[1:]),
             "times_ms": times, "launches": launches, "grid": (blocks, mp),
             "sharded": sorted(state.shards) + sorted(state.blocks),
             "sharded_elements": sum(s.numel() * blocks
                                     for s in state.shards.values())
             + sum(state.model.get_parameter(n).numel() * mp
                   for n in state.blocks),
             "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
        if mode == "ddp" and world == 1:
            # Step 1 again from the seed, held to make_train_step's bits.
            model1 = seeded_flagship(torch, dev, 0)
            state1 = ParallelTrainState(model1,
                                        global_batch_size=PARALLEL_BATCH)
            m1 = step(state1, local)[1]  # (the state is state1)
            r["bitwise_loss"] = m1["loss"].item() == ref["loss"]
            r["bitwise_params"] = [n for n, p in model1.named_parameters()
                                   if not torch.equal(p.cpu(),
                                                      ref["params"][n])]
            del state1, model1, m1, ref
            torch.cuda.empty_cache()
        r["comm_ms"], r["device_ms"] = comm_share(
            torch, lambda: step(state, rows))
        out[mode] = r
        del state, model, step
        torch.cuda.empty_cache()
    return out


def parallel_one_rank_a_card(torch, dev) -> dict:
    """(a): torch.cuda.device_count() ranks over NCCL; checks and prints."""
    from yt8m_tpu_torch.parallel.distributed import launch

    world = torch.cuda.device_count()
    t0 = time.perf_counter()
    ranks = launch(parallel_rank, (PARALLEL_STEPS, dev.type), nprocs=world,
                   device=dev.type, timeout_s=PARALLEL_DEADLINE_S)
    seconds = time.perf_counter() - t0
    fwd_want = PARALLEL_STEPS * LSTM_LAYERS
    head = ["video_classifier.experts_bias", "video_classifier.experts_kernel",
            "video_classifier.gates_kernel"]
    for r in ranks:
        for mode, _, mp in parallel_modes(world):
            m = r[mode]
            say("parallel", f"(a) rank {r['rank']}/{world} on {r['device']} "
                            f"{mode} (grid {m['grid'][0]} x {m['grid'][1]}): "
                            f"global B={PARALLEL_BATCH} "
                            f"({PARALLEL_BATCH // m['grid'][0]} a rank), "
                            f"losses "
                            f"{[round(x, 4) for x in m['losses']]}, step ms "
                            f"{[round(t, 3) for t in m['times_ms']]} (median "
                            f"of the last {PARALLEL_STEPS - 1}: "
                            f"{m['step_ms']:.3f}), peak "
                            f"{m['peak_gib']:.2f} GiB, sharded "
                            f"{m['sharded']} ({m['sharded_elements']} "
                            f"elements), NCCL {m['comm_ms']} of "
                            f"{m['device_ms']} device ms in one step")
            check(all(math.isfinite(x) for x in m["losses"])
                  and m["losses"][-1] < m["losses"][0],
                  f"(a) {mode} rank {r['rank']}: losses not finite and "
                  f"falling: {m['losses']}")
            for fn, want in (("netvlad_core_forward", PARALLEL_STEPS),
                             ("netvlad_core_backward", PARALLEL_STEPS),
                             ("lstm_train_forward", fwd_want),
                             ("lstm_train_backward", fwd_want)):
                check(m["launches"][fn] == want,
                      f"(a) {mode} rank {r['rank']}: {fn} launched "
                      f"{m['launches'][fn]} times in {PARALLEL_STEPS} steps,"
                      f" want {want}")
            if mp > 1:
                check(m["sharded"] == head,
                      f"(a) {mode} at {world} ranks sharded {m['sharded']}")
        sharded = r["fsdp"]["sharded"]
        check(sharded == (["vlad_hidden_weights"] if world > 1 else []),
              f"(a) FSDP at {world} ranks sharded {sharded}")
        if world == 1:
            m = r["ddp"]
            say("parallel", f"(a) one rank: the data-parallel step against "
                            f"make_train_step's, bit for bit: loss "
                            f"{m['bitwise_loss']}, parameters that differ "
                            f"{m['bitwise_params']}")
            check(m["bitwise_loss"] and not m["bitwise_params"],
                  "(a) the one-rank data-parallel step is not "
                  "make_train_step's bit for bit")
    say("parallel", f"(a) {world} rank(s) over NCCL in {seconds:.1f} s")
    return {"world": world, "ranks": ranks, "seconds": seconds}


def shared_batches(seed: int, steps: int) -> list:
    """(b)'s global batches as numpy (they travel to the ranks)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"features": rng.integers(0, 256, (PARALLEL_BATCH, 300,
                                               FEATURE_DIM), dtype=np.uint8),
             "num_frames": rng.integers(FRAMES, 301, PARALLEL_BATCH)
             .astype(np.int32),
             "labels": (rng.random((PARALLEL_BATCH, CLASSES)) < 0.002)
             .astype(np.float32),
             "batch_mask": np.ones(PARALLEL_BATCH, np.float32)}
            for _ in range(steps)]


def one_device_replay(torch, dev, batches, nudge: bool = False,
                      name: str = "NetVladLstmModel", hparams=None,
                      uniforms=None) -> dict:
    """make_train_step (SGD) of `name` (the fused flagship by default)
    from the seed-0 weights on `batches` (the frame sampling fed
    `uniforms`, where given; the witness, `nudge`: each weight moved one
    float32 step up or down); losses, the state after, the initial state
    (float32, on the host)."""
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.state import TrainState
    from yt8m_tpu_torch.train.step import make_train_step

    model = seeded_model(torch, dev, name, hparams or flagship_hparams(), 0)
    start = {k: v.detach().to("cpu", torch.float32, copy=True)
             for k, v in model.state_dict().items()}
    if nudge:
        g = torch.Generator(device=dev).manual_seed(5)
        with torch.no_grad():
            for p in model.parameters():
                up = torch.rand(p.shape, generator=g, device=dev) < 0.5
                p.copy_(torch.nextafter(p, torch.where(
                    up, torch.full_like(p, math.inf),
                    torch.full_like(p, -math.inf))))
    state = TrainState(model, optimizer="SgdOptimizer",
                       global_batch_size=PARALLEL_BATCH)
    step = make_train_step(get_loss("CrossEntropyLoss"))
    losses = []
    for i, b in enumerate(batches):
        u = (None if uniforms is None
             else torch.from_numpy(uniforms[i]).to(dev))
        _, metrics = step(state, {k: torch.from_numpy(v).to(dev)
                                  for k, v in b.items()}, u=u)
        losses.append(metrics["loss"].item())
    out = {"losses": losses, "start": start,
           "state": {k: v.detach().to("cpu", torch.float32, copy=True)
                     for k, v in model.state_dict().items()}}
    del state, model
    torch.cuda.empty_cache()
    return out


def moves(torch, got, want, start) -> dict:
    """{variable: (|move_got| / |move_want| - 1, max|got - want| /
    max|want - start|)} (a variable that did not move counts its
    difference alone)."""
    out = {}
    for k, w in want.items():
        move, other = w - start[k], got[k] - start[k]
        norm = float(torch.linalg.vector_norm(move, dtype=torch.float64))
        top = float(torch.max(torch.abs(move)))
        diff = float(torch.max(torch.abs(got[k] - w)))
        out[k] = (float(torch.linalg.vector_norm(other, dtype=torch.float64))
                  / norm - 1.0 if norm > 0 else 0.0,
                  diff / top if top > 0 else diff)
    return out


def parallel_shared_card(torch, dev, work) -> dict:
    """(b): SHARED_RANKS ranks on one card over gloo (NCCL refuses two
    ranks on one card; gloo carries card tensors through host memory),
    SHARED_STEPS data-parallel and SHARED_STEPS FSDP steps (SGD), against
    the one-device step on the same global batches from the same
    weights, with the witness of SHARED_LOSS_REL's comment."""
    from yt8m_tpu_torch.parallel.distributed import launch
    from yt8m_tpu_torch.parallel.replay import replay_all

    batches = shared_batches(7, SHARED_STEPS)
    specs = [dict(model="NetVladLstmModel", hparams=flagship_hparams(),
                  seed=0, batches=batches, optimizer="SgdOptimizer",
                  fsdp_min_size=fsdp, device=dev.type, state_ranks=[0],
                  state_file=os.path.join(work, f"shared-{fsdp}-{{rank}}.pt"),
                  train=dict(global_batch_size=PARALLEL_BATCH))
             for fsdp in (0, FSDP_MIN_SIZE)]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # The one-device replays run beside the ranks, on the same card.
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(launch, replay_all, (specs,),
                              nprocs=SHARED_RANKS, device=dev.type,
                              backend="gloo",
                              timeout_s=PARALLEL_DEADLINE_S)
        ref = one_device_replay(torch, dev, batches)
        nudged = one_device_replay(torch, dev, batches, nudge=True)
        ranks = pending.result()
    seconds = time.perf_counter() - t0
    witness = moves(torch, nudged["state"], ref["state"], ref["start"])
    w_loss = max(abs(a - b) / abs(b) for a, b in zip(nudged["losses"],
                                                     ref["losses"]))
    out = {"seconds": seconds, "witness_loss": w_loss,
           "witness_top": max(w for _, w in witness.values())}
    for i, mode in enumerate(("ddp", "fsdp")):
        r = ranks[0][i]
        got = moves(torch, torch.load(r["state"], weights_only=True),
                    ref["state"], ref["start"])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                           ref["losses"]))
        norm_name = max(got, key=lambda k: abs(got[k][0]))
        excess = {k: got[k][1] / max(SHARED_MOVE_REL, 2 * witness[k][1])
                  for k in got}
        top_name = max(excess, key=excess.get)
        say("parallel", f"(b) {SHARED_RANKS} ranks sharing one card over "
                        f"gloo, {mode} ({SHARED_STEPS} SGD steps, sharded "
                        f"{r['sharded']}): losses "
                        f"{[round(x, 5) for x in r['losses']]} against the "
                        f"one-device {[round(x, 5) for x in ref['losses']]}"
                        f" ({loss_rel:.3e} relative, bound "
                        f"{SHARED_LOSS_REL}); move norms within "
                        f"{abs(got[norm_name][0]):.3e} ({norm_name}, bound "
                        f"{SHARED_MOVE_REL}); element deviations, of the "
                        f"largest move, {top_name} {got[top_name][1]:.3e} "
                        f"against the witness's {witness[top_name][1]:.3e}"
                        f" (bound max({SHARED_MOVE_REL}, 2 x witness)); the "
                        f"witness's largest {out['witness_top']:.3e}, its "
                        f"loss {w_loss:.3e}")
        check(loss_rel <= SHARED_LOSS_REL
              and abs(got[norm_name][0]) <= SHARED_MOVE_REL
              and excess[top_name] <= 1.0,
              f"(b) {mode}: the ranks sharing the card are not the "
              f"one-device step (loss {loss_rel:.3e}, norm "
              f"{got[norm_name][0]:.3e} on {norm_name}, element "
              f"{got[top_name][1]:.3e} on {top_name})")
        check(r["sharded"] == (["vlad_hidden_weights"] if mode == "fsdp"
                               else []), f"(b) {mode} sharded {r['sharded']}")
        check(r["digest"] == ranks[1][i]["digest"],
              f"(b) {mode}: the ranks' models differ")
        out[mode] = {"loss_rel": loss_rel,
                     "norm_rel": abs(got[norm_name][0]),
                     "element": (top_name, got[top_name][1])}
    say("parallel", f"(b) the ranks and the replays in {seconds:.1f} s "
                    f"(rank 0: "
                    + json.dumps([{k: (round(v, 1) if isinstance(v, float)
                                       else [round(x, 1) for x in v])
                                   for k, v in r["seconds"].items()}
                                  for r in ranks[0]])
                    + ")")
    return out


def tp_replay(specs) -> list:
    """One rank of (d): parallel/replay.py :: replay_steps of each spec,
    with the kernel launches of its steps."""
    import torch

    from yt8m_tpu_torch.parallel.replay import replay_steps

    out = []
    for spec in specs:
        wrappers = zero_launches()
        r = replay_steps(spec)
        r["launches"] = read_launches(torch, wrappers)
        out.append(r)
    return out


def parallel_tp_shared_card(torch, dev, work) -> dict:
    """(d): TP_RANKS ranks sharing one card over gloo as a (1, TP_RANKS)
    grid (--model_parallel=TP_RANKS): DbofModel at the graft entry's
    widths and the fused flagship at full width, TP_STEPS SGD steps each
    on one global batch of PARALLEL_BATCH (DbofModel's frame sampling fed
    the same global uniforms), against the one-device step from the same
    weights on the same batches, with (b)'s bounds and a witness of its
    own a model. Each rank holds its blocks of the MoE head (and of
    DbofModel's cluster layer); the flagship's trainable kernels launch
    inside the TP step."""
    import numpy as np

    from yt8m_tpu_torch.parallel.distributed import launch

    batches = shared_batches(9, 1) * TP_STEPS
    rng = np.random.default_rng(10)
    uniforms = [rng.uniform(size=(PARALLEL_BATCH, FRAMES)).astype(np.float32)
                for _ in range(TP_STEPS)]
    paths = {"DbofModel": (dbof_hparams(), uniforms),
             "NetVladLstmModel": (flagship_hparams(), None)}
    specs = [dict(model=name, hparams=hp, seed=0, batches=batches,
                  uniforms=u, optimizer="SgdOptimizer",
                  model_parallel=TP_RANKS, device=dev.type, state_ranks=[0],
                  state_file=os.path.join(work, f"tp-{name}-{{rank}}.pt"),
                  train=dict(global_batch_size=PARALLEL_BATCH))
             for name, (hp, u) in paths.items()]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(launch, tp_replay, (specs,), nprocs=TP_RANKS,
                              device=dev.type, backend="gloo",
                              timeout_s=PARALLEL_DEADLINE_S)
        refs = {name: [one_device_replay(torch, dev, batches, nudge, name,
                                         hp, u) for nudge in (False, True)]
                for name, (hp, u) in paths.items()}
        ranks = pending.result()
    seconds = time.perf_counter() - t0
    head = ["experts_bias", "experts_kernel", "gates_kernel"]
    want_blocks = {"DbofModel": ["cluster_kernel"] + [
        f"video_classifier.{k}" for k in head],
        "NetVladLstmModel": [f"video_classifier.{k}" for k in head]}
    out = {"seconds": seconds}
    for i, name in enumerate(paths):
        ref, nudged = refs[name]
        r = ranks[0][i]
        witness = moves(torch, nudged["state"], ref["state"], ref["start"])
        w_loss = max(abs(a - b) / abs(b) for a, b in zip(nudged["losses"],
                                                         ref["losses"]))
        got = moves(torch, torch.load(r["state"], weights_only=True),
                    ref["state"], ref["start"])
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                           ref["losses"]))
        norm_name = max(got, key=lambda k: abs(got[k][0]))
        excess = {k: got[k][1] / max(SHARED_MOVE_REL, 2 * witness[k][1])
                  for k in got}
        top_name = max(excess, key=excess.get)
        held = {k: r["held"][k]["param"] for k in r["blocks"]}
        say("parallel", f"(d) {TP_RANKS} ranks sharing one card over gloo, "
                        f"--model_parallel={TP_RANKS}, {name} "
                        f"({TP_STEPS} SGD steps, blocks {held}): losses "
                        f"{[round(x, 5) for x in r['losses']]} against the "
                        f"one-device {[round(x, 5) for x in ref['losses']]}"
                        f" ({loss_rel:.3e} relative, bound "
                        f"{SHARED_LOSS_REL}; the witness's {w_loss:.3e}); "
                        f"move norms within {abs(got[norm_name][0]):.3e} "
                        f"({norm_name}, bound {SHARED_MOVE_REL}); element "
                        f"deviations, of the largest move, {top_name} "
                        f"{got[top_name][1]:.3e} against the witness's "
                        f"{witness[top_name][1]:.3e} (bound max("
                        f"{SHARED_MOVE_REL}, 2 x witness)); launches "
                        + json.dumps({k: v for k, v in r["launches"].items()
                                      if v}))
        check(loss_rel <= SHARED_LOSS_REL
              and abs(got[norm_name][0]) <= SHARED_MOVE_REL
              and excess[top_name] <= 1.0,
              f"(d) {name}: the TP ranks are not the one-device step (loss "
              f"{loss_rel:.3e}, norm {got[norm_name][0]:.3e} on {norm_name},"
              f" element {got[top_name][1]:.3e} on {top_name})")
        check(r["blocks"] == want_blocks[name] and not r["sharded"],
              f"(d) {name}: blocks {r['blocks']}, FSDP {r['sharded']}")
        for k in r["blocks"]:
            h = r["held"][k]
            check(h["param"] == h["grad"] and h["param"][-1] * TP_RANKS
                  == ref["state"][k].shape[-1],
                  f"(d) {name}: rank 0 holds {h} of {k}")
        check(r["digest"] == ranks[1][i]["digest"],
              f"(d) {name}: the ranks' gathered models differ")
        if name == "NetVladLstmModel":
            fwd_want = TP_STEPS * LSTM_LAYERS
            for rank in ranks:
                n = rank[i]["launches"]
                check(n["netvlad_core_forward"] == TP_STEPS
                      and n["netvlad_core_backward"] == TP_STEPS
                      and n["lstm_train_forward"] == fwd_want
                      and n["lstm_train_backward"] == fwd_want,
                      f"(d) rank {rank[i]['rank']}: the flagship's TP steps "
                      f"launched {n}")
        out[name] = {"loss_rel": loss_rel, "norm_rel": abs(got[norm_name][0]),
                     "element": (top_name, got[top_name][1]),
                     "launches": [rank[i]["launches"] for rank in ranks]}
        os.remove(r["state"])
    say("parallel", f"(d) the TP ranks and the replays in {seconds:.1f} s")
    return out


def tp_workflow(torch, dev, work) -> dict:
    """(e): cli.train --num_devices=TP_RANKS --model_parallel=TP_RANKS with
    DbofModel at the graft entry's widths on (c)'s data, TP_RANKS ranks
    sharing the card over gloo (one a card on several, over NCCL), two
    SGD steps (the model group's first rank reads and broadcasts the
    batches); cli.eval --run_once at one rank serves its checkpoint, the
    one-card format, with the serving kernels."""
    from yt8m_tpu_torch.cli import eval as eval_cli
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.train.checkpoint import step_dirs

    cards = torch.cuda.device_count()
    spawn = dict(timeout_s=PARALLEL_DEADLINE_S,
                 **({} if cards >= TP_RANKS else {"backend": "gloo"}))
    data = os.path.join(work, "parallel_data")
    run = os.path.join(work, "tp_run")
    t0 = time.perf_counter()
    last = train_cli.main([
        f"--train_data_pattern={data}/train-*.tfrecord", f"--train_dir={run}",
        f"--batch_size={PARALLEL_CLI_BATCH}", *DBOF_FLAGS,
        *reader_flags("DbofModel"), f"--num_classes={CLASSES}",
        "--compute_dtype=bfloat16", "--log_every_n_steps=1",
        "--optimizer=SgdOptimizer", "--max_steps=2",
        f"--num_devices={TP_RANKS}", f"--model_parallel={TP_RANKS}",
        f"--device={dev.type}"], **spawn)
    train_s = time.perf_counter() - t0
    check(last == 2 and step_dirs(run) == [2],
          f"(e) cli.train --model_parallel={TP_RANKS}: step {last}, "
          f"checkpoints {step_dirs(run)}")
    with open(os.path.join(run, "events.jsonl")) as f:
        losses = [json.loads(line)["GlobalStep/Loss"] for line in f
                  if "GlobalStep/Loss" in line]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"(e) the TP run logged {losses}")
    wrappers = zero_launches()
    t0 = time.perf_counter()
    metrics = eval_cli.main([
        f"--eval_data_pattern={data}/validate-*", f"--train_dir={run}",
        f"--device={dev.type}", "--run_once", "--num_devices=1",
        f"--batch_size={PARALLEL_CLI_BATCH}"])
    eval_s = time.perf_counter() - t0
    launches = read_launches(torch, wrappers)
    check(metrics["step"] == 2 and 0 <= metrics["gap"] <= 1
          and launches["dbof_cluster_maxpool_v2"] > 0
          and launches["moe_head_serving"] > 0,
          f"(e) cli.eval of the TP checkpoint: {metrics}, launches "
          f"{launches}")
    say("parallel", f"(e) cli.train DbofModel --model_parallel={TP_RANKS} at "
                    f"{TP_RANKS} ranks "
                    + ("over NCCL" if cards >= TP_RANKS
                       else "sharing the card over gloo")
                    + f": losses {[round(x, 4) for x in losses]} in "
                    f"{train_s:.1f} s; cli.eval at one rank of its step 2: "
                    f"GAP {metrics['gap']:.5f} Hit@1 "
                    f"{metrics['avg_hit_at_one']:.5f} in {eval_s:.1f} s, "
                    f"launches " + json.dumps(
                        {k: v for k, v in launches.items() if v}))
    shutil.rmtree(run, ignore_errors=True)
    return {"losses": losses, "seconds": {"train": train_s, "eval": eval_s},
            "launches": launches}


def link_or_copy(src: str, dst: str) -> None:
    """A checkpoint's large files hard-linked (a later step never rewrites
    them), the rest copied (model_flags.json is rewritten in place)."""
    if os.path.getsize(src) >= 1 << 20:
        os.link(src, dst)
    else:
        shutil.copy2(src, dst)


def parallel_workflow(torch, dev, work) -> dict:
    """(c): cli.train --num_devices=W --fsdp_min_size=FSDP_MIN_SIZE to step
    1; then, together, its resume to step 2 in new processes, cli.eval
    --run_once and cli.inference at W ranks of the step-1 checkpoint (a
    copy of the run), and cli.inference at one rank of that checkpoint at
    the ranks' batch: the CSV byte for byte; last, the resumed step-2
    checkpoint served on one rank. W is the card count over NCCL, or on
    one card SHARED_RANKS ranks sharing it over gloo, so the multi-rank
    Trainer (its padded batches, rank 0's gathered checkpoint, the
    re-sharding restore) and the serving gathers run on the card either
    way; its depth is cut for the script's time."""
    from yt8m_tpu_torch.cli import eval as eval_cli
    from yt8m_tpu_torch.cli import inference as inference_cli
    from yt8m_tpu_torch.cli import train as train_cli
    from yt8m_tpu_torch.data.synthetic import write_dataset
    from yt8m_tpu_torch.train.checkpoint import step_dirs

    cards = torch.cuda.device_count()
    world = cards if cards > 1 else SHARED_RANKS
    spawn = dict(timeout_s=PARALLEL_DEADLINE_S,
                 **({} if cards > 1 else {"backend": "gloo"}))
    data = os.path.join(work, "parallel_data")
    write_dataset(data, "train", num_shards=4,
                  videos_per_shard=PARALLEL_TRAIN_VIDEOS // 4,
                  frame_level=True, num_classes=CLASSES, seed=11)
    write_dataset(data, "validate", num_shards=2,
                  videos_per_shard=PARALLEL_EVAL_VIDEOS // 2,
                  frame_level=True, num_classes=CLASSES, seed=12)
    run = os.path.join(work, "parallel_run")
    served = os.path.join(work, "parallel_served")
    flags = [f"--train_data_pattern={data}/train-*.tfrecord",
             f"--train_dir={run}", f"--batch_size={PARALLEL_CLI_BATCH}",
             *FLAGSHIP_FLAGS, *reader_flags("NetVladLstmModel"),
             f"--num_classes={CLASSES}", "--compute_dtype=bfloat16",
             "--netvlad_fused_train", "--log_every_n_steps=1",
             "--save_checkpoint_every_n_steps=1000",
             # SGD: a step of its checkpoint is the model's 1.49 GB alone
             "--optimizer=SgdOptimizer",
             f"--num_devices={world}", f"--fsdp_min_size={FSDP_MIN_SIZE}",
             f"--device={dev.type}"]

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        return name, time.perf_counter() - t0, out

    def serve(train_dir, n, batch, path):
        return inference_cli.main([
            f"--input_data_pattern={data}/validate-*",
            f"--train_dir={train_dir}", f"--device={dev.type}",
            f"--output_file={path}", f"--batch_size={batch}",
            f"--num_devices={n}"], **(spawn if n > 1 else {}))

    _, first_s, last = timed("train to 1", train_cli.main,
                             flags + ["--max_steps=1"], **spawn)
    check(last == 1 and step_dirs(run) == [1],
          f"(c) cli.train --max_steps=1: step {last}, checkpoints "
          f"{step_dirs(run)}")
    shutil.copytree(run, served, copy_function=link_or_copy)
    # At W ranks each serves PARALLEL_CLI_BATCH / W rows of a batch; the
    # one-rank run at that batch serves the same rows together.
    paths = {n: os.path.join(work, f"parallel-{n}.csv") for n in (world, 1)}
    with ThreadPoolExecutor(max_workers=4) as pool:
        runs = [pool.submit(timed, "resume to 2", train_cli.main,
                            flags + ["--max_steps=2"], **spawn),
                pool.submit(timed, "eval", eval_cli.main, [
                    f"--eval_data_pattern={data}/validate-*",
                    f"--train_dir={served}", f"--device={dev.type}",
                    "--run_once", f"--num_devices={world}",
                    f"--batch_size={PARALLEL_CLI_BATCH}"], **spawn)]
        runs += [pool.submit(timed, f"inference {n} x {batch}", serve,
                             served, n, batch, paths[n])
                 for n, batch in ((world, PARALLEL_CLI_BATCH),
                                  (1, PARALLEL_CLI_BATCH // world))]
        done = [r.result() for r in runs]
    seconds = {"train to 1": first_s}
    seconds.update((name, s) for name, s, _ in done)
    check(done[0][2] == 2 and step_dirs(run) == [1, 2],
          f"(c) cli.train --max_steps=2: step {done[0][2]}, checkpoints "
          f"{step_dirs(run)}")
    with open(os.path.join(run, "events.jsonl")) as f:
        losses = [json.loads(line)["GlobalStep/Loss"] for line in f
                  if "GlobalStep/Loss" in line]
    check(len(losses) == 2 and all(map(math.isfinite, losses)),
          f"(c) the two runs logged {losses}")
    metrics = done[1][2]
    mean_ap = sum(metrics["aps"]) / len(metrics["aps"])
    check(metrics["step"] == 1 and all(0 <= v <= 1 for v in (
        metrics["gap"], metrics["avg_hit_at_one"], mean_ap)),
        f"(c) cli.eval: {metrics}")
    csv = {}
    for (name, _, stats), n in zip(done[2:], (world, 1)):
        check(stats["num_videos"] == PARALLEL_EVAL_VIDEOS
              and check_csv(paths[n]) == PARALLEL_EVAL_VIDEOS,
              f"(c) cli.{name}: {stats}")
        with open(paths[n], "rb") as f:
            csv[n] = f.read()
    same = csv[world] == csv[1]
    # The resumed step-2 checkpoint, written by the ranks, serves on one.
    path = os.path.join(work, "parallel-resumed.csv")
    _, seconds["inference 1 of step 2"], stats = timed(
        "", serve, run, 1, PARALLEL_CLI_BATCH, path)
    check(stats["num_videos"] == PARALLEL_EVAL_VIDEOS
          and check_csv(path) == PARALLEL_EVAL_VIDEOS,
          f"(c) cli.inference of step 2 at one rank: {stats}")
    say("parallel", f"(c) the flagship through the CLIs at {world} ranks "
                    + ("over NCCL" if cards > 1 else "sharing the card over "
                       "gloo")
                    + f" (--fsdp_min_size={FSDP_MIN_SIZE}): losses "
                    f"{[round(x, 4) for x in losses]}; eval of step 1 GAP "
                    f"{metrics['gap']:.5f} Hit@1 "
                    f"{metrics['avg_hit_at_one']:.5f} mAP {mean_ap:.5f}; "
                    f"the CSV byte for byte the one-rank run's at "
                    f"{PARALLEL_CLI_BATCH // world} a batch: {same}; step 2 "
                    f"served on one rank; seconds " + json.dumps(
                        {k: round(v, 1) for k, v in seconds.items()}))
    check(same, "(c) the CSV at several ranks is not the one-rank CSV")
    return {"world": world, "seconds": seconds, "losses": losses}


def parallel_phase(torch, dev, work) -> dict:
    """Phase 10: (a) alone (its step times and peaks), then (b) and (c)
    together: their ranks share the card; then the tensor-parallel (d)
    and (e) together, (e) on (c)'s data."""
    out = {"one_rank_a_card": parallel_one_rank_a_card(torch, dev)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        workflow = pool.submit(parallel_workflow, torch, dev, work)
        out["shared_card"] = parallel_shared_card(torch, dev, work)
        out["workflow"] = workflow.result()
    say("parallel", f"(b) and (c) together in "
                    f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        tp_cli = pool.submit(tp_workflow, torch, dev, work)
        out["tp_shared_card"] = parallel_tp_shared_card(torch, dev, work)
        out["tp_workflow"] = tp_cli.result()
    out["tp_seconds"] = time.perf_counter() - t0
    say("parallel", f"(d) and (e) together in {out['tp_seconds']:.1f} s")
    return out


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
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            say("ptxas", line.strip())
    _build.library()

    phase_s = {"card and build": time.perf_counter() - T0}
    mark = time.perf_counter()

    def phase_done(name):
        nonlocal mark
        now = time.perf_counter()
        phase_s[name] = now - mark
        mark = now
        say("phase", f"{name}: {phase_s[name]:.1f} s")

    gen = torch.Generator().manual_seed(1234)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for fn in (check_dbof, check_moe, check_topk, check_netvlad, check_lstm,
               check_lstm_train, check_netvlad_core, check_gru,
               check_gru_train, check_attention_pool, check_nextvlad,
               check_nextvlad_train, check_dbof_int8, check_dbof_v1,
               check_dbof_sampled, check_dequant_matmul):
        row = fn(torch, gen, dev, flush)
        say_row("(kernels line)", row)
        rows.append(row)
        torch.cuda.empty_cache()
    # The f32 routes draw from their own generator: the phases after them
    # keep their inputs.
    f32_rows = check_f32_routes(torch, torch.Generator().manual_seed(2020),
                                dev, flush)
    torch.cuda.empty_cache()
    new_shapes = check_new_shapes(torch, dev, flush)
    torch.cuda.empty_cache()
    del flush
    check_repaired_shapes(torch, gen, dev)
    torch.cuda.empty_cache()
    phase_done("3 kernels")

    from yt8m_tpu_torch.data.synthetic import write_dataset

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_",
                            dir=os.path.join(REPO, "build"))
    try:
        data = os.path.join(work, "data")
        write_dataset(data, "test", num_shards=2,
                      videos_per_shard=E2E_VIDEOS // 2, frame_level=True,
                      num_classes=CLASSES, seed=3)
        write_dataset(data, "video", num_shards=2,
                      videos_per_shard=E2E_VIDEOS // 2, frame_level=False,
                      num_classes=CLASSES, seed=4)
        say("e2e", f"wrote {E2E_VIDEOS} frame-level and {E2E_VIDEOS} "
                   f"video-level videos, 2 shards each")
        e2e = {name: end_to_end(torch, dev, data, name) for name in PATHS}
    finally:
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()
    say("e2e", "the rest of the zoo through cli.inference, seconds a run: "
               + ", ".join(f"{n} {e2e[n]['cli_s']:.1f}" for n in ZOO_PATHS))
    phase_done("4 serving end to end")
    bf16_step = profile_step(torch, dev, "DbofModel", BATCH)
    int8_step = profile_step(torch, dev, "DbofModel --dbof_int8_serving",
                             BATCH)
    f32_step = profile_step(torch, dev, f"DbofModel {F32}", BATCH)
    say("step", f"DbofModel B={BATCH} serving step in one call: bf16 "
                f"{bf16_step['step_ms']:.3f} ms, --dbof_int8_serving "
                f"{int8_step['step_ms']:.3f} ms, {F32} "
                f"{f32_step['step_ms']:.3f} ms")
    steps = [bf16_step, int8_step, f32_step] + [
        profile_step(torch, dev, name, FLAG_BATCH)
        for name in ("NetVladLstmModel", "GruModel", "AttentionPoolingModel",
                     "NeXtVladModel")]
    # The f32 steps of rows 8 and 14's 3xTF32 routes (the flagship's LSTM
    # on its scan graph, as the JAX model at f32).
    f32_steps = {name: profile_step(torch, dev, f"{name} {F32}", FLAG_BATCH)
                 for name in ("NetVladLstmModel", "AttentionPoolingModel")}
    say("step", f"{F32} serving steps at B={FLAG_BATCH}: " + ", ".join(
        f"{n} {r['step_ms']:.3f} ms" for n, r in f32_steps.items()))
    steps += list(f32_steps.values())
    zoo_steps = {name: profile_step(torch, dev, name,
                                    BATCH if "Dbof" in name else FLAG_BATCH)
                 for name in ZOO_PATHS}
    say("step", "the rest of the zoo, serving step ms: " + ", ".join(
        f"{n} (B={BATCH if 'Dbof' in n else FLAG_BATCH}) "
        f"{r['step_ms']:.3f}" for n, r in zoo_steps.items()))
    steps += list(zoo_steps.values())
    phase_done("5 serving steps")
    training = train_flagship(torch, dev)
    fused = train_flagship(torch, dev, fused=True)
    say("train", f"NetVladLstmModel B={TRAIN_BATCH} training step in one "
                 f"call: plain VLAD graph {training['step_ms']:.3f} ms, peak "
                 f"{training['peak_gib']:.2f} GiB; --netvlad_fused_train "
                 f"{fused['step_ms']:.3f} ms, peak {fused['peak_gib']:.2f} "
                 f"GiB")
    train_dbof(torch, dev)
    dbof_f32 = train_dbof(torch, dev, "float32")
    train_card_vs_cpu(torch, dev)
    gru_training = train_gru(torch, dev)
    train_card_vs_cpu(torch, dev, make_gru_model, "GruModel")
    train_attention(torch, dev)
    nextvlad_training = train_nextvlad(torch, dev)
    train_card_vs_cpu(torch, dev, make_nextvlad_model, "NeXtVladModel")
    zoo_training = [train_zoo(torch, dev, "ChainNetVladModel"),
                    train_zoo(torch, dev, "ChainNetVladModel", fused=True),
                    train_zoo(torch, dev, "DeepCombineChainModel"),
                    train_zoo(torch, dev, "NetFVModel"),
                    train_zoo(torch, dev, "FrameCnnModel")]
    wide_training = train_wide_flagship(torch, dev)
    wide_nextvlad = train_wide_nextvlad(torch, dev)
    optimizers = train_optimizers(torch, dev)
    optimizers_cmp = optimizers_card_vs_cpu(torch, dev)
    say("train", f"DbofModel f32 step {dbof_f32['step_ms']:.3f} ms; "
                 "optimizers, step ms and state x Adam f32's: " + ", ".join(
                     f"{k} {r['step_ms']:.3f} / {r['state_vs_adam']:.4f}"
                     for k, r in optimizers.items())
        + f"; card vs CPU moves within {max(optimizers_cmp.values()):.3e}")
    phase_done("6 training")
    work = tempfile.mkdtemp(prefix="chip_smoke_workflow_",
                            dir=os.path.join(REPO, "build"))
    try:
        default = default_workflow(torch, dev, work)
        data = workflow_data(work)
        workflow = cli_workflow(torch, dev, work, data)
        gru_want = 2 * GRU_LAYERS  # 2 steps, one launch a layer each way
        short_runs = [
            short_workflow(torch, dev, work, data, "GruModel",
                           [f"--gru_cells={GRU_CELLS}",
                            f"--gru_layers={GRU_LAYERS}"],
                           {"gru_train_forward": gru_want,
                            "gru_train_backward": gru_want},
                           ("exact_topk", "gru_recurrence",
                            "moe_head_serving")),
            short_workflow(torch, dev, work, data, "NeXtVladModel",
                           [f"--nextvlad_expansion={NEXTVLAD_LAMBDA}",
                            f"--nextvlad_groups={NEXTVLAD_GROUPS}",
                            f"--nextvlad_cluster_size={NEXTVLAD_CLUSTERS}",
                            f"--nextvlad_hidden_size={NEXTVLAD_HIDDEN}"],
                           {"nextvlad_train_forward": 2,
                            "nextvlad_train_backward": 2,
                            "nextvlad_aggregate": 0},
                           ("exact_topk", "nextvlad_aggregate",
                            "moe_head_serving")),
            short_workflow(torch, dev, work, data, "DbofModel", [],
                           {"dbof_cluster_maxpool_v2": 0},
                           ("exact_topk", "dbof_cluster_maxpool_int8",
                            "moe_head_serving"),
                           serve_flags=("--dbof_int8_serving",),
                           serve_absent=("dbof_cluster_maxpool_v2",)),
            short_workflow(torch, dev, work, data, "ChainNetVladModel",
                           ["--netvlad_fused_train"],
                           {"netvlad_core_forward": 2,
                            "netvlad_core_backward": 2,
                            "moe_head_serving": 0},
                           ("exact_topk", "netvlad_aggregate",
                            "moe_head_serving")),
        ]
        adafactor = optimizer_workflow(torch, dev, work, data)
        async_run = async_workflow(torch, dev, work, data)
        phase_done("7 workflows")
        readers = reader_phase(torch, dev, work)
        ensembles = ensemble_workflow(torch, dev, work, data)
        phase_done("8 readers and the ensemble workflow")
        exports = export_phase(torch, dev, work, data)
        parity_phase(work, data)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_done("9 export and parity")
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_",
                            dir=os.path.join(REPO, "build"))
    try:
        parallel = parallel_phase(torch, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    phase_done("10 multi-GPU")
    # Launches on the main paths: DBoF's on the DbofModel serving path,
    # the int8 DBoF's on DbofModel's with --dbof_int8_serving (DBoF v1,
    # the sampled DBoF and dequant_affine_matmul lie on no model's path,
    # in the JAX package as here: their counts summed over every path's
    # run must be 0), the GRU's, attention pooling's and NeXtVLAD's on
    # GruModel's, AttentionPoolingModel's and NeXtVladModel's serving
    # paths, the
    # trainable LSTM's, GRU's (forward and backward launches) and
    # NeXtVLAD's on the flagship's, GruModel's and NeXtVladModel's
    # training paths, netvlad_core's on the train CLI's two runs of the
    # workflow (2 + 2 steps), the others on the flagship's serving path,
    # whose shapes their rows were measured at.
    serving_path = {"dbof_cluster_maxpool_v2": "DbofModel",
                    "dbof_cluster_maxpool_int8":
                        "DbofModel --dbof_int8_serving",
                    "gru_recurrence": "GruModel",
                    "attention_pool": "AttentionPoolingModel",
                    "nextvlad_aggregate": "NeXtVladModel"}
    trained = {"lstm_recurrence_trainable": (training, "lstm_train"),
               "gru_recurrence_trainable": (gru_training, "gru_train"),
               "nextvlad_aggregate_train": (nextvlad_training,
                                            "nextvlad_train")}
    path_runs = [r["launches"] for r in (*e2e.values(), *steps, training,
                                         fused, gru_training,
                                         nextvlad_training, *zoo_training,
                                         wide_training, wide_nextvlad)]
    for run in (default, workflow, *short_runs, adafactor, ensembles):
        path_runs += list(run["launches"].values())
    served = ensembles["launches"]["serve ensemble"]
    student = ensembles["launches"]["train student"]
    for row in rows:
        if row["name"] in trained:
            run, prefix = trained[row["name"]]
            fwd = run["launches"][f"{prefix}_forward"]
            bwd = run["launches"][f"{prefix}_backward"]
            row.update(launches=fwd + bwd, launches_forward=fwd,
                       launches_backward=bwd)
            if prefix == "lstm_train":
                row["launches_by_path"] = {
                    "distilled student": student["lstm_train_forward"]
                    + student["lstm_train_backward"]}
            continue
        if row["name"] == "netvlad_core":
            runs = [v for k, v in workflow["launches"].items()
                    if k.startswith("train")]
            fwd = sum(r["netvlad_core_forward"] for r in runs)
            bwd = sum(r["netvlad_core_backward"] for r in runs)
            wide = wide_training["launches"]
            row.update(launches=fwd + bwd, launches_forward=fwd,
                       launches_backward=bwd, launches_by_path={
                           "distilled student": student["netvlad_core_forward"]
                           + student["netvlad_core_backward"],
                           f"{WIDE_FLAGSHIP} training":
                               wide["netvlad_core_forward"]
                               + wide["netvlad_core_backward"]})
            continue
        if row.get("on_main_path") is False:
            row["launches"] = sum(r.get(row["name"], 0) for r in path_runs)
            check(row["launches"] == 0,
                  f"{row['name']} launched {row['launches']} times on the "
                  f"paths: its row must read the path that launches it")
            continue
        path = serving_path.get(row["name"], "NetVladLstmModel")
        row["launches"] = e2e[path]["launches"][row["name"]]
        # Each serving path's launches of this kernel in its CLI run
        # (E2E_VIDEOS videos in batches of E2E_BATCH).
        row["launches_by_path"] = {
            p: r["launches"][row["name"]] for p, r in e2e.items()
            if r["launches"][row["name"]]}
        if served.get(row["name"]):
            row["launches_by_path"]["DbofModel + NetVladLstmModel "
                                    "ensemble"] = served[row["name"]]
    # The f32 routes (--compute_dtype=float32): their numbers from phase 3
    # and their launches on the f32 serving paths of phase 4 (the f32
    # DbofModel's for DBoF v2 and the MoE head, the f32 flagship's for
    # NetVLAD, the f32 AttentionPoolingModel's for attention pooling).
    f32_main = {"dbof_cluster_maxpool_v2": f"DbofModel {F32}",
                "moe_head_serving": f"DbofModel {F32}",
                "netvlad_aggregate": f"NetVladLstmModel {F32}",
                "attention_pool": f"AttentionPoolingModel {F32}"}
    for row in rows:
        if row["name"] in f32_rows:
            key = f"{row['name']}:f32"
            r = dict(f32_rows[row["name"]])
            r["launches"] = e2e[f32_main[row["name"]]]["launches"][key]
            r["launches_by_path"] = {p: e2e[p]["launches"][key]
                                     for p in F32_PER_BATCH
                                     if e2e[p]["launches"][key]}
            check(r["launches"] > 0, f"{row['name']}: its f32 route was not "
                                     f"launched on {f32_main[row['name']]}")
            row["compute_f32"] = r
    # Phase 10's data-parallel and FSDP steps launch the trainable LSTM
    # and netvlad_core on every rank (rank 0's counts here).
    # Phase 10's tensor-parallel steps (d) launch them on both ranks
    # sharing the card (rank 0's counts here).
    rank0 = parallel["one_rank_a_card"]["ranks"][0]
    modes = [m for m, _, _ in parallel_modes(rank0["world"])]
    tp0 = parallel["tp_shared_card"]["NetVladLstmModel"]["launches"][0]
    for row in rows:
        prefix = {"netvlad_core": "netvlad_core",
                  "lstm_recurrence_trainable": "lstm_train"}.get(row["name"])
        if prefix:
            row["launches_by_path"][
                f"{' + '.join(modes)} training, rank 0 of "
                f"{rank0['world']}"] = sum(
                    rank0[m]["launches"][f"{prefix}_{d}"]
                    for m in modes for d in ("forward", "backward"))
            row["launches_by_path"][
                f"tensor-parallel training (--model_parallel={TP_RANKS}), "
                f"rank 0 of {TP_RANKS} sharing the card"] = sum(
                    tp0[f"{prefix}_{d}"] for d in ("forward", "backward"))
    # The shapes past the old limits (phase 3), each with its numbers.
    for row in rows:
        if row["name"] in new_shapes:
            row["new_shapes"] = new_shapes[row["name"]]
    say("workflow", f"--async_checkpoint: mid-run saves held the training "
                    f"thread {async_run['mid_run_median_s']['async']:.3f} s "
                    f"(median), synchronous "
                    f"{async_run['mid_run_median_s']['sync']:.3f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("launches_forward", "launches_backward", "ms_forward",
             "ms_backward", "us_per_step_forward", "us_per_step_backward",
             "ms_backward_with_dx", "device_ms_forward",
             "device_ms_backward", "us_per_step", "ms_reverse", "device_ms",
             "barrier_ms", "barrier_share", "barrier_share_forward",
             "barrier_share_backward", "ms_events",
             "ms_events_f32", "on_main_path", "int8_vs_bf16",
             "ms_gather_then_v2", "max_abs_err_f32", "ms_f32", "plain_ms_f32",
             "bound_ms_f32", "bound_by_f32", "library_ms_f32",
             "launches_by_path", "compute_f32", "new_shapes")
    say("phase", "seconds: " + json.dumps(
        {k: round(v, 1) for k, v in phase_s.items()}))
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
