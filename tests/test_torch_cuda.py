"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports nothing of JAX, so that it runs on a machine with the
card and without JAX; skip the JAX-importing conftest there:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: DBoF and MoE max|diff| <= 1e-3 * max|ref| + 1e-6 — both
sides round the same operands to bf16, only the summation order differs;
top-k values and indices exactly equal. NetVLAD: max|diff| <= 2^-8 *
max|ref| + 1e-6 — the assignment is rounded to bf16 after a softmax whose
f32 sums run in another order on the two sides, so a value at a rounding
boundary can land one bf16 step (2^-8 relative) apart and move one
frame's term of a cluster row, which the intra-normalisation carries
into the row. LSTM: max|diff| <= 2e-2 * max(1, max|ref|) — both sides
round h to bf16 before every step's product, so where the f32 sums
differ in their last bits a rounding can land one bf16 step (2^-8
relative) apart and that step is carried into the following steps; 2e-2
is the JAX package's own bound for its kernel against its scan
(tests/test_kernels.py::test_lstm_recurrence_matches_scan).
Planted hazards (padded frames or steps past num_frames set to large
values, num_frames 0) must give results equal to the clean inputs'.
The trainable LSTM (forward residuals, dZ and the gradients) has the
LSTM's bound for the same cause; the witness tests show it on the card:
fed the kernel's own bf16 stream one step at a time, the plain cell
rounds to the kernel's value but for a few values in 1e4, those differ
at bf16 rounding boundaries (the median plain value lies within 2^-14
of itself from the midpoint), what one bf16 step does not explain is
under 1e-3 * max|ref|, and the f32 final state meets 1e-3 * max|ref| +
1e-6. Some values differ by more than one bf16 step: small ones, where
the f32 sums nearly cancel and their order moves the small result by
more than one of its steps; the witness counts them and bounds them
only through the 1e-3 remainder. A training step on the card and on the
CPU from the same weights and batch: loss within 2e-3 relative, each
parameter's gradient norm within 2e-2 relative (the LSTM bound: the
recurrence carries one-step bf16 rounding differences).
The GRU, serving and trainable, has the LSTM's bound for the same cause
(it rounds h and r * h before its two products, and dA before the
backward's); its witness runs the serving kernel one step at a time (every
row taken as live, the freeze applied outside) and feeds the plain cell
the kernel's own state: u and the f32 h meet 1e-3 *
max|ref| + 1e-6, bf16(r * h) and the outputs differ only at bf16
rounding boundaries, and so do the trainable forward's residuals and the
backward's dA on their streams. Attention pooling: max|diff| <= 1e-3 *
max|ref| + 1e-5 (x, Q and the attention are rounded to bf16 on both
sides; the softmax's f32 sums run in another order) at the edge shapes
and with f32 frames; uint8 frames at the serving shape are held to the
limit attention_pool.rounding_limit derives for each draw (an attention
weight in [0.5, 1) at a rounding boundary, one bf16 step apart, moves
the output 2^-9 |x|, past the fixed bound on some draws); frames past
num_frames change nothing; num_frames = 0 is the mean over the F rows.
NeXtVLAD, serving and trainable (the output and the five weight
gradients): max|diff| <= 2^-7 * max|ref| + 1e-6 — x, xe and the
assignment (and in the backward dv, d_act and d_xe) are rounded to bf16
on both sides after f32 sums that run in another order, so a value at a
rounding boundary lands one bf16 step (2^-8 to 2^-7 of itself) apart,
and an xe value or assignment that dominates an element of a short
video's intra-normalised row moves the element by up to that share of
itself; the witness tests show that the plain steps fed the kernel's own
bf16 streams differ only at rounding boundaries and that what follows
them meets 1e-3 * max|ref| + 1e-6. The weight gradients are split-K sums
added in a fixed order: a second run gives the same bits.
The int8 DBoF kernel equals its plain version bit for bit: the integer
sums are exact on both sides (the plain version sums in float64); the
plain version converts each to f32 and applies the affine unfused, the
kernel the same to the sum it pools (a max, or a min where a_col < 0:
every step is monotone, so the two commute exactly). The
sampled DBoF kernel equals v2 on the gathered frames bit for bit (the
same affine rounding, the same product). DBoF v1 and dequant_affine_matmul
in bf16 (D >= 512): max|diff| <= 1e-3 * max|ref| + 1e-6, the DBoF bound;
dequant_affine_matmul in f32 (D < 512): <= 1e-5 * max|ref| + 1e-6 (f32
operands, only the summation order differs), at the old shapes and at
M, N and D that cut the redesigned tiles. The header's product in its
two added operand layouts (MN-major A, K-major B) and
csrc/hopper_product.cuh's product with its TMA-store epilogue: <= 1e-5 *
max|ref| + 1e-6 against torch.matmul in f32 on the same bf16 operands
(only the summation order differs). netvlad_core at K and F that cut
its tiles: the 1e-3 bound above, its hazards bit for bit.
The f32 routes (--compute_dtype=float32: DBoF v2, the MoE head, NetVLAD
and attention pooling with f32 weights) against their plain versions in
true f32 (TF32 off): max|diff| <= 1e-5 * max|ref| + 1e-5 (NetVLAD's
+ 1e-8; nothing is rounded to bf16 on either side: the kernels' 3xTF32
products split each operand in two TF32 halves, about 2^-21 of each
product, and sum in another order), at the serving shapes and at small,
odd and ragged ones; frames past num_frames change nothing; without the
weights' split copies the f32 routes refuse. The bf16 MoE head at any H (zero fill past
H): the DBoF bound.
"""

import numpy as np
import pytest
import torch

from yt8m_tpu_torch.cli import inference as cli
from yt8m_tpu_torch.convert import load_model, save_checkpoint
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.kernels import attention_pool as tap
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.kernels import dequant_matmul as tdq
from yt8m_tpu_torch.kernels import gru as tgru
from yt8m_tpu_torch.kernels import gru_train as tgt
from yt8m_tpu_torch.kernels import lstm as tlstm
from yt8m_tpu_torch.kernels import lstm_train as tlt
from yt8m_tpu_torch.kernels import moe_head as tmoe
from yt8m_tpu_torch.kernels import netvlad as tvlad
from yt8m_tpu_torch.kernels import netvlad_train as tnt
from yt8m_tpu_torch.kernels import nextvlad as tnv
from yt8m_tpu_torch.kernels import nextvlad_train as tnvt
from yt8m_tpu_torch.kernels import topk as ttopk
from yt8m_tpu_torch.kernels.tf32 import split_weights
from yt8m_tpu_torch.kernels._schedule import live_pairs
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train.losses import get_loss
from yt8m_tpu_torch.train.step import compute_loss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return resolve_device("cuda")  # TF32 off for cuBLAS and cuDNN


def _close(got, want, rel=1e-3):
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    err = (got - want).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-6, err


def _vlad_close(got, want):
    _close(got, want, rel=2.0 ** -8)


def _lstm_close(got, want):
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    err = (got - want).abs().max().item()
    assert err <= 2e-2 * max(1.0, want.abs().max().item()), err


def _live_split(got, want, num_frames, reverse):
    """A trainable forward's residuals [F, B, X] on the card: exactly 0 on
    the frozen (video, step) pairs (the kernel computes live rows only;
    the plain version computes every step, and nothing reads a frozen
    step's gates); (got, want) on the live pairs."""
    live = live_pairs(num_frames, got.shape[0], reverse)
    assert torch.all(got[~live] == 0)
    return got[live], want[live]


def _residual_close(got, want, num_frames, reverse):
    """_live_split, then the plain version's values within the LSTM bound
    on the live pairs."""
    got, want = _live_split(got, want, num_frames, reverse)
    if got.numel():
        _lstm_close(got.float(), want.float())


def _dbof_args(seed, b, s, d, k, x_dtype, dev):
    g = torch.Generator().manual_seed(seed)
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, s, d), generator=g, dtype=torch.uint8)
        s_in = (4.0 / 255.0) * (0.5 + torch.rand(d, generator=g))
    else:
        x = torch.randn(b, s, d, generator=g)
        s_in = 0.5 + torch.rand(d, generator=g)
    w = (torch.randn(d, k, generator=g) * d ** -0.5).to(torch.bfloat16)
    b_in = 0.1 * torch.randn(d, generator=g)
    s_act = 0.5 + torch.rand(k, generator=g)
    b_act = 0.1 * torch.randn(k, generator=g)
    return [t.to(dev) for t in (x, w, s_in, b_in, s_act, b_act)]


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,s,d,k", [(7, 5, 64, 200), (9, 32, 96, 136),
                                     (5, 30, 1152, 8192), (1, 1, 32, 8),
                                     # cutting the TMA + wgmma tiles: B no
                                     # multiple of 4 or 128, K of 256, D
                                     # of 64; S in {1, 17, 30, 31, 32}
                                     (130, 31, 1152, 1000), (6, 1, 64, 264),
                                     (3, 32, 96, 8), (133, 30, 1152, 520),
                                     (9, 17, 160, 2056)])
def test_cuda_dbof_matches_plain(cuda, x_dtype, b, s, d, k):
    args = _dbof_args(b + k, b, s, d, k, x_dtype, cuda)
    before = tdbof.dbof_cluster_maxpool_v2.launches
    got = tdbof.dbof_cluster_maxpool_v2(*args)
    assert tdbof.dbof_cluster_maxpool_v2.launches == before + 1
    _close(got, tdbof.dbof_cluster_maxpool_plain(*args))


@pytest.mark.parametrize("s", [30, 1, 31, 32, 40])
def test_cuda_dbof_masks_padded_frames(cuda, s):
    """Every real row is negative before the ReLU; an unmasked zero
    padding row would give relu(act_bias) = 3. S past 32 runs in chunks
    of 32 frames, the last one short."""
    x, w, s_in, b_in, s_act, b_act = _dbof_args(0, 6, s, 64, 64,
                                                torch.uint8, cuda)
    w = torch.full_like(w, -1.0)
    got = tdbof.dbof_cluster_maxpool_v2(
        x, w, torch.ones_like(s_in), torch.ones_like(b_in), s_act,
        torch.full_like(b_act, 3.0))
    assert torch.all(got == 0)


def _moe_args(seed, b, h, c, m, dev):
    """Inputs of the MoE head; the weights as the pitched views the card
    path takes (MoeHead.make_serving_constants builds the same)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, generator=g).abs()
    wg = torch.randn(h, c * (m + 1), generator=g) * h ** -0.5
    we = torch.randn(h, c * m, generator=g) * h ** -0.5
    be = 0.1 * torch.randn(c * m, generator=g)
    return [x.to(dev), tmoe.pitched(wg.to(torch.bfloat16).to(dev)),
            tmoe.pitched(we.to(torch.bfloat16).to(dev)), be.to(dev)]


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("b,h,c", [(37, 64, 83), (70, 96, 44),
                                   (130, 1024, 4716), (512, 2048, 4716)])
def test_cuda_moe_matches_plain(cuda, m, b, h, c):
    args = _moe_args(b + c + m, b, h, c, m, cuda)
    before = tmoe.moe_head_serving.launches
    got = tmoe.moe_head_serving(*args, m)
    assert tmoe.moe_head_serving.launches == before + 1
    _close(got, tmoe.moe_head_plain(*args, m))


def test_cuda_moe_clamps_large_logits(cuda):
    x, wg, we, be = _moe_args(3, 16, 64, 40, 2, cuda)
    wg = tmoe.pitched((wg.float() * 400).to(torch.bfloat16))
    got = tmoe.moe_head_serving(x, wg, we, be, 2)
    assert torch.isfinite(got).all()
    _close(got, tmoe.moe_head_plain(x, wg, we, be, 2))


def _topk_rows(seed, b, c):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(b, c, generator=g)
    x[0, : c // 2] = x[0, 0]
    if b > 4:
        x[1, ::7] = float("nan")
        x[2, ::3] = float("-inf")
        x[3] = -3.4e38
        x[4, 1::2] = float("inf")
    return x


@pytest.mark.parametrize("b,c,k", [(3, 20, 20), (37, 301, 20),
                                   (5, 4716, 128), (8, 7, 1),
                                   (512, 4716, 20), (2048, 4716, 20),
                                   (512, 4716, 64), (6, 4715, 20),
                                   (6, 128, 128), (6, 130, 128)])
def test_cuda_topk_matches_plain_exactly(cuda, b, c, k):
    x = _topk_rows(b + c, b, c).to(cuda)
    before = ttopk.exact_topk.launches
    got_v, got_i = ttopk.exact_topk(x, k)
    assert ttopk.exact_topk.launches == before + 1
    want_v, want_i = ttopk.exact_topk_plain(x, k)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


def test_cuda_topk_above_the_kernel_bound(cuda):
    """exact_topk launches or raises: at k=129 it raises. serving_topk
    sends k > 128 to its library op (stable_sort_topk) and launches nothing."""
    x = _topk_rows(7, 4, 4716).to(cuda)
    before = ttopk.exact_topk.launches
    with pytest.raises(ValueError):
        ttopk.exact_topk(x, 129)
    got_v, got_i = ttopk.serving_topk(x, 200)
    assert ttopk.exact_topk.launches == before
    want_v, want_i = ttopk.exact_topk_plain(x.cpu(), 200)
    assert torch.equal(got_v.cpu(), want_v)
    assert torch.equal(got_i.cpu(), want_i)


def _signed_zero_rows(seed, b, c):
    """Rows of negative scores with +0.0 and -0.0 planted among them, in
    turns and in runs, across the top-k threshold."""
    g = torch.Generator().manual_seed(seed)
    x = -torch.rand(b, c, generator=g)
    x[0, ::2] = 0.0
    x[0, 1::2] = -0.0
    x[1, :40] = -0.0
    x[1, 40:80] = 0.0
    x[2, 100:] = -0.0
    x[3, 7] = 0.0
    x[3, 3] = -0.0
    x[3, 9] = 0.5
    return x


@pytest.mark.parametrize("k", [1, 20, 64, 128])
def test_cuda_topk_ties_signed_zeros_by_index(cuda, k):
    """-0.0 and +0.0 tie: the lower index first, each value with its own
    sign, as the plain version's stable sort on the CPU (the card's sort
    may order the two by their bits)."""
    x = _signed_zero_rows(k, 4, 4716)
    got_v, got_i = ttopk.exact_topk(x.to(cuda), k)
    want_v, want_i = ttopk.exact_topk_plain(x, k)
    assert torch.equal(got_v.cpu().view(torch.int32),
                       want_v.view(torch.int32))
    assert torch.equal(got_i.cpu(), want_i)


@pytest.mark.parametrize("c", [4716, 4715, 301])
def test_cuda_topk_plan_matches_the_kernel(cuda, c):
    """The compiled block is the one kernels/topk.py :: plan describes."""
    got = ttopk.kernel_plan(c)
    p = ttopk.plan(c, 20)
    assert got == {key: p[key] for key in ("threads", "span", "smem",
                                           "bins", "loads", "cand",
                                           "static_smem")}


def test_cuda_wrappers_reject_what_the_kernels_cannot_take(cuda):
    x = torch.zeros(2, 40, 64, dtype=torch.uint8, device=cuda)
    w = torch.zeros(64, 32, dtype=torch.bfloat16, device=cuda)
    v = torch.zeros(64, device=cuda)
    a = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):  # D = 48 is no multiple of 32
        tdbof.dbof_cluster_maxpool_v2(
            torch.zeros(2, 8, 48, dtype=torch.uint8, device=cuda), w[:48],
            v[:48], v[:48], a, a)
    with pytest.raises(ValueError):  # f16 weights: the kernels are bf16 or f32
        tdbof.dbof_cluster_maxpool_v2(x[:, :8].contiguous(), w.half(), v,
                                      v, a, a)
    with pytest.raises(ValueError):  # M = 0: no mixture
        tmoe.moe_head_serving(*_moe_args(0, 4, 32, 8, 1, cuda)[:3],
                              torch.zeros(0, device=cuda), 0)


def test_cuda_inference_matches_cpu(cuda, tmp_path):
    hp = ModelHParams(vocab_size=40, feature_dim=96, max_frames=20,
                      dbof_cluster_size=64, dbof_hidden_size=32,
                      iterations=8)
    data = str(tmp_path / "data")
    write_dataset(data, "test", num_shards=2, videos_per_shard=5,
                  frame_level=True, num_classes=40, seed=1, rgb_dim=64,
                  audio_dim=32, max_frames=20)
    model = get_model("DbofModel", hp)
    model.reset_parameters(torch.Generator().manual_seed(0))
    run = str(tmp_path / "run")
    save_checkpoint(run, model, "DbofModel", hp, frame_features=True,
                    feature_names="rgb,audio", feature_sizes="64,32",
                    num_classes=40, max_frames=20)
    rc = ReaderConfig("rgb,audio", "64,32", frame_features=True,
                      num_classes=40, max_frames=20)
    batch = next(iter(BatchIterator(f"{data}/test-*.tfrecord", rc,
                                    batch_size=8)))
    feats = torch.from_numpy(batch["features"])
    nf = torch.from_numpy(batch["num_frames"])
    u = torch.rand(8, hp.iterations,
                   generator=torch.Generator().manual_seed(1))
    gpu_model = load_model(run, "DbofModel", hp, cuda)
    with torch.inference_mode():
        want = model.eval()(feats, nf, u=u)["predictions"]
        got = gpu_model(feats.to(cuda), nf.to(cuda), u=u.to(cuda))
    _close(got["predictions"], want, rel=2e-3)
    stats = cli.main([f"--input_data_pattern={data}/test-*.tfrecord",
                      f"--train_dir={run}",
                      f"--output_file={tmp_path / 'g.csv'}",
                      "--batch_size=4", "--top_k=5", "--device=cuda"])
    assert stats["num_videos"] == 10 and stats["device"].startswith("cuda")


def _vlad_args(seed, b, f, d, k, x_dtype, dev):
    g = torch.Generator().manual_seed(seed)
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=g, dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=g)
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[0] = f
    if b > 2:
        nf[1] = 0
        nf[2] = 1
    wc = (torch.randn(d, k, generator=g) * d ** -0.5).to(torch.bfloat16)
    scale = 0.5 + torch.rand(k, generator=g)
    bias = 0.3 * torch.randn(k, generator=g)
    centers = torch.randn(k, d, generator=g) * d ** -0.5
    return [t.to(dev) for t in (x, nf, wc, scale, bias, centers)]


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,f,d,k", [(5, 13, 128, 8), (4, 70, 256, 136),
                                     (3, 300, 1152, 256), (1, 1, 128, 64),
                                     (3, 130, 256, 512), (4, 70, 256, 264)])
def test_cuda_netvlad_matches_plain(cuda, x_dtype, b, f, d, k):
    args = _vlad_args(b + f + k, b, f, d, k, x_dtype, cuda)
    before = tvlad.netvlad_aggregate.launches
    got = tvlad.netvlad_aggregate(*args)
    assert tvlad.netvlad_aggregate.launches == before + 1
    want = tvlad.netvlad_aggregate_plain(*args)
    _vlad_close(got, want)
    if b > 2:
        assert torch.all(got[1] == 0)  # num_frames 0: zeros, not NaN


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_netvlad_hazards(cuda, x_dtype):
    """Frames past num_frames set to large values do not leak; a cluster
    no frame is assigned to gives an exact zero row."""
    x, nf, wc, scale, bias, centers = _vlad_args(7, 6, 300, 1152, 256,
                                                 x_dtype, cuda)
    bias[5] = -1e4
    clean, loud = x.clone(), x.clone()
    for i, n in enumerate(nf.tolist()):
        clean[i, n:] = 0
        loud[i, n:] = 255 if x_dtype == torch.uint8 else 1e4
    got = tvlad.netvlad_aggregate(loud, nf, wc, scale, bias, centers)
    assert torch.equal(
        got, tvlad.netvlad_aggregate(clean, nf, wc, scale, bias, centers))
    assert torch.all(got[:, 5] == 0) and torch.isfinite(got).all()
    _vlad_close(got, tvlad.netvlad_aggregate_plain(loud, nf, wc, scale,
                                                   bias, centers))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_netvlad_differs_only_by_assignment_rounding(cuda, x_dtype):
    """Why the NetVLAD bound is 2^-8: the kernel's bf16 assignment and
    bf16 of the plain f32 assignment differ, where they do, by one bf16
    step; on the kernel's own frames, assignment and column sums the
    plain remainder meets 1e-3 * max|ref| + 1e-6."""
    args = _vlad_args(11, 6, 300, 1152, 256, x_dtype, cuda)
    out, xb, ka, colsum = tvlad.netvlad_aggregate_with_scratch(*args)
    assert torch.all(ka[:, 300:] == 0)
    ka = ka[:, :300]
    _, pa = tvlad.netvlad_assign_plain(*args[:5])
    differ = ka != pa.to(torch.bfloat16)
    kd = ka[differ].float()
    pd = pa[differ].to(torch.bfloat16).float()
    lo, hi = torch.minimum(kd, pd), torch.maximum(kd, pd)
    assert torch.all((lo > 0) & (hi - lo <= 2.0 ** -7 * lo))
    tail = tvlad.netvlad_residuals_plain(ka.float(), colsum.sum(1),
                                         xb.float(), args[5])
    _close(out, tail, rel=1e-3)


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("k", [256, 512])
def test_cuda_netvlad_touches_only_live_chunks(cuda, x_dtype, k):
    """The kernel writes its bf16 frames, assignment and column sums on
    the live 64-frame chunks only (scratch filled with NaN first stays
    NaN on every other chunk), zeros from num_frames to the chunk's end,
    and the same output as with zeroed scratch."""
    args = _vlad_args(5, 9, 300, 256, k, x_dtype, cuda)
    nf = args[1]
    nan = float("nan")
    out, xb, ka, colsum = tvlad._launch(
        *args, lambda shape, dtype, device: torch.full(
            shape, nan, dtype=dtype, device=device))
    chunk = torch.arange(300, device=cuda) // 64
    live_chunk = chunk[None, :] < (nf[:, None] + 63) // 64
    written = ~torch.isnan(ka.float()).all(-1)
    assert torch.equal(written, live_chunk)
    assert torch.equal(~torch.isnan(xb.float()).all(-1), live_chunk)
    past = torch.arange(300, device=cuda)[None, :] >= nf[:, None]
    assert torch.all(ka[live_chunk & past] == 0)
    assert torch.all(xb[live_chunk & past] == 0)
    c = torch.arange(5, device=cuda)
    assert torch.equal(~torch.isnan(colsum).all(-1),
                       c[None, :] < (nf[:, None] + 63) // 64)
    assert torch.equal(out, tvlad.netvlad_aggregate(*args))


def test_cuda_netvlad_plans_match_the_kernel(cuda):
    """The compiled launches' tiles are the ones kernels/netvlad.py ::
    plan describes."""
    got = tvlad.kernel_plan()
    assert got["chunk"] == tvlad.FRAME_CHUNK
    for k, key in ((128, "128"), (256, "256"), (512, "split")):
        for dt, name in ((torch.float32, "f32"), (torch.uint8, "u8")):
            p = tvlad.plan(512, 300, 1152, k, dt, sms=got["sms"])
            assert got[f"smem_{name}_{key}"] == p["assign_smem"]
    p = tvlad.plan(512, 300, 1152, 256, sms=got["sms"])
    assert got["assign_stages"] == p["assign_stages"]
    assert (got["agg_clusters"], got["agg_cols"], got["agg_stages"],
            got["agg_smem"]) == (tvlad.AGG_CLUSTERS, tvlad.D_TILE,
                                 p["agg_stages"], p["agg_smem"])
    # The f32 route's.
    for k in (128, 256):
        for dt, name in ((torch.float32, "f32"), (torch.uint8, "u8")):
            p = tvlad.plan(512, 300, 1152, k, dt, sms=got["sms"], f32=True)
            assert got[f"f32_smem_{name}_{k}"] == p["assign_smem"]
    p = tvlad.plan(512, 300, 1152, 256, sms=got["sms"], f32=True)
    assert got["f32_assign_stages"] == p["assign_stages"]
    assert (got["f32_clusters"], got["f32_agg_frames"],
            got["f32_agg_smem"]) == (tvlad.F32_CLUSTERS, p["agg_frames"],
                                     p["agg_smem"])


def _lstm_args(seed, f, b, h, dev):
    g = torch.Generator().manual_seed(seed)
    xp = (0.5 * torch.randn(f, b, 4 * h, generator=g)).to(torch.bfloat16)
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[0] = f
    if b > 2:
        nf[1] = 0
        nf[2] = 1
    wh = (torch.randn(h, 4 * h, generator=g) * h ** -0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn(4 * h, generator=g)
    return [t.to(dev) for t in (xp, nf, wh, bias)]


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
@pytest.mark.parametrize("f,b,h", [(13, 5, 64), (40, 130, 192),
                                   (300, 512, 1024), (1, 1, 64)])
def test_cuda_lstm_matches_plain(cuda, reverse, f, b, h):
    args = _lstm_args(f + b + h, f, b, h, cuda)
    before = tlstm.lstm_recurrence.launches
    outs, (c, hs) = tlstm.lstm_recurrence(*args, reverse=reverse)
    assert tlstm.lstm_recurrence.launches == before + 1
    w_outs, (w_c, w_h) = tlstm.lstm_recurrence_plain(*args, reverse=reverse)
    _lstm_close(outs, w_outs)
    _lstm_close(c, w_c)
    _lstm_close(hs, w_h)
    if b > 2:
        assert torch.all(outs[:, 1] == 0) and torch.all(c[1] == 0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_lstm_frozen_carry_ignores_steps_past_num_frames(cuda,
                                                              reverse):
    xp, nf, wh, bias = _lstm_args(3, 300, 64, 1024, cuda)
    clean, loud = xp.clone(), xp.clone()
    sign = torch.where(torch.arange(xp.shape[2], device=cuda) % 2 == 0,
                       1e4, -1e4).to(torch.bfloat16)
    for i, n in enumerate(nf.tolist()):
        t = slice(0, 300 - n) if reverse else slice(n, 300)
        clean[t, i] = 0
        loud[t, i] = sign
    a = tlstm.lstm_recurrence(clean, nf, wh, bias, reverse=reverse)
    b = tlstm.lstm_recurrence(loud, nf, wh, bias, reverse=reverse)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1][0], b[1][0]) and torch.equal(a[1][1], b[1][1])


def test_cuda_new_wrappers_reject_what_the_kernels_cannot_take(cuda):
    x, nf, wc, scale, bias, centers = _vlad_args(0, 2, 8, 128, 64,
                                                 torch.float32, cuda)
    with pytest.raises(ValueError):  # f16 weights: the kernels are bf16 or f32
        tvlad.netvlad_aggregate(x, nf, wc.half(), scale, bias, centers)
    with pytest.raises(ValueError):  # int64 frame counts
        tvlad.netvlad_aggregate(x, nf.long(), wc, scale, bias, centers)
    with pytest.raises(ValueError):  # f64 centers
        tvlad.netvlad_aggregate(x, nf, wc, scale, bias, centers.double())
    xp, nf, wh, bias = _lstm_args(0, 4, 3, 64, cuda)
    with pytest.raises(ValueError):  # non-contiguous x_proj
        tlstm.lstm_recurrence(xp.transpose(0, 1), nf, wh, bias)
    with pytest.raises(ValueError):  # f32 x_proj: the kernel takes bf16
        tlstm.lstm_recurrence(xp.float(), nf, wh, bias)
    with pytest.raises(ValueError):  # int64 frame counts
        tlstm.lstm_recurrence(xp, nf.long(), wh, bias)


@pytest.mark.parametrize("name,sampled", [
    ("NetVladLstmModel", 0), ("NetVladBiLstmModel", 0), ("NetVladModel", 0),
    ("GatedNetVladModel", 0), ("GatedNetVladModel", 8)])
def test_cuda_netvlad_models_match_cpu(cuda, name, sampled):
    hp = ModelHParams(vocab_size=40, feature_dim=128, max_frames=30,
                      netvlad_cluster_size=64, netvlad_hidden_size=96,
                      lstm_cells=128, lstm_layers=2,
                      netvlad_sample_frames=sampled)
    model = get_model(name, hp)
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feats = torch.randint(0, 256, (9, 30, 128), generator=g,
                          dtype=torch.uint8)
    nf = torch.tensor([30, 0, 1, 7, 29, 30, 12, 3, 18], dtype=torch.int32)
    u = torch.rand(9, max(sampled, 1), generator=g)
    launches = (tvlad.netvlad_aggregate.launches,
                tlstm.lstm_recurrence.launches)
    with torch.inference_mode():
        want = model.eval()(feats, nf, u=u)["predictions"]
        got = model.to(cuda)(feats.to(cuda), nf.to(cuda),
                             u=u.to(cuda))["predictions"]
    assert tvlad.netvlad_aggregate.launches == launches[0] + 1
    layers = 2 * (2 if "Bi" in name else 1) if "Lstm" in name else 0
    assert tlstm.lstm_recurrence.launches == launches[1] + layers
    assert torch.isfinite(got).all()
    _close(got, want, rel=2e-3)


# ---------------------------------------------------------------------------
# Shapes the kernels took only on the CPU before: each runs its kernel.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", range(1, 17))
@pytest.mark.parametrize("b,h,c", [(37, 64, 83), (130, 1024, 4716),
                                   (131, 96, 83)])
def test_cuda_moe_more_mixtures(cuda, m, b, h, c):
    args = _moe_args(b + c + m, b, h, c, m, cuda)
    before = tmoe.moe_head_serving.launches
    got = tmoe.moe_head_serving(*args, m)
    assert tmoe.moe_head_serving.launches == before + 1
    _close(got, tmoe.moe_head_plain(*args, m))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_dbof_more_than_32_frames(cuda, x_dtype):
    """iterations = 64: two launches of 32 frames, max of the maxes."""
    args = _dbof_args(5, 9, 64, 1152, 1024, x_dtype, cuda)
    before = tdbof.dbof_cluster_maxpool_v2.launches
    got = tdbof.dbof_cluster_maxpool_v2(*args)
    assert tdbof.dbof_cluster_maxpool_v2.launches == before + 2
    _close(got, tdbof.dbof_cluster_maxpool_plain(*args))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("d,k", [(1152, 100), (256, 512), (1000, 256)])
def test_cuda_netvlad_more_shapes(cuda, x_dtype, d, k):
    """K no multiple of 8, K = 512 (two cluster tiles), D no multiple of
    128: padded or tiled, exact."""
    args = _vlad_args(d + k, 5, 70, d, k, x_dtype, cuda)
    before = tvlad.netvlad_aggregate.launches
    got = tvlad.netvlad_aggregate(*args)
    assert tvlad.netvlad_aggregate.launches == before + 1
    assert got.shape == (5, k, d) and torch.all(got[1] == 0)
    _vlad_close(got, tvlad.netvlad_aggregate_plain(*args))


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_lstm_units_not_a_multiple_of_64(cuda, reverse):
    args = _lstm_args(3, 40, 130, 96, cuda)
    before = tlstm.lstm_recurrence.launches
    outs, (c, hs) = tlstm.lstm_recurrence(*args, reverse=reverse)
    assert tlstm.lstm_recurrence.launches == before + 1
    w_outs, (w_c, w_h) = tlstm.lstm_recurrence_plain(*args, reverse=reverse)
    for g, w in ((outs, w_outs), (c, w_c), (hs, w_h)):
        _lstm_close(g, w)


# ---------------------------------------------------------------------------
# The trainable LSTM recurrence.
# ---------------------------------------------------------------------------


def _cotangents(seed, f, b, h, dev):
    g = torch.Generator().manual_seed(seed)
    return [t.to(dev) for t in (torch.randn(f, b, h, generator=g),
                                torch.randn(b, h, generator=g),
                                torch.randn(b, h, generator=g))]


def _train_grads(args, cot, reverse):
    xp, nf, wh, bias = args
    x = xp.clone().requires_grad_()
    w = wh.float().requires_grad_()
    b = bias.clone().requires_grad_()
    outs, (fc, fh) = tlt.lstm_recurrence_trainable(x, nf, w, b, reverse)
    dout, dfc, dfh = cot
    loss = (outs * dout).sum() + (fc * dfc).sum() + (fh * dfh).sum()
    loss.backward()
    return outs, fc, fh, x.grad, w.grad, b.grad


def _plain_grads(args, cot, reverse):
    """The plain forward, backward and weight gradients on the same
    device: (outs, c, h, dx_proj, dW_h, db)."""
    xp, nf, wh, bias = args
    outs, gates, cs, c, h = tlt.lstm_train_forward_plain(xp, nf, wh, bias,
                                                         reverse)
    dz = tlt.lstm_train_backward_plain(*cot, gates, cs, nf, wh, reverse)
    dwh, db = tlt.weight_grads(outs, dz)
    return outs.float(), c, h, dz.float(), dwh, db


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
@pytest.mark.parametrize("f,b,h", [(13, 5, 64), (40, 130, 192),
                                   (300, 256, 1024), (7, 9, 96)])
def test_cuda_lstm_trainable_matches_plain(cuda, reverse, f, b, h):
    """Forward, residuals and dZ against the plain versions on the same
    inputs; the Function's outputs and gradients against the plain
    forward, backward and weight gradients."""
    args = _lstm_args(f + b + h, f, b, h, cuda)
    dout, dfc, dfh = _cotangents(h, f, b, h, cuda)
    if h % 64 == 0:
        got = tlt.lstm_train_forward(*args, reverse)
        want = tlt.lstm_train_forward_plain(*args, reverse)
        for i, (g, w) in enumerate(zip(got, want)):
            if i == 1:  # gates: 0 at frozen steps on the card
                _residual_close(g, w, args[1], reverse)
            else:
                _lstm_close(g.float(), w.float())
        _, gates, cs = got[:3]
        _lstm_close(
            tlt.lstm_train_backward(dout, dfc, dfh, gates, cs, args[1],
                                    args[2], reverse).float(),
            tlt.lstm_train_backward_plain(dout, dfc, dfh, gates, cs, args[1],
                                          args[2], reverse).float())
    launches = (tlt.lstm_train_forward.launches,
                tlt.lstm_train_backward.launches)
    got = _train_grads(args, (dout, dfc, dfh), reverse)
    assert tlt.lstm_train_forward.launches == launches[0] + 1
    assert tlt.lstm_train_backward.launches == launches[1] + 1
    want = _plain_grads(args, (dout, dfc, dfh), reverse)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _lstm_close(g, w)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_lstm_trainable_frozen_steps(cuda, reverse):
    """±1e4 in x_proj past num_frames: outputs and every gradient bit
    for bit those of zeros there; dZ exactly 0 on frozen steps."""
    xp, nf, wh, bias = _lstm_args(5, 60, 130, 128, cuda)
    past = torch.arange(60, device=cuda)[:, None] >= nf[None, :]
    if reverse:
        past = past.flip(0)
    sign = torch.where(torch.arange(512, device=cuda) % 2 == 0, 1e4, -1e4)
    clean = xp.masked_fill(past[..., None], 0)
    loud = torch.where(past[..., None], sign.to(xp.dtype), xp)
    cot = _cotangents(6, 60, 130, 128, cuda)
    a = _train_grads((clean, nf, wh, bias), cot, reverse)
    b = _train_grads((loud, nf, wh, bias), cot, reverse)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.all(b[3][past] == 0)


def _witness_holds(kernel, plain):
    """Differences at bf16 rounding boundaries (the plain value's median
    distance from the midpoint <= 2^-14 of the value), and beyond one
    bf16 step a remainder <= 1e-3 * max|ref|; values more than one step
    apart are held by the remainder alone."""
    r = tlt.rounding_report(kernel, plain)
    assert r.median <= 2.0 ** -14 and r.excess <= 1e-3, r


def _witness_live(kernel, plain, num_frames, reverse):
    """_live_split, then _witness_holds on the live pairs."""
    _witness_holds(*_live_split(kernel, plain, num_frames, reverse))


def _witness_forward(args, reverse, trainable):
    xp, nf, wh, bias = args
    if trainable:
        outs, gates, cs, c, h = tlt.lstm_train_forward(*args, reverse)
    else:
        outs, (c, h) = tlstm.lstm_recurrence(*args, reverse=reverse)
        outs = outs.to(torch.bfloat16)
    hs, gs, cc, (pc, ph) = tlt.forward_on_stream(outs, xp, nf, wh, bias,
                                                 reverse)
    _witness_holds(outs, hs)
    if trainable:
        _witness_live(gates, gs, nf, reverse)  # 0 at frozen steps
        _witness_holds(cs, cc)
    for g, w in ((c, pc), (h, ph)):
        _close(g, w, rel=1e-3)
    return (gates, cs) if trainable else None


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_lstm_differs_only_by_bf16_rounding(cuda, reverse):
    """Why the LSTM bound is 2e-2 and not 1e-3: fed their own bf16
    streams, the serving kernel, the trainable forward (outputs, gates,
    c_t) and the backward (dZ) differ from the plain cell where a value
    rounds to bf16 at a boundary; what one bf16 step does not explain
    (small values of nearly cancelling sums) stays under 1e-3 of
    max|ref|, and the f32 final state meets 1e-3."""
    args = _lstm_args(21, 300, 256, 1024, cuda)
    _witness_forward(args, reverse, trainable=False)
    gates, cs = _witness_forward(args, reverse, trainable=True)
    xp, nf, wh, bias = args
    dout, dfc, dfh = _cotangents(22, 300, 256, 1024, cuda)
    dz = tlt.lstm_train_backward(dout, dfc, dfh, gates, cs, nf, wh, reverse)
    plain = tlt.backward_on_stream(dz, dout, dfc, dfh, gates, cs, nf, wh,
                                   reverse)
    _witness_holds(dz, plain)


def test_cuda_training_step_matches_cpu(cuda):
    """The flagship at small widths, bf16: one training forward and
    backward on the card and on the CPU from the same weights and batch."""
    hp = ModelHParams(vocab_size=40, feature_dim=128, max_frames=30,
                      netvlad_cluster_size=64, netvlad_hidden_size=96,
                      lstm_cells=128, lstm_layers=2)
    g = torch.Generator().manual_seed(2)
    batch = {
        "features": torch.randint(0, 256, (9, 30, 128), generator=g,
                                  dtype=torch.uint8),
        "num_frames": torch.tensor([30, 0, 1, 7, 29, 30, 12, 3, 18],
                                   dtype=torch.int32),
        "labels": (torch.rand(9, 40, generator=g) < 0.1).float(),
        "batch_mask": torch.ones(9),
    }
    results = []
    for dev in (torch.device("cpu"), cuda):
        model = get_model("NetVladLstmModel", hp)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev).train()
        before = tlt.lstm_train_forward.launches
        total, _, _, _ = compute_loss(
            model, {k: v.to(dev) for k, v in batch.items()},
            get_loss("CrossEntropyLoss"))
        total.backward()
        if dev.type == "cuda":
            assert tlt.lstm_train_forward.launches == before + 2
        results.append((total.item(), {
            n: p.grad.double().norm().item()
            for n, p in model.named_parameters()}))
    (cpu_loss, cpu_norms), (gpu_loss, gpu_norms) = results
    assert abs(gpu_loss - cpu_loss) <= 2e-3 * abs(cpu_loss)
    for n, v in cpu_norms.items():
        assert abs(gpu_norms[n] - v) <= 2e-2 * max(v, 1e-6), n


# ---------------------------------------------------------------------------
# The trainable NetVLAD core (--netvlad_fused_train).
# ---------------------------------------------------------------------------


def _core_args(seed, b, f, d, k, dev):
    """act at BN scale, x dequantized from uint8, num_frames with f, 0 and
    1 planted, centers at the initialiser's scale."""
    g = torch.Generator().manual_seed(seed)
    act = 1.5 * torch.randn(b, f, k, generator=g)
    x = (torch.randint(0, 256, (b, f, d), generator=g).float() * (4.0 / 255.0)
         + (4.0 / 512.0 - 2.0))
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    centers = torch.randn(k, d, generator=g) * d ** -0.5
    dvlad = torch.randn(b, k, d, generator=g)
    return [t.to(dev) for t in (act, x, nf, centers)], dvlad.to(dev)


def _core_grads(args, dvlad, need_x=True):
    act, x, nf, centers = args
    a = act.clone().requires_grad_()
    xx = x.clone().requires_grad_(need_x)
    c = centers.clone().requires_grad_()
    vlad = tnt.netvlad_core(a, xx, nf, c)
    (vlad * dvlad).sum().backward()
    return vlad.detach(), a.grad, xx.grad, c.grad


@pytest.mark.parametrize("b,f,d,k", [(4, 11, 16, 8), (3, 7, 1000, 100),
                                     (5, 70, 1152, 256), (2, 300, 256, 512),
                                     (6, 65, 128, 257), (3, 300, 1152, 256)])
def test_cuda_netvlad_core_matches_plain(cuda, b, f, d, k):
    """Forward (vlad, a_sum), backward (dact, dx, with and without dx)
    against the plain versions; the Function's gradients, dcenters
    included, against the plain backward and reduction."""
    args, dvlad = _core_args(b + f + d + k, b, f, d, k, cuda)
    before = tnt.netvlad_core_forward.launches
    vlad, a_sum = tnt.netvlad_core_forward(*args)
    assert tnt.netvlad_core_forward.launches == before + 1
    want_v, want_a = tnt.netvlad_core_plain_forward(*args)
    _close(vlad, want_v)
    _close(a_sum, want_a)
    want_da, want_dx = tnt.netvlad_core_plain_backward(*args, dvlad)
    for need_dx in (True, False):
        before = tnt.netvlad_core_backward.launches
        dact, dx = tnt.netvlad_core_backward(*args, dvlad, need_dx)
        assert tnt.netvlad_core_backward.launches == before + 1
        _close(dact, want_da)
        if need_dx:
            _close(dx, want_dx)
        else:
            assert dx is None
    for need_x in (True, False):
        got = _core_grads(args, dvlad, need_x)
        _close(got[0], want_v)
        _close(got[1], want_da)
        if need_x:
            _close(got[2], want_dx)
        else:
            assert got[2] is None
        _close(got[3], -torch.einsum("bk,bkd->kd", want_a, dvlad))


def test_cuda_netvlad_core_ignores_frames_past_num_frames(cuda):
    """Large finite act and x past num_frames leave vlad, a_sum and every
    gradient bit for bit those of zeros there; dact and dx are exact
    zeros past num_frames; num_frames = 0 gives vlad = 0 and a_sum = 0."""
    args, dvlad = _core_args(3, 6, 300, 1152, 256, cuda)
    act, x, nf, centers = args
    past = torch.arange(300, device=cuda)[None, :] >= nf[:, None]
    clean = [act.masked_fill(past[..., None], 0),
             x.masked_fill(past[..., None], 0), nf, centers]
    loud = [torch.where(past[..., None], 3e4, act),
            torch.where(past[..., None], -1e5, x), nf, centers]
    a = _core_grads(clean, dvlad)
    c = _core_grads(loud, dvlad)
    for got, want in zip(c, a):
        assert torch.equal(got, want)
    assert torch.all(c[1][past] == 0) and torch.all(c[2][past] == 0)
    vlad, a_sum = tnt.netvlad_core_forward(*loud)
    assert torch.all(vlad[1] == 0) and torch.all(a_sum[1] == 0)


def test_cuda_netvlad_core_rejects_what_the_kernel_cannot_take(cuda):
    k = tnt.max_clusters() + 1  # two softmax rows no longer fit a block
    args, _ = _core_args(1, 2, 5, 64, k, cuda)
    with pytest.raises(ValueError, match=f"K <= {k - 1}"):
        tnt.netvlad_core_forward(*args)
    args, _ = _core_args(1, 2, 5, 64, 8, cuda)
    with pytest.raises(ValueError, match="dtype"):
        tnt.netvlad_core_forward(args[0].double(), *args[1:])


def test_cuda_dbof_trainer_resumes_and_evaluates(cuda, tmp_path):
    """Three DbofModel training steps through the Trainer on the card, two
    then one after a resume, then an eval of the checkpoint whose top-k
    runs exact_topk: finite metrics, the step counted on."""
    from yt8m_tpu_torch.config import EvalConfig, TrainConfig
    from yt8m_tpu_torch.eval.loop import evaluate_checkpoint
    from yt8m_tpu_torch.train.checkpoint import step_dirs
    from yt8m_tpu_torch.train.loop import Trainer

    write_dataset(str(tmp_path), "train", num_shards=1, videos_per_shard=24,
                  frame_level=True, num_classes=40, seed=3, rgb_dim=96,
                  audio_dim=32)
    reader = dict(feature_names="rgb,audio", feature_sizes="96,32",
                  frame_features=True, num_classes=40, model="DbofModel",
                  train_dir=str(tmp_path / "run"), batch_size=8,
                  hparams=ModelHParams(dbof_cluster_size=64,
                                       dbof_hidden_size=32, iterations=10))
    data = str(tmp_path / "train-*.tfrecord")
    assert Trainer(TrainConfig(train_data_pattern=data, max_steps=2,
                               **reader)).run() == 2
    trainer = Trainer(TrainConfig(train_data_pattern=data, max_steps=3,
                                  **reader))
    assert next(trainer.model.parameters()).is_cuda
    assert trainer.run() == 3
    assert step_dirs(reader["train_dir"]) == [2, 3]
    before = ttopk.exact_topk.launches
    out = evaluate_checkpoint(EvalConfig(eval_data_pattern=data, **reader))
    assert ttopk.exact_topk.launches > before
    assert out["step"] == 3 and out["nonfinite_predictions"] == 0
    assert 0 <= out["gap"] <= 1 and np.isfinite(out["avg_loss"])


# ---------------------------------------------------------------------------
# The GRU recurrence, serving and trainable.
# ---------------------------------------------------------------------------


def _gru_args(seed, f, b, h, dev):
    g = torch.Generator().manual_seed(seed)
    xg = (0.5 * torch.randn(f, b, 2 * h, generator=g)).to(torch.bfloat16)
    xc = (0.5 * torch.randn(f, b, h, generator=g)).to(torch.bfloat16)
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[0] = f
    if b > 2:
        nf[1] = 0
        nf[2] = 1
    whg = (torch.randn(h, 2 * h, generator=g) * h ** -0.5).to(torch.bfloat16)
    whc = (torch.randn(h, h, generator=g) * h ** -0.5).to(torch.bfloat16)
    bg = 1.0 + 0.1 * torch.randn(2 * h, generator=g)
    bc = 0.1 * torch.randn(h, generator=g)
    return [t.to(dev) for t in (xg, xc, nf, whg, whc, bg, bc)]


def _gru_hazard(args, reverse):
    """(clean, loud) args: xg and xc zero, or +-1e4, past num_frames."""
    xg, xc, nf = args[:3]
    f = xg.shape[0]
    past = torch.arange(f, device=xg.device)[:, None] >= nf[None, :]
    if reverse:
        past = past.flip(0)
    out = []
    for fill in (None, 1e4):
        ts = []
        for x in (xg, xc):
            if fill is None:
                ts.append(x.masked_fill(past[..., None], 0))
            else:
                sign = torch.where(torch.arange(x.shape[2], device=x.device)
                                   % 2 == 0, fill, -fill).to(x.dtype)
                ts.append(torch.where(past[..., None], sign, x))
        out.append(ts + list(args[2:]))
    return out, past


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
@pytest.mark.parametrize("f,b,h", [(13, 5, 64), (40, 130, 192),
                                   (300, 512, 1024), (1, 1, 64), (9, 7, 96)])
def test_cuda_gru_matches_plain(cuda, reverse, f, b, h):
    args = _gru_args(f + b + h, f, b, h, cuda)
    before = tgru.gru_recurrence.launches
    outs, hs = tgru.gru_recurrence(*args, reverse=reverse)
    assert tgru.gru_recurrence.launches == before + 1
    w_outs, w_h = tgru.gru_recurrence_plain(*args, reverse=reverse)
    _lstm_close(outs, w_outs)
    _lstm_close(hs, w_h)
    if b > 2:
        assert torch.all(outs[:, 1] == 0) and torch.all(hs[1] == 0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_gru_frozen_carry_ignores_steps_past_num_frames(cuda, reverse):
    (clean, loud), _ = _gru_hazard(_gru_args(3, 300, 64, 1024, cuda),
                                   reverse)
    a = tgru.gru_recurrence(*clean, reverse=reverse)
    b = tgru.gru_recurrence(*loud, reverse=reverse)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _set_frames(args, frames, seed):
    """num_frames (args[2] for the GRU, args[1] for the LSTM) all 0, all
    F, uniform in 0..F, or uniform in -F..2F (out of range both ways:
    a row with num_frames <= 0 is dead, one past F live at every step)."""
    nf = next(a for a in args if a.dtype == torch.int32)
    f = args[0].shape[0]
    if frames == "dead":
        nf.zero_()
    elif frames == "live":
        nf.fill_(f)
    else:
        g = torch.Generator().manual_seed(seed)
        low, high = (0, f + 1) if frames == "ragged" else (-f, 2 * f + 1)
        nf.copy_(torch.randint(low, high, nf.shape, generator=g,
                               dtype=torch.int32))
    return args


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
@pytest.mark.parametrize("frames", ["dead", "live", "ragged", "outside"])
@pytest.mark.parametrize("f,b,h", [(20, 70, 128), (12, 2048, 1024),
                                   (7, 1, 64)])
def test_cuda_recurrences_edge_rows(cuda, reverse, frames, f, b, h):
    """Every row dead, every row live, ragged, num_frames out of range;
    B = 1, B no multiple of the 32-row chunk, B = 2048: one launch a
    call, the plain version's values, and a dead row's outputs and state
    0."""
    for mod, fn, plain, args in (
            (tlstm, tlstm.lstm_recurrence, tlstm.lstm_recurrence_plain,
             _lstm_args(f + b, f, b, h, cuda)),
            (tgru, tgru.gru_recurrence, tgru.gru_recurrence_plain,
             _gru_args(f + b, f, b, h, cuda))):
        args = _set_frames(args, frames, f * b)
        before = fn.launches
        got = fn(*args, reverse=reverse)
        assert fn.launches == before + 1, mod.__name__
        want = plain(*args, reverse=reverse)
        outs, state = got[0], got[1] if mod is tgru else got[1][1]
        _lstm_close(outs, want[0])
        _lstm_close(state, want[1] if mod is tgru else want[1][1])
        dead = args[2 if mod is tgru else 1] <= 0
        assert torch.all(outs[:, dead] == 0) and torch.all(state[dead] == 0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_lstm_streams_weights_past_shared_memory(cuda, reverse):
    """H = 2048: a unit tile's W_h columns (256 KB) do not fit the shared
    weight area, and the same kernel streams them in K chunks."""
    assert tlstm.plan(96, 2048)["resident"] == 0
    args = _lstm_args(9, 20, 96, 2048, cuda)
    before = tlstm.lstm_recurrence.launches
    outs, (c, hs) = tlstm.lstm_recurrence(*args, reverse=reverse)
    assert tlstm.lstm_recurrence.launches == before + 1
    w_outs, (w_c, w_h) = tlstm.lstm_recurrence_plain(*args, reverse=reverse)
    for g, w in ((outs, w_outs), (c, w_c), (hs, w_h)):
        _lstm_close(g, w)


def _trainable_both(args_lstm, args_gru, cot_seed, reverse):
    """The trainable LSTM's and GRU's Functions against their plain
    versions: outputs, final state and every gradient; one forward and
    one backward launch each; a row with num_frames <= 0 keeps zero
    outputs and gets zero dZ / dA."""
    f, b, h = args_lstm[0].shape[0], args_lstm[0].shape[1], \
        args_lstm[2].shape[0]
    cot = _cotangents(cot_seed, f, b, h, args_lstm[0].device)
    for grads, plain, args, c, fwd, bwd in (
            (_train_grads, _plain_grads, args_lstm, cot,
             tlt.lstm_train_forward, tlt.lstm_train_backward),
            (_gru_train_grads, _gru_plain_grads, args_gru, [cot[0], cot[2]],
             tgt.gru_train_forward, tgt.gru_train_backward)):
        launches = (fwd.launches, bwd.launches)
        got = grads(args, c, reverse)
        assert (fwd.launches, bwd.launches) == (launches[0] + 1,
                                                launches[1] + 1)
        want = plain(args, c, reverse)
        for x, y in zip(got, want):
            assert torch.isfinite(x).all()
            _lstm_close(x, y)
        nf = args[2 if grads is _gru_train_grads else 1]
        dead = nf <= 0
        assert torch.all(got[0][:, dead] == 0)
        assert torch.all(got[2 if grads is _gru_train_grads else 3][:, dead]
                         == 0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
@pytest.mark.parametrize("frames", ["dead", "live", "outside"])
@pytest.mark.parametrize("f,b,h", [(20, 70, 128), (7, 1, 64),
                                   (12, 300, 1024)])
def test_cuda_trainable_recurrences_edge_rows(cuda, reverse, frames, f, b,
                                              h):
    """The trainable LSTM and GRU with every row dead, every row live, and
    num_frames out of range (-F..2F); B = 1 and B no multiple of the
    32-row chunk: one launch a direction, the plain version's outputs and
    gradients, and a dead row untouched."""
    args_l = _set_frames(_lstm_args(f + b, f, b, h, cuda), frames, f * b)
    args_g = _set_frames(_gru_args(f + b, f, b, h, cuda), frames, f * b)
    _trainable_both(args_l, args_g, f + h, reverse)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_trainable_recurrences_stream_weights_past_shared_memory(
        cuda, reverse):
    """H = 2048: a backward unit tile's W rows ([16, 8192] for the LSTM,
    [16, 4096] + [16, 2048] for the GRU) do not fit the shared weight
    area, and the same kernels stream them in K chunks."""
    assert tlt.plan(96, 2048)["resident"] == 0
    assert tgt.plan(96, 2048)["resident"] == 0
    _trainable_both(_lstm_args(9, 20, 96, 2048, cuda),
                    _gru_args(9, 20, 96, 2048, cuda), 4, reverse)


def test_cuda_trainable_backward_plan_at_the_training_batch(cuda):
    """B = 256, H = 1024 (the training batch and width): 128 blocks with
    their weight tiles resident, two row groups of four 32-row chunks, so
    four warps own a chunk and get the ring."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for mod in (tlt, tgt):
        p = mod.plan(256, 1024)
        assert p["resident"] == 1 and p["lanes"] == 1024 // 16, p
        assert p["grid"] == p["lanes"] * p["groups"] <= sms, p
        assert p["ring_warps"] == min(8, -(-256 // 32 // p["groups"])), p
        assert p["stages"] >= 3 and p["smem"] <= 232448, p


def test_cuda_recurrences_keep_their_weights_resident_at_h1024(cuda):
    """GruModel's and the flagship's H = 1024: one co-resident wave whose
    blocks hold their weight tiles in shared memory for the whole call."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for mod in (tlstm, tgru):
        p = mod.plan(512, 1024)
        assert p["resident"] == 1 and p["lanes"] == 1024 // 16, mod.__name__
        assert p["grid"] == p["lanes"] * p["groups"] <= sms, p


def test_cuda_gru_wrappers_reject_what_the_kernels_cannot_take(cuda):
    xg, xc, nf, whg, whc, bg, bc = _gru_args(0, 4, 3, 64, cuda)
    with pytest.raises(ValueError):  # f32 xg: the kernel takes bf16
        tgru.gru_recurrence(xg.float(), xc, nf, whg, whc, bg, bc)
    with pytest.raises(ValueError):  # int64 frame counts
        tgru.gru_recurrence(xg, xc, nf.long(), whg, whc, bg, bc)
    with pytest.raises(ValueError):  # xc of the wrong width
        tgru.gru_recurrence(xg, xc[..., :32], nf, whg, whc, bg, bc)
    with pytest.raises(ValueError):  # frames are uint8 or f32
        tap.attention_pool(torch.zeros(2, 3, 8, device=cuda,
                                       dtype=torch.float16),
                           nf[:2], torch.zeros(8, 4, device=cuda))


def _gru_train_grads(args, cot, reverse):
    xg, xc, nf, whg, whc, bg, bc = args
    params = [x.clone().requires_grad_() for x in (xg, xc)]
    params += [w.float().requires_grad_() for w in (whg, whc)]
    params += [b_.clone().requires_grad_() for b_ in (bg, bc)]
    outs, fh = tgt.gru_recurrence_trainable(params[0], params[1], nf,
                                            *params[2:], reverse)
    dout, dfh = cot
    ((outs * dout).sum() + (fh * dfh).sum()).backward()
    return [outs, fh] + [p.grad for p in params]


def _gru_plain_grads(args, cot, reverse):
    """The plain forward, backward and weight gradients on the same
    device: (outs, h, dxg, dxc, dW_hg, dW_hc, dbg, dbc)."""
    xg, xc, nf, whg, whc, bg, bc = args
    outs, gates, cand, h = tgt.gru_train_forward_plain(*args, reverse)
    dag, dac = tgt.gru_train_backward_plain(*cot, gates, cand, outs, nf,
                                            whg, whc, reverse)
    return [outs.float(), h, dag.float(), dac.float(),
            *tgt.weight_grads(outs, gates, dag, dac)]


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
@pytest.mark.parametrize("f,b,h", [(13, 5, 64), (40, 130, 192),
                                   (300, 256, 1024), (7, 9, 96)])
def test_cuda_gru_trainable_matches_plain(cuda, reverse, f, b, h):
    """Forward, residuals, dA_g and dA_c against the plain versions on the
    same inputs; the Function's outputs and gradients against the plain
    forward, backward and weight gradients."""
    args = _gru_args(f + b + h, f, b, h, cuda)
    g = torch.Generator().manual_seed(h)
    cot = [torch.randn(f, b, h, generator=g).to(cuda),
           torch.randn(b, h, generator=g).to(cuda)]
    if h % 64 == 0:
        got = tgt.gru_train_forward(*args, reverse)
        want = tgt.gru_train_forward_plain(*args, reverse)
        for i, (x, y) in enumerate(zip(got, want)):
            if i in (1, 2):  # gates, candidate: 0 at frozen steps on the card
                _residual_close(x, y, args[2], reverse)
            else:
                _lstm_close(x.float(), y.float())
        outs, gates, cand = got[:3]
        bwd = (*cot, gates, cand, outs, args[2], args[3], args[4], reverse)
        for x, y in zip(tgt.gru_train_backward(*bwd),
                        tgt.gru_train_backward_plain(*bwd)):
            _lstm_close(x.float(), y.float())
    launches = (tgt.gru_train_forward.launches,
                tgt.gru_train_backward.launches)
    got = _gru_train_grads(args, cot, reverse)
    assert tgt.gru_train_forward.launches == launches[0] + 1
    assert tgt.gru_train_backward.launches == launches[1] + 1
    want = _gru_plain_grads(args, cot, reverse)
    for x, y in zip(got, want):
        assert torch.isfinite(x).all()
        _lstm_close(x, y)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_gru_trainable_frozen_steps(cuda, reverse):
    """+-1e4 in xg and xc past num_frames: outputs and every gradient bit
    for bit those of zeros there; dA exactly 0 on frozen steps."""
    args = _gru_args(5, 60, 130, 128, cuda)
    (clean, loud), past = _gru_hazard(args, reverse)
    g = torch.Generator().manual_seed(6)
    cot = [torch.randn(60, 130, 128, generator=g).to(cuda),
           torch.randn(130, 128, generator=g).to(cuda)]
    a = _gru_train_grads(clean, cot, reverse)
    b = _gru_train_grads(loud, cot, reverse)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.all(b[2][past] == 0) and torch.all(b[3][past] == 0)


@pytest.mark.parametrize("reverse", [False, True], ids=["fw", "bw"])
def test_cuda_gru_differs_only_by_bf16_rounding(cuda, reverse):
    """Why the GRU bound is 2e-2 and not 1e-3: step by step from the
    kernel's own state, u and the f32 h meet 1e-3 * max|ref| + 1e-6 and
    bf16(r * h) and the outputs differ from the plain cell only at bf16
    rounding boundaries; so do the trainable forward's gates and
    candidate and the backward's dA on their own streams."""
    args = _gru_args(21, 300, 256, 1024, cuda)
    xg, xc, nf, whg, whc, bg, bc = args
    kern, plain = tgt.forward_steps_on_card(*args, reverse)
    _close(kern["u"], plain["u"], rel=1e-3)
    _close(kern["h"], plain["h"], rel=1e-3)
    _witness_holds(kern["rh"], plain["rh"])
    _witness_holds(kern["out"], plain["h"])
    outs, gates, cand, h = tgt.gru_train_forward(*args, reverse)
    assert torch.equal(outs, kern["out"]) and torch.equal(h, kern["h"][-1])
    gp, cp = tgt.residuals_on_stream(outs, kern["rh"], xg, xc, whg, whc, bg,
                                     bc)
    _witness_live(gates, gp, nf, reverse)
    _witness_live(cand, cp, nf, reverse)
    g = torch.Generator().manual_seed(22)
    cot = [torch.randn(300, 256, 1024, generator=g).to(cuda),
           torch.randn(256, 1024, generator=g).to(cuda)]
    dag, dac = tgt.gru_train_backward(*cot, gates, cand, outs, nf, whg, whc,
                                      reverse)
    sg, sc = tgt.backward_on_stream(dag, dac, *cot, gates, cand, outs, nf,
                                    whg, whc, reverse)
    _witness_holds(dag, sg)
    _witness_holds(dac, sc)


# ---------------------------------------------------------------------------
# Attention pooling.
# ---------------------------------------------------------------------------


def _attention_args(seed, b, f, d, h, x_dtype, dev):
    g = torch.Generator().manual_seed(seed)
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=g, dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=g)
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[0] = f
    if b > 2:
        nf[1] = 0
        nf[2] = 1
    q = (torch.randn(d, h, generator=g) * d ** -0.5).to(torch.bfloat16)
    return [t.to(dev) for t in (x, nf, q)]


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,f,d,h", [(5, 13, 32, 4), (7, 300, 1152, 8),
                                     (3, 70, 1001, 3), (4, 20, 64, 19),
                                     (2, 1, 8, 1), (9, 300, 1001, 8),
                                     (6, 300, 1152, 16), (5, 37, 128, 2),
                                     (140, 45, 64, 8)])
def test_cuda_attention_pool_matches_plain(cuda, x_dtype, b, f, d, h):
    args = _attention_args(b + f + d + h, b, f, d, h, x_dtype, cuda)
    before = tap.attention_pool.launches
    got = tap.attention_pool(*args)
    assert tap.attention_pool.launches == before + (2 if h > 16 else 1)
    assert got.shape == (b, h, d)
    want = tap.attention_pool_plain(*args)
    if x_dtype == torch.uint8 and (f, d, h) == (300, 1152, 8):
        _within_rounding_limit(args, got, want)  # the serving draw
    else:
        _close(got, want, rel=1e-3)


def _within_rounding_limit(args, got, want):
    """The kernel's recovered bf16 weights explain its output and differ
    from the plain version's only at bf16 rounding boundaries, by one
    step; |kernel - plain| within the limit that gives
    (attention_pool.py :: rounding_limit)."""
    r = tap.rounding_limit(*args, got, want)
    assert r.explained and r.away == 0, r[1:]
    assert torch.all((got - want).abs() <= r.limit), (
        (got - want).abs().max().item(), r[1:])


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_cuda_attention_pool_serving_draws_within_rounding_limit(cuda, seed):
    """AttentionPoolingModel's serving shape (B=512, F=300, D=1152, H=8,
    uint8 frames) at several draws: a fixed 1e-3 * max|ref| fails on
    some (an attention weight in [0.5, 1) one bf16 step from the plain
    version's moves the output 2^-9 |x|); the derived limit holds."""
    args = _attention_args(seed, 512, 300, 1152, 8, torch.uint8, cuda)
    _within_rounding_limit(args, tap.attention_pool(*args),
                           tap.attention_pool_plain(*args))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_attention_pool_ignores_frames_past_num_frames(cuda, x_dtype):
    x, nf, q = _attention_args(3, 64, 300, 1152, 8, x_dtype, cuda)
    nf[1] = 7  # every video has a frame here
    past = torch.arange(300, device=cuda)[None, :] >= nf[:, None]
    loud = 255 if x_dtype == torch.uint8 else 1e4
    clean = x.masked_fill(past[..., None], 0)
    noisy = torch.where(past[..., None],
                        torch.as_tensor(loud, dtype=x.dtype, device=cuda), x)
    assert torch.equal(tap.attention_pool(clean, nf, q),
                       tap.attention_pool(noisy, nf, q))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("f,d,h", [(300, 1152, 8), (300, 1152, 16),
                                   (300, 1024, 4), (13, 128, 1),
                                   (301, 2048, 8)])
def test_cuda_attention_pool_plan_matches_the_kernel(cuda, x_dtype, f, d, h):
    """The compiled layout is the one kernels/attention_pool.py :: plan
    describes."""
    for f32 in (False, True):
        got = tap.kernel_plan(f, d, h, x_dtype, f32)
        p = tap.plan(f, d, h, x_dtype, f32=f32)
        assert got["rows"] == tap.ROWS and got["warps"] == tap.WARPS
        assert (got["max_groups"], got["max_stages"]) == (tap.MAX_GROUPS,
                                                          tap.MAX_STAGES)
        assert {key: got[key] for key in ("lines", "stage_bytes", "stages",
                                          "smem", "f16", "attn_pitch",
                                          "n_tiles")} == {
            key: p[key] for key in ("lines", "stage_bytes", "stages", "smem",
                                    "f16", "attn_pitch", "n_tiles")}


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_attention_pool_walk_repeats_bit_for_bit(cuda, x_dtype):
    """The persistent grid takes videos from a counter that each launch
    leaves at zero: launches one after another, with fewer videos than
    SMs, many more, and videos longer than the ring (read twice), give
    the same bits each time; every video is pooled (none left as the
    output's uninitialised memory)."""
    for b, f in ((3, 300), (700, 40), (64, 300)):
        args = _attention_args(b + f, b, f, 1152, 8, x_dtype, cuda)
        first = tap.attention_pool(*args)
        assert torch.isfinite(first).all()
        for _ in range(2):
            assert torch.equal(tap.attention_pool(*args), first)
        want = tap.attention_pool_plain(*args)
        if x_dtype == torch.uint8:
            _within_rounding_limit(args, first, want)
        else:
            _close(first, want, rel=1e-3)


def test_cuda_attention_pool_num_frames_out_of_range(cuda):
    """num_frames above F reads F rows; negative ones take the mean over
    the F rows, as 0 does."""
    x, nf, q = _attention_args(5, 6, 40, 64, 8, torch.uint8, cuda)
    nf = torch.tensor([41, 400, -3, 0, 40, 17], dtype=torch.int32,
                      device=cuda)
    got = tap.attention_pool(x, nf, q)
    want = tap.attention_pool_plain(x, nf, q)
    _close(got, want, rel=1e-3)


# ---------------------------------------------------------------------------
# NeXtVLAD: the serving aggregation and its trainable backward.
# ---------------------------------------------------------------------------


def _nextvlad_args(seed, b, f, d, lam, g, k, x_dtype, dev):
    """Frames, num_frames (f, 0 and 1 planted), and the five weights at
    the JAX initialisers' scales with a drawn attention bias."""
    gen = torch.Generator().manual_seed(seed)
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=gen, dtype=torch.uint8)
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


def _nextvlad_close(got, want):
    _close(got, want, rel=2.0 ** -7)


NEXTVLAD_SHAPES = [(3, 10, 16, 2, 4, 12), (4, 70, 64, 2, 1, 128),
                   (3, 13, 32, 1, 16, 96), (5, 300, 96, 3, 2, 130),
                   (6, 300, 1152, 2, 8, 128), (2, 130, 1004, 2, 8, 256),
                   (3, 9, 64, 5, 1, 40)]  # P = 320: two column tiles


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,f,d,lam,g,k", NEXTVLAD_SHAPES)
def test_cuda_nextvlad_matches_plain(cuda, x_dtype, b, f, d, lam, g, k):
    args = _nextvlad_args(b + f + d + k, b, f, d, lam, g, k, x_dtype, cuda)
    before = tnv.nextvlad_aggregate.launches
    got = tnv.nextvlad_aggregate(*args, g)
    assert tnv.nextvlad_aggregate.launches == before + 1
    assert got.shape == (b, k, lam * d // g)
    assert torch.all(got[1] == 0)  # num_frames = 0
    _nextvlad_close(got, tnv.nextvlad_aggregate_plain(*args, g))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_nextvlad_ignores_frames_past_num_frames(cuda, x_dtype):
    x, nf, *w = _nextvlad_args(3, 16, 300, 1152, 2, 8, 128, x_dtype, cuda)
    past = torch.arange(300, device=cuda)[None, :] >= nf[:, None]
    loud = 255 if x_dtype == torch.uint8 else 1e4
    clean = x.masked_fill(past[..., None], 0)
    noisy = torch.where(past[..., None],
                        torch.as_tensor(loud, dtype=x.dtype, device=cuda), x)
    assert torch.equal(tnv.nextvlad_aggregate(clean, nf, *w, 8),
                       tnv.nextvlad_aggregate(noisy, nf, *w, 8))


def _nextvlad_train_grads(args, g, dy):
    x, nf, *w = args
    ws = [t.clone().requires_grad_() for t in w]
    out = tnvt.nextvlad_aggregate_train(x, nf, *ws, g)
    (out * dy).sum().backward()
    return out.detach(), [t.grad for t in ws]


@pytest.mark.parametrize("b,f,d,lam,g,k", NEXTVLAD_SHAPES)
def test_cuda_nextvlad_train_matches_plain(cuda, b, f, d, lam, g, k):
    """The Function's forward and its five weight gradients against the
    plain versions; a second run gives the same bits (no atomics)."""
    args = _nextvlad_args(b + f + k, b, f, d, lam, g, k, torch.uint8, cuda)
    dy = torch.randn(b, k, lam * d // g,
                     generator=torch.Generator().manual_seed(b)).to(cuda)
    before = (tnvt.nextvlad_train_forward.launches,
              tnvt.nextvlad_train_backward.launches)
    out, grads = _nextvlad_train_grads(args, g, dy)
    assert (tnvt.nextvlad_train_forward.launches,
            tnvt.nextvlad_train_backward.launches) == (before[0] + 1,
                                                       before[1] + 1)
    _nextvlad_close(out, tnv.nextvlad_aggregate_plain(*args, g))
    want = tnvt.nextvlad_aggregate_train_plain_backward(*args, dy, g)
    for got, ref in zip(grads, want):
        assert got.shape == ref.shape
        _nextvlad_close(got, ref)
    again = _nextvlad_train_grads(args, g, dy)[1]
    for a, c in zip(grads, again):
        assert torch.equal(a, c)


def test_cuda_nextvlad_train_ignores_frames_past_num_frames(cuda):
    """Large frames past num_frames leave every gradient bit for bit;
    videos with num_frames = 0 alone give zero gradients."""
    x, nf, *w = _nextvlad_args(4, 12, 300, 1152, 2, 8, 128, torch.float32,
                               cuda)
    dy = torch.randn(12, 128, 288,
                     generator=torch.Generator().manual_seed(5)).to(cuda)
    past = torch.arange(300, device=cuda)[None, :] >= nf[:, None]
    clean = x.masked_fill(past[..., None], 0)
    noisy = torch.where(past[..., None], 1e4, x)
    a = _nextvlad_train_grads([clean, nf, *w], 8, dy)
    c = _nextvlad_train_grads([noisy, nf, *w], 8, dy)
    assert torch.equal(a[0], c[0])
    for p, q in zip(a[1], c[1]):
        assert torch.equal(p, q)
    empty = _nextvlad_train_grads([x[1:2], nf[1:2].clone(), *w], 8,
                                  dy[1:2])[1]
    for grad in empty:
        assert torch.all(grad == 0)


def _witness_rounding(kernel, plain):
    r = tlt.rounding_report(kernel, plain)
    assert r.median <= 2.0 ** -14 and r.excess <= 1e-3, r


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_nextvlad_differs_only_by_bf16_rounding(cuda, x_dtype):
    """Why the NeXtVLAD bound is 2^-7: fed the kernel's own bf16 frames
    and xe, the plain xe and assignment round to the kernel's values but
    at rounding boundaries, and the plain aggregation and norm on the
    kernel's own roundings meet 1e-3 * max|ref| + 1e-6."""
    x, nf, *w = _nextvlad_args(12, 32, 300, 1152, 2, 8, 128, x_dtype, cuda)
    layout = tnv.kernel_layout(*w, 8)
    out, scratch = tnv.nextvlad_aggregate_with_scratch(x, nf, layout)
    pairs = tnv.forward_on_stream(x, nf, layout, scratch, out)
    _witness_rounding(*pairs["xe"])
    _witness_rounding(*pairs["assign"])
    _close(*pairs["out"])


def test_cuda_nextvlad_train_differs_only_by_bf16_rounding(cuda):
    """The same for the backward: bf16(dv), bf16(d_act) and bf16(d_xe)
    differ from the plain steps on the kernel's stream only at rounding
    boundaries; dv, cdot, d_pre and the weight-gradient products on the
    kernel's bf16 operands meet 1e-3 * max|ref| + 1e-6."""
    x, nf, *w = _nextvlad_args(13, 24, 300, 1152, 2, 8, 128, torch.uint8,
                               cuda)
    dy = torch.randn(24, 128, 288,
                     generator=torch.Generator().manual_seed(6)).to(cuda)
    layout = tnv.kernel_layout(*w, 8, training=True)
    _, res = tnvt.nextvlad_train_forward(x, nf, layout)
    dwe, dwext, _, _, t = tnvt.nextvlad_train_backward_with_scratch(
        nf, res, layout, dy)
    pairs = tnvt.backward_on_stream(nf, res, layout, dy, dwe, dwext, t)
    for name in ("dvb", "d_act", "d_xe"):
        _witness_rounding(*pairs.pop(name))
    for got, ref in pairs.values():
        _close(got, ref)


def test_cuda_nextvlad_rejects_what_the_kernel_cannot_take(cuda,
                                                         monkeypatch):
    """K = 300 serves (the refusal moved from K = 257 to above
    max_clusters(), here lowered to 299 to reach it); packed rows that
    overflow the index, a bad dtype and f32 compute raise."""
    args = _nextvlad_args(1, 2, 5, 16, 2, 1, 300, torch.uint8, cuda)
    assert tnv.nextvlad_aggregate(*args, 1).shape == (2, 300, 32)
    monkeypatch.setattr(tnv, "max_clusters", lambda: 299)
    with pytest.raises(ValueError, match="K <= 299"):
        tnv.nextvlad_aggregate(*args, 1)
    monkeypatch.undo()
    x, nf, *w = _nextvlad_args(1, 2, 5, 8, 2, 1, 300, torch.uint8, cuda)
    big = torch.zeros(65535, 103, 8, dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="more packed rows"):
        tnv.nextvlad_aggregate(big, nf.new_ones(65535), *w, 1)
    args = _nextvlad_args(1, 2, 5, 16, 2, 4, 12, torch.uint8, cuda)
    with pytest.raises(ValueError, match="dtype"):
        tnv.nextvlad_aggregate(args[0].double(), *args[1:], 4)
    with pytest.raises(ValueError, match="bfloat16"):
        tnv.nextvlad_aggregate(*args, 4, torch.float32)


@pytest.mark.parametrize("k", [264, 520, 1000])
@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_nextvlad_any_clusters(cuda, x_dtype, k):
    """K > 256 (the Logits launch, the wide softmax, the wide d_assign
    and its row VJP): serving and the trainable pair against the plain
    versions within 2^-7 * max|ref|, one launch each way, a second run
    bit for bit; a NaN-filled logits scratch leaves no NaN (the pads and
    the rows that are not live are written, never read)."""
    b, f, d, lam, g = 6, 70, 64, 2, 8
    args = _nextvlad_args(k, b, f, d, lam, g, k, x_dtype, cuda)
    p = lam * d // g
    before = tnv.nextvlad_aggregate.launches
    got = tnv.nextvlad_aggregate(*args, g)
    assert tnv.nextvlad_aggregate.launches == before + 1
    assert got.shape == (b, k, p) and torch.all(got[1] == 0)
    _nextvlad_close(got, tnv.nextvlad_aggregate_plain(*args, g))
    x, nf, *w = args
    layout = tnv.kernel_layout(*w, g)
    real_empty = torch.empty
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch, "empty", lambda *a, **kw: real_empty(
        *a, **kw).fill_(float("nan")) if kw.get("dtype", torch.float32)
        == torch.float32 else real_empty(*a, **kw))
    try:
        nan_run, _ = tnv.launch_forward(x, nf, layout)
    finally:
        monkey.undo()
    assert torch.equal(nan_run, got)
    dy = torch.randn(b, k, p, generator=torch.Generator().manual_seed(k)).to(
        cuda)
    out, grads = _nextvlad_train_grads(args, g, dy)
    _nextvlad_close(out, tnv.nextvlad_aggregate_plain(*args, g))
    want = tnvt.nextvlad_aggregate_train_plain_backward(*args, dy, g)
    for a, ref in zip(grads, want):
        assert a.shape == ref.shape and torch.isfinite(a).all()
        _nextvlad_close(a, ref)
    for a, c in zip(grads, _nextvlad_train_grads(args, g, dy)[1]):
        assert torch.equal(a, c)


def test_cuda_nextvlad_model_matches_cpu(cuda):
    """NeXtVladModel at small widths, bf16: serving and one training
    forward and backward on the card and on the CPU from the same weights
    and batch."""
    hp = ModelHParams(vocab_size=40, feature_dim=128, max_frames=30,
                      nextvlad_cluster_size=64, nextvlad_hidden_size=96,
                      nextvlad_groups=4)
    g = torch.Generator().manual_seed(3)
    batch = {
        "features": torch.randint(0, 256, (9, 30, 128), generator=g,
                                  dtype=torch.uint8),
        "num_frames": torch.tensor([30, 0, 1, 7, 29, 30, 12, 3, 18],
                                   dtype=torch.int32),
        "labels": (torch.rand(9, 40, generator=g) < 0.1).float(),
        "batch_mask": torch.ones(9),
    }
    served, trained = [], []
    for dev in (torch.device("cpu"), cuda):
        model = get_model("NeXtVladModel", hp)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev).eval()
        with torch.no_grad():
            served.append(model(batch["features"].to(dev),
                                batch["num_frames"].to(dev))["predictions"])
        model.train()
        total, _, _, _ = compute_loss(
            model, {k: v.to(dev) for k, v in batch.items()},
            get_loss("CrossEntropyLoss"))
        total.backward()
        trained.append((total.item(), {
            n: p.grad.double().norm().item()
            for n, p in model.named_parameters()}))
    assert (served[1].cpu() - served[0]).abs().max().item() <= 2e-3
    (cpu_loss, cpu_norms), (gpu_loss, gpu_norms) = trained
    assert abs(gpu_loss - cpu_loss) <= 2e-3 * abs(cpu_loss)
    for n, v in cpu_norms.items():
        assert abs(gpu_norms[n] - v) <= 2e-2 * max(v, 1e-6), n


def _int8_args(seed, b, s, d, k, dev):
    args = _dbof_args(seed, b, s, d, k, torch.uint8, torch.device("cpu"))
    x, w, s_in, b_in, s_act, b_act = args
    consts = tdbof.int8_serving_constants(w.float(), s_in, b_in, s_act,
                                          b_act)
    return [t.to(dev) for t in (x, *consts)]


@pytest.mark.parametrize("b,s,d,k", [(7, 5, 64, 200), (9, 32, 96, 136),
                                     (5, 30, 1152, 8192), (1, 1, 32, 8),
                                     (3, 64, 128, 48)])
def test_cuda_dbof_int8_equals_plain_bit_for_bit(cuda, b, s, d, k):
    args = _int8_args(b + k, b, s, d, k, cuda)
    before = tdbof.dbof_cluster_maxpool_int8.launches
    got = tdbof.dbof_cluster_maxpool_int8(*args)
    assert tdbof.dbof_cluster_maxpool_int8.launches == before + -(-s // 32)
    assert torch.equal(got, tdbof.dbof_cluster_maxpool_int8_plain(*args))


@pytest.mark.parametrize("b,s,d,k", [(7, 5, 64, 200), (5, 30, 1152, 8192),
                                     (3, 64, 128, 48)])
def test_cuda_dbof_int8_signed_columns_bit_for_bit(cuda, b, s, d, k):
    """Columns with a_col < 0 (the kernel pools the minimum sum there),
    a_col = 0 and a_col = -0.0 equal the plain version bit for bit."""
    x, w8, a_col, b_col = _int8_args(b + s + k, b, s, d, k, cuda)
    a_col = a_col.clone()
    a_col[::3] *= -1.0
    a_col[1::7] = 0.0
    a_col[2::11] = -0.0
    got = tdbof.dbof_cluster_maxpool_int8(x, w8, a_col, b_col)
    assert torch.equal(got, tdbof.dbof_cluster_maxpool_int8_plain(
        x, w8, a_col, b_col))


def test_cuda_dbof_int8_plan_matches_the_kernel(cuda):
    """The compiled int8 product's tile is the one kernels/dbof.py ::
    plan_int8 describes."""
    got = tdbof.kernel_plan_int8()
    p = tdbof.plan_int8(2048, 1152, 8192, sms=got["sms"])
    assert (got["videos"], got["pitch"], got["tile_clusters"], got["depth"],
            got["stages"], got["smem"]) == (
        tdbof.TILE_VIDEOS, tdbof.MAX_FRAMES_PER_VIDEO, p["chain"],
        tdbof.INT8_DEPTH, p["stages"], p["smem"])


def test_cuda_dbof_int8_masks_padded_frames(cuda):
    """Every real row is negative before the ReLU; an unmasked padding row
    (int8 zero, the raw byte 128) would give relu(b_col) = 3. The same
    with a_col < 0 (the minimum sum pooled there)."""
    x, w8, a_col, _ = _int8_args(0, 6, 30, 64, 64, cuda)
    x = torch.clamp(x, min=200)
    w8 = -w8.abs()
    b_col = torch.full_like(a_col, 3.0)
    a_col = torch.ones_like(a_col)  # acc <= -72 * 127: every real row < 0
    got = tdbof.dbof_cluster_maxpool_int8(x, w8, a_col, b_col)
    assert torch.all(tdbof.dbof_cluster_maxpool_int8_plain(
        x, w8, a_col, b_col) == 0)
    assert torch.all(got == 0)
    got = tdbof.dbof_cluster_maxpool_int8(x, -w8, -a_col, b_col)
    assert torch.all(tdbof.dbof_cluster_maxpool_int8_plain(
        x, -w8, -a_col, b_col) == 0)
    assert torch.all(got == 0)


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,s,d,k", [(7, 5, 64, 200), (5, 30, 1152, 8192),
                                     (3, 40, 96, 64)])
def test_cuda_dbof_v1_matches_plain(cuda, x_dtype, b, s, d, k):
    x, w, *vec = _dbof_args(b + k, b, s, d, k, x_dtype, cuda)
    w = w.float() + 1e-3 * torch.randn(w.shape, device=cuda)  # f32 weights
    before = (tdbof.dbof_cluster_maxpool.launches,
              tdbof.dbof_cluster_maxpool_v2.launches)
    got = tdbof.dbof_cluster_maxpool(x, w, *vec)
    assert (tdbof.dbof_cluster_maxpool.launches,
            tdbof.dbof_cluster_maxpool_v2.launches) == (
                before[0] + -(-s // 32), before[1])
    _close(got, tdbof.dbof_cluster_maxpool_v1_plain(x, w, *vec))


def _sampled_args(seed, b, f, d, s, k, dev):
    x, w, *vec = _dbof_args(seed, b, f, d, k, torch.uint8, dev)
    g = torch.Generator().manual_seed(seed + 1)
    idx = torch.randint(0, f, (b, s), generator=g, dtype=torch.int32)
    return [x, idx.to(dev), w.float(), *vec]


@pytest.mark.parametrize("b,f,d,s,k", [(7, 300, 64, 5, 200),
                                       (9, 40, 96, 32, 136),
                                       (5, 300, 1152, 30, 8192)])
def test_cuda_dbof_sampled_equals_v2_on_gathered_frames(cuda, b, f, d, s, k):
    x, idx, w, *vec = _sampled_args(b + k, b, f, d, s, k, cuda)
    before = tdbof.dbof_sampled_cluster_maxpool.launches
    got = tdbof.dbof_sampled_cluster_maxpool(x, idx, w, *vec)
    assert tdbof.dbof_sampled_cluster_maxpool.launches == before + 1
    rows = torch.arange(b, device=cuda)[:, None]
    want = tdbof.dbof_cluster_maxpool_v2(x[rows, idx.long()].contiguous(),
                                         w.to(torch.bfloat16), *vec)
    assert torch.equal(got, want)
    _close(got, tdbof.dbof_sampled_cluster_maxpool_plain(x, idx, w, *vec))


def test_cuda_dbof_sampled_out_of_range_indices(cuda):
    """An index outside [0, F) selects a zero frame, as the TPU kernel's
    one-hot select does, and reads nothing out of bounds."""
    x, idx, w, *vec = _sampled_args(3, 4, 10, 64, 6, 32, cuda)
    idx[0, :3] = torch.tensor([-1, 10, 1 << 30], dtype=torch.int32)
    idx[2] = -7
    got = tdbof.dbof_sampled_cluster_maxpool(x, idx, w, *vec)
    want = tdbof.dbof_cluster_maxpool_v2(
        tdbof.sampled_frames_plain(x, idx).contiguous(),
        w.to(torch.bfloat16), *vec)
    assert torch.equal(got, want)


# M, N and D that cut the redesigned tiles: 128 x 256 and the TMA store
# from D = 512, 128 x 128 and the 16-byte loads below.
DEQUANT_TILE_EDGES = [(m, d, n) for m in (1, 127, 129) for n in (7, 255, 257)
                      for d in (512, 1000, 1152, 64, 128, 200)]


@pytest.mark.parametrize("m,d,n", [(37, 128, 200), (5, 64, 7),
                                   (1000, 384, 96), (70, 512, 130),
                                   (9, 1000, 1000), (300, 1152, 4096),
                                   (4097, 1152, 257)] + DEQUANT_TILE_EDGES)
def test_cuda_dequant_matmul_matches_plain(cuda, m, d, n):
    g = torch.Generator().manual_seed(m + n)
    x = torch.randint(0, 256, (m, d), generator=g, dtype=torch.uint8)
    w = torch.randn(d, n, generator=g) * d ** -0.5
    scale = (4.0 / 255.0) * (0.5 + torch.rand(d, generator=g))
    bias = -2.0 + 0.1 * torch.randn(d, generator=g)
    args = [t.to(cuda) for t in (x, w, scale, bias)]
    before = tdq.dequant_affine_matmul.launches
    got = tdq.dequant_affine_matmul(*args)
    assert tdq.dequant_affine_matmul.launches == before + 1
    _close(got, tdq.dequant_affine_matmul_plain(*args),
           rel=1e-3 if d >= 512 else 1e-5)


def test_cuda_int8_and_dequant_reject_what_the_kernels_cannot_take(cuda):
    x, w8, a_col, b_col = _int8_args(0, 2, 3, 32, 16, cuda)
    with pytest.raises(ValueError):  # D = 24 is no multiple of 16
        tdbof.dbof_cluster_maxpool_int8(x[:, :, :24].contiguous(),
                                        w8[:24], a_col, b_col)
    with pytest.raises(ValueError):  # float frames
        tdbof.dbof_cluster_maxpool_int8(x.float(), w8, a_col, b_col)
    with pytest.raises(ValueError):  # D = 516 (bf16 route) no multiple of 8
        tdq.dequant_affine_matmul(
            torch.zeros(4, 516, dtype=torch.uint8, device=cuda),
            torch.zeros(516, 8, device=cuda), torch.ones(516, device=cuda),
            torch.zeros(516, device=cuda))


def test_cuda_dbof_int8_model_matches_cpu(cuda):
    """DbofModel with --dbof_int8_serving at small widths: one int8 launch
    and no v2 launch a batch; card and CPU within 2e-3."""
    hp = ModelHParams(vocab_size=40, feature_dim=96, max_frames=20,
                      dbof_cluster_size=64, dbof_hidden_size=32,
                      iterations=8, dbof_int8_serving=True)
    g = torch.Generator().manual_seed(4)
    feats = torch.randint(0, 256, (9, 20, 96), generator=g,
                          dtype=torch.uint8)
    nf = torch.randint(1, 21, (9,), generator=g, dtype=torch.int32)
    u = torch.rand(9, 8, generator=g)
    out = []
    for dev in (torch.device("cpu"), cuda):
        model = get_model("DbofModel", hp)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev).eval()
        before = (tdbof.dbof_cluster_maxpool_int8.launches,
                  tdbof.dbof_cluster_maxpool_v2.launches)
        with torch.no_grad():
            out.append(model(feats.to(dev), nf.to(dev),
                             u=u.to(dev))["predictions"].cpu())
        launched = (tdbof.dbof_cluster_maxpool_int8.launches - before[0],
                    tdbof.dbof_cluster_maxpool_v2.launches - before[1])
        assert launched == ((0, 0) if dev.type == "cpu" else (1, 0))
    assert (out[1] - out[0]).abs().max().item() <= 2e-3


# ---------------------------------------------------------------------------
# The TMA + wgmma products (csrc/hopper_gemm.cuh): the mainloop itself,
# DBoF and the MoE head at shapes that cut their tiles.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k,bn", [(128, 256, 64, 256), (1, 8, 8, 256),
                                      (200, 520, 1000, 256),
                                      (37, 136, 96, 136),
                                      (130, 272, 1152, 136),
                                      (300, 392, 2048, 96), (65, 96, 40, 96),
                                      (2048, 8192, 1152, 256)])
def test_cuda_hopper_gemm_matches_matmul(cuda, m, n, k, bn):
    """The mainloop's product (K-major A, MN-major B, the chains of the
    kernels' widths, TMA's zero fill past M, N and K) against
    torch.matmul in f32 on the same bf16 operands: only the summation
    order differs."""
    from yt8m_tpu_torch.kernels import _build

    g = torch.Generator().manual_seed(m + n + k)
    a = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
    b = torch.randn(k, n, generator=g).to(torch.bfloat16).to(cuda)
    c = torch.full((m, n), float("nan"), device=cuda)
    code = _build.library().yt8m_hopper_gemm(
        _build.ptr(a), _build.ptr(b), _build.ptr(c), m, n, k, bn,
        _build.current_stream(cuda))
    _build.check_launch("yt8m_hopper_gemm", code)
    torch.cuda.synchronize()
    _close(c, a.float() @ b.float(), rel=1e-5)


def test_cuda_plans_match_the_kernels(cuda):
    """The compiled kernels' tiles are the ones kernels/dbof.py ::
    plan and kernels/moe_head.py :: plan describe, on both routes."""
    got = tdbof.kernel_plan()
    p = tdbof.plan(2048, 30, 1152, 8192, sms=got["sms"])
    assert (got["videos"], got["pitch"], got["tile_clusters"], got["stages"],
            got["smem"]) == (tdbof.TILE_VIDEOS, tdbof.MAX_FRAMES_PER_VIDEO,
                             p["chain"], p["stages"], p["smem"])
    assert p["grid"] == min(p["tiles"], got["sms"])
    p = tdbof.plan(2048, 30, 1152, 8192, sms=got["sms"], f32=True)
    assert (got["f32_stages"], got["f32_smem"], got["f32_group"]) == (
        p["stages"], p["smem"], p["group"])
    for m in [*range(1, 18), 32, 63, 64, 121, 122, 200, 240]:
        for f32 in (False, True):
            got = tmoe.kernel_plan(m, f32)
            p = tmoe.plan(512, 2048, 4716, m, f32)
            assert got == {key: p[key] for key in (
                "classes", "gate", "expert", "stages", "smem", "stage_ld",
                "chunks")}, (m, f32)


def test_cuda_moe_refuses_unpitched_weights(cuda):
    """Weights whose row stride is no multiple of 8 raise (the wrapper
    pads no copy); weights whose rows are a multiple of 8 columns run
    contiguous."""
    x, wg, we, be = _moe_args(0, 4, 32, 83, 1, cuda)
    with pytest.raises(ValueError, match="pitched"):
        tmoe.moe_head_serving(x, wg.contiguous(), we, be, 1)
    x, wg, we, be = _moe_args(1, 70, 64, 40, 1, cuda)
    got = tmoe.moe_head_serving(x, wg.contiguous(), we.contiguous(), be, 1)
    _close(got, tmoe.moe_head_plain(x, wg, we, be, 1))


# ---------------------------------------------------------------------------
# The header's two new operand layouts and its TMA-store product; the
# redesigned dequant_affine_matmul and netvlad_core at shapes that cut
# their tiles.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a_mn,b_k", [(1, 0), (0, 0), (1, 1), (0, 1)],
                         ids=["a_mn", "b_k", "a_mn-b_k", "b_mn"])
@pytest.mark.parametrize("m,n,k", [(128, 128, 64), (8, 8, 8), (200, 136, 1000),
                                   (136, 296, 72), (64, 264, 520)])
def test_cuda_hopper_gemm_layouts_match_matmul(cuda, a_mn, b_k, m, n, k):
    """A MN-major (a stored [K, M], the VLAD forward's assignment) and B
    K-major (b stored [N, K], the VLAD backward's dvlad) against
    torch.matmul in f32 on the same bf16 operands, with TMA's zero fill
    past M, N and K: only the summation order differs."""
    from yt8m_tpu_torch.kernels import _build

    g = torch.Generator().manual_seed(m + n + k + 2 * a_mn + b_k)
    a = torch.randn(m, k, generator=g).to(torch.bfloat16).to(cuda)
    b = torch.randn(k, n, generator=g).to(torch.bfloat16).to(cuda)
    a_arg = a.t().contiguous() if a_mn else a
    b_arg = b.t().contiguous() if b_k else b
    c = torch.full((m, n), float("nan"), device=cuda)
    code = _build.library().yt8m_hopper_gemm_layouts(
        _build.ptr(a_arg), _build.ptr(b_arg), _build.ptr(c), m, n, k, a_mn,
        b_k, _build.current_stream(cuda))
    _build.check_launch("yt8m_hopper_gemm_layouts", code)
    torch.cuda.synchronize()
    _close(c, a.float() @ b.float(), rel=1e-5)


@pytest.mark.parametrize("batch,m,n,k", [(1, 128, 256, 64), (1, 1, 7, 8),
                                         (1, 129, 257, 1000),
                                         (1, 300, 4096, 1152),
                                         (3, 300, 1000, 100),
                                         (2, 65, 255, 72), (1, 4097, 260, 512)])
def test_cuda_hopper_product_matches_matmul(cuda, batch, m, n, k):
    """hopper_product.cuh's persistent product with the TMA-store epilogue
    (the store from registers when N % 4 != 0), batched, with rows and
    depth pitched to 8, against torch.matmul in f32 on the same bf16
    operands; nothing past [batch, M, N] is written."""
    from yt8m_tpu_torch.kernels import _build

    lda, ldb = -(-k // 8) * 8, -(-n // 8) * 8
    g = torch.Generator().manual_seed(batch + m + n + k)
    a = torch.randn(batch, m, lda, generator=g).to(torch.bfloat16).to(cuda)
    b = torch.randn(batch, k, ldb, generator=g).to(torch.bfloat16).to(cuda)
    buf = torch.full((batch * m * n + 64,), float("nan"), device=cuda)
    out = buf[:batch * m * n].view(batch, m, n)
    code = _build.library().yt8m_hopper_product(
        _build.ptr(a), _build.ptr(b), _build.ptr(out), batch, m, n, k, lda,
        ldb, _build.current_stream(cuda))
    _build.check_launch("yt8m_hopper_product", code)
    torch.cuda.synchronize()
    want = a[:, :, :k].float() @ b[:, :, :n].float()
    _close(out, want, rel=1e-5)
    assert torch.isnan(buf[batch * m * n:]).all()


@pytest.mark.parametrize("f", [1, 63, 65, 300])
@pytest.mark.parametrize("k", [8, 100, 256, 512])
def test_cuda_netvlad_core_tile_edges(cuda, k, f):
    """The forward and the backward (with and without dx) at K and F that
    cut the new tiles, with num_frames F, 0 and 1 planted, against the
    plain versions (1e-3 * max|ref| + 1e-6); frames past num_frames
    planted at 3e4 (act) and -1e5 (x) give the bits of zeros there, dact
    and dx are zeros past num_frames and num_frames = 0 gives vlad = 0."""
    b, d = 4, 264
    args, dvlad = _core_args(k + f, b, f, d, k, cuda)
    act, x, nf, centers = args
    past = torch.arange(f, device=cuda)[None, :] >= nf[:, None]
    loud = [torch.where(past[..., None], 3e4, act),
            torch.where(past[..., None], -1e5, x), nf, centers]
    clean = [act.masked_fill(past[..., None], 0),
             x.masked_fill(past[..., None], 0), nf, centers]
    vlad, a_sum = tnt.netvlad_core_forward(*loud)
    want_v, want_a = tnt.netvlad_core_plain_forward(*clean)
    _close(vlad, want_v)
    _close(a_sum, want_a)
    assert torch.all(vlad[1] == 0) and torch.all(a_sum[1] == 0)
    for got, want in zip((vlad, a_sum), tnt.netvlad_core_forward(*clean)):
        assert torch.equal(got, want)
    want_da, want_dx = tnt.netvlad_core_plain_backward(*clean, dvlad)
    for need_dx in (True, False):
        dact, dx = tnt.netvlad_core_backward(*loud, dvlad, need_dx)
        _close(dact, want_da)
        assert torch.all(dact[past] == 0)
        c_dact, c_dx = tnt.netvlad_core_backward(*clean, dvlad, need_dx)
        assert torch.equal(dact, c_dact)
        if need_dx:
            _close(dx, want_dx)
            assert torch.all(dx[past] == 0) and torch.equal(dx, c_dx)
        else:
            assert dx is None


def test_cuda_redesigned_plans_match_the_kernels(cuda):
    """The compiled tiles are the ones kernels/dequant_matmul.py :: plan
    and kernels/netvlad_train.py :: plan describe; D % 4 != 0 raises."""
    got = tdq.kernel_plan()
    p = tdq.plan(153600, 1152, 4096, sms=got["sms"])
    assert (got["rows"], got["cols"], got["stages"], got["smem"]) == (
        tdq.ROWS, tdq.COLS, p["stages"], p["smem"])
    q = tdq.plan(153600, 128, 1024)
    assert (got["f32_rows"], got["f32_cols"], got["f32_chunk"],
            got["f32_smem"]) == (tdq.F32_ROWS, tdq.F32_COLS, tdq.F32_CHUNK,
                                 q["smem"])
    got = tnt.kernel_plan()
    p128 = tnt.plan(256, 300, 256, 1152, sms=got["sms"])
    p256 = tnt.plan(2, 300, 512, 256, sms=got["sms"])
    assert (got["frames"], got["fwd_clusters"], got["fwd_cols"],
            got["fwd_stages"], got["fwd_smem"], got["assign_rows"]) == (
        tnt.FRAMES, tnt.FWD_CLUSTERS, tnt.FWD_COLS, tnt.FWD_STAGES,
        p128["fwd_smem"], tnt.ASSIGN_ROWS)
    assert (got["bwd_stages_128"], got["bwd_smem_128"]) == (
        p128["bwd_stages"], p128["bwd_smem"])
    assert (got["bwd_stages_256"], got["bwd_smem_256"]) == (
        p256["bwd_stages"], p256["bwd_smem"])
    args, _ = _core_args(1, 2, 5, 18, 8, cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        tnt.netvlad_core_forward(*args)


def test_cuda_nextvlad_plans_match_the_kernels(cuda):
    """The compiled NeXtVLAD tiles are the ones kernels/nextvlad.py ::
    plan describes, at every Kp."""
    got = tnv.kernel_plan()
    nf = torch.full((2,), 7, dtype=torch.int32)
    assert (got["rows"], got["cols"], got["wide_cols"]) == (
        tnv.TILE, tnv.COLS, tnv.WIDE_COLS)
    assert (got["rowprod_stages"], got["cluster_stages"],
            got["aggregate_stages"], got["dassign_stages"],
            got["dxg_stages"], got["wgrad_stages"]) == (tnv.STAGES,) * 6
    for k in (12, 96, 130, 256):  # Kp = 64, 128, 192, 256
        p = tnv.plan(nf, 7, 64, 128, 4, k, sms=got["sms"])
        kp = p["dims"]["Kp"]
        assert got[f"cluster_smem_{kp}"] == p["cluster"]["smem"]
        assert got[f"dassign_smem_{kp}"] == p["dassign"]["smem"]
    assert (got["rowprod_smem"], got["aggregate_smem"], got["dxg_smem"],
            got["wgrad_smem"]) == (p["expand"]["smem"],
                                   p["aggregate"]["smem"], p["dxg"]["smem"],
                                   p["wgrad_we"]["smem"])
    wide = tnv.plan(nf, 7, 64, 128, 4, 520, sms=got["sms"])  # Kp = 576
    assert got["wide_clusters"] == wide["cluster"]["cols"] == 256
    assert got["logits_stages"] == tnv.STAGES
    assert got["logits_smem"] == wide["cluster"]["smem"]
    assert got["dassign_smem_256"] == wide["dassign"]["smem"]


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_nextvlad_packed_rows_hold_the_layout(cuda, x_dtype):
    """The packed layout's hazards on the card: info is the layout's;
    every pad row (a run's rows past num_frames, the rows past the packed
    total to the tile's end) of xb, xe, the assignment, the softmax,
    d_act and d_xe is an exact zero; loud frames past num_frames leave
    every live row's streams bit for bit."""
    b, f, g, k = 9, 37, 8, 128
    x, nf, *w = _nextvlad_args(21, b, f, 64, 2, g, k, x_dtype, cuda)
    nf[4] = f  # a full video beside the planted f, 0 and 1
    past = torch.arange(f, device=cuda)[None, :] >= nf[:, None]
    loud = 255 if x_dtype == torch.uint8 else 1e4
    clean = x.masked_fill(past[..., None], 0)
    noisy = torch.where(past[..., None],
                        torch.as_tensor(loud, dtype=x.dtype, device=cuda), x)
    layout = tnv.kernel_layout(*w, g, training=True)
    dy = torch.randn(b, k, 16, generator=torch.Generator().manual_seed(2))
    runs = []
    for frames in (clean, noisy):
        _, res = tnvt.nextvlad_train_forward(frames, nf, layout)
        *_, t = tnvt.nextvlad_train_backward_with_scratch(
            nf, res, layout, dy.to(cuda))
        runs.append((res, t))
    (res, t), (res2, t2) = runs
    want = tnv.packed_info(nf.cpu(), f, g)
    end = want.numel()
    assert torch.equal(res["info"][:end].cpu(), want)
    pad = (want < 0).to(cuda)
    for name, src, other in (("xb", res, res2), ("xe", res, res2),
                             ("assign", res, res2), ("sm", res, res2),
                             ("dact", t, t2), ("dxe", t, t2)):
        rows = src[name][:end]
        assert torch.all(rows[pad] == 0), name
        assert torch.equal(rows, other[name][:end]), name


# ---------------------------------------------------------------------------
# The rest of the model zoo: each serving path on the card against the CPU,
# with the launches it must make (MoE widths are multiples of 32, as the
# card's MoE kernel needs).
# ---------------------------------------------------------------------------

ZOO = {  # name -> (MoE launches, DBoF v2, netvlad_aggregate) a batch
    "LogisticModel": (0, 0, 0), "MoeModel": (1, 0, 0),
    "FrameLevelLogisticModel": (0, 0, 0), "GatedDbofModel": (1, 1, 0),
    "SoftDbofModel": (1, 0, 0), "LayerNormLstmModel": (1, 0, 0),
    "FrameCnnModel": (1, 0, 0), "NetFVModel": (1, 0, 0),
    "ChainMoeModel": (3, 0, 0), "ChainFrameModel": (3, 0, 0),
    "ChainNetVladModel": (3, 0, 1), "DeepCombineChainModel": (3, 0, 0),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_cuda_zoo_models_match_cpu(cuda, name):
    from yt8m_tpu_torch.models import is_frame_level_model

    hp = ModelHParams(vocab_size=40, feature_dim=128, max_frames=30,
                      dbof_cluster_size=256, dbof_hidden_size=96,
                      lstm_cells=128, lstm_layers=2,
                      netvlad_cluster_size=64, netvlad_hidden_size=96,
                      cnn_filters=96, cnn_kernel=4, chain_hidden_size=64)
    model = get_model(name, hp)
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    if is_frame_level_model(name):
        feats = torch.randint(0, 256, (9, 30, 128), generator=g,
                              dtype=torch.uint8)
    else:
        feats = torch.randn(9, 128, generator=g)
    nf = torch.tensor([30, 1, 1, 7, 29, 30, 12, 3, 18], dtype=torch.int32)
    u = torch.rand(9, hp.iterations, generator=g)
    counters = (tmoe.moe_head_serving, tdbof.dbof_cluster_maxpool_v2,
                tvlad.netvlad_aggregate)
    before = [fn.launches for fn in counters]
    rec = tlstm.lstm_recurrence.launches
    with torch.inference_mode():
        want = model.eval()(feats, nf, u=u)["predictions"]
        got = model.to(cuda)(feats.to(cuda), nf.to(cuda),
                             u=u.to(cuda))["predictions"]
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counters, before)] == list(
        ZOO[name])
    assert tlstm.lstm_recurrence.launches == rec
    assert torch.isfinite(got).all()
    _close(got, want, rel=2e-3)


# name -> (MoE, DBoF v2, netvlad_aggregate, attention_pool) launches a batch
# at --compute_dtype=float32, every one on the f32 route; the recurrences
# and NeXtVLAD take their plain graphs at f32, as the JAX models do.
F32_ZOO = {
    **{name: (*launches, 0) for name, launches in ZOO.items()},
    "AttentionPoolingModel": (1, 0, 0, 1), "MultiHeadAttentionModel":
    (1, 0, 0, 0), "DbofModel": (1, 1, 0, 0), "NeXtVladModel": (1, 0, 0, 0),
    **{name: (1, 0, 0, 0) for name in ("LstmModel", "BiLstmModel",
                                       "GruModel", "BiGruModel")},
    **{name: (1, 0, 1, 0) for name in ("NetVladModel", "GatedNetVladModel",
                                       "NetVladLstmModel",
                                       "NetVladBiLstmModel")},
}


def test_f32_zoo_lists_every_model():
    from yt8m_tpu_torch.models import list_models

    assert sorted(F32_ZOO) == list_models()


@pytest.mark.parametrize("name", sorted(F32_ZOO))
def test_cuda_every_model_at_f32_matches_cpu(cuda, name):
    """Each model of the zoo served at --compute_dtype=float32 on the card
    (none raises), every launch of the four f32-capable wrappers on their
    f32 route, none of the recurrences' or NeXtVLAD's kernels; held to
    the CPU at f32 to 1e-5 max|ref|: only the order of the sums
    differs."""
    from yt8m_tpu_torch.models import is_frame_level_model

    hp = ModelHParams(vocab_size=40, feature_dim=128, max_frames=30,
                      dbof_cluster_size=256, dbof_hidden_size=96,
                      lstm_cells=128, lstm_layers=2,
                      netvlad_cluster_size=64, netvlad_hidden_size=96,
                      nextvlad_cluster_size=64, nextvlad_hidden_size=96,
                      nextvlad_groups=4, cnn_filters=96, cnn_kernel=4,
                      chain_hidden_size=64, compute_dtype="float32")
    model = get_model(name, hp)
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    if is_frame_level_model(name):
        feats = torch.randint(0, 256, (9, 30, 128), generator=g,
                              dtype=torch.uint8)
    else:
        feats = torch.randn(9, 128, generator=g)
    nf = torch.tensor([30, 0, 1, 7, 29, 30, 12, 3, 18], dtype=torch.int32)
    u = torch.rand(9, hp.iterations, generator=g)
    f32 = (tmoe.moe_head_serving, tdbof.dbof_cluster_maxpool_v2,
           tvlad.netvlad_aggregate, tap.attention_pool)
    others = (tlstm.lstm_recurrence, tgru.gru_recurrence,
              tnv.nextvlad_aggregate)
    before = [(fn.launches, fn.launches_f32) for fn in f32]
    rest = [fn.launches for fn in others]
    with torch.inference_mode():
        want = model.eval()(feats, nf, u=u)["predictions"]
        got = model.to(cuda)(feats.to(cuda), nf.to(cuda),
                             u=u.to(cuda))["predictions"]
    torch.cuda.synchronize()
    counts = [(fn.launches - n, fn.launches_f32 - n32)
              for fn, (n, n32) in zip(f32, before)]
    assert counts == [(n, n) for n in F32_ZOO[name]]
    assert [fn.launches for fn in others] == rest
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    got, want = got.cpu().double(), want.double()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.parametrize("name", sorted(F32_ZOO))
def test_cuda_every_model_at_f32_serves_at_the_defaults(cuda, name):
    """Each model at the JAX package's default widths (ModelHParams())
    and --compute_dtype=float32 serves 4 videos on the card: finite
    probabilities, the launches of the small-width test above, all on
    the f32 routes."""
    from yt8m_tpu_torch.models import is_frame_level_model

    hp = ModelHParams(compute_dtype="float32")
    model = get_model(name, hp)
    model.reset_parameters(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    if is_frame_level_model(name):
        feats = torch.randint(0, 256, (4, hp.max_frames, hp.feature_dim),
                              generator=g, dtype=torch.uint8)
    else:
        feats = torch.randn(4, hp.feature_dim, generator=g)
    nf = torch.tensor([hp.max_frames, 0, 1, 157], dtype=torch.int32)
    u = torch.rand(4, hp.iterations, generator=g)
    f32 = (tmoe.moe_head_serving, tdbof.dbof_cluster_maxpool_v2,
           tvlad.netvlad_aggregate, tap.attention_pool)
    others = (tlstm.lstm_recurrence, tgru.gru_recurrence,
              tnv.nextvlad_aggregate)
    before = [(fn.launches, fn.launches_f32) for fn in f32]
    rest = [fn.launches for fn in others]
    with torch.inference_mode():
        got = model.to(cuda).eval()(feats.to(cuda), nf.to(cuda),
                                    u=u.to(cuda))["predictions"]
    torch.cuda.synchronize()
    counts = [(fn.launches - n, fn.launches_f32 - n32)
              for fn, (n, n32) in zip(f32, before)]
    assert counts == [(n, n) for n in F32_ZOO[name]]
    assert [fn.launches for fn in others] == rest
    assert got.shape == (4, hp.vocab_size) and got.dtype == torch.float32
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# The f32 routes (--compute_dtype=float32)
# ---------------------------------------------------------------------------


def _f32_close(got, want, abs_=1e-5):
    got = got.detach().cpu().double()
    want = want.detach().cpu().double()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + abs_, err


def _dbof_serve(x, w, *vec):
    """dbof_cluster_maxpool_v2 with W's split copy on the f32 route."""
    split = split_weights(w) if w.dtype == torch.float32 else None
    return tdbof.dbof_cluster_maxpool_v2(x, w, *vec, split)


def _vlad_serve(x, nf, wc, *rest):
    """netvlad_aggregate with Wc's split copy on the f32 route."""
    split = split_weights(wc) if wc.dtype == torch.float32 else None
    return tvlad.netvlad_aggregate(x, nf, wc, *rest, split)


def _moe_serve(x, wg, we, be, m):
    """moe_head_serving with the weights' split copies on the f32
    route."""
    split = ((split_weights(wg), split_weights(we))
             if wg.dtype == torch.float32 else None)
    return tmoe.moe_head_serving(x, wg, we, be, m, split)


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,s,d,k", [(7, 5, 64, 200), (5, 30, 1152, 8192),
                                     (1, 1, 32, 8), (130, 31, 1152, 1000),
                                     (9, 40, 160, 2056), (6, 32, 96, 136)])
def test_cuda_f32_dbof_matches_plain(cuda, x_dtype, b, s, d, k):
    args = _dbof_args(b + k, b, s, d, k, x_dtype, cuda)
    args[1] = args[1].float()
    before = tdbof.dbof_cluster_maxpool_v2.launches
    got = _dbof_serve(*args)
    assert tdbof.dbof_cluster_maxpool_v2.launches == before + -(-s // 32)
    _f32_close(got, tdbof.dbof_cluster_maxpool_plain(*args))


def test_cuda_f32_dbof_masks_padded_frames(cuda):
    x, w, s_in, b_in, s_act, b_act = _dbof_args(0, 6, 7, 64, 64,
                                                torch.uint8, cuda)
    got = _dbof_serve(
        x, torch.full(w.shape, -1.0, device=cuda), torch.ones_like(s_in),
        torch.ones_like(b_in), s_act, torch.full_like(b_act, 3.0))
    assert torch.all(got == 0)


def test_cuda_f32_routes_refuse_a_missing_split(cuda):
    """The f32 routes on the card read the weights' split copies and
    raise, naming the helper, without them; no other route runs."""
    args = _dbof_args(0, 3, 5, 64, 64, torch.uint8, cuda)
    args[1] = args[1].float()
    with pytest.raises(ValueError, match="split_weights"):
        tdbof.dbof_cluster_maxpool_v2(*args)
    x, wg, we, be = _f32_moe_args(0, 5, 64, 9, 2, cuda)
    with pytest.raises(ValueError, match="split_weights"):
        tmoe.moe_head_serving(x, wg, we, be, 2)
    x, nf, wc, *rest = _vlad_args(0, 3, 20, 128, 16, torch.uint8, cuda)
    before = tvlad.netvlad_aggregate.launches
    with pytest.raises(ValueError, match="split_weights"):
        tvlad.netvlad_aggregate(x, nf, wc.float(), *rest)
    assert tvlad.netvlad_aggregate.launches == before


def _f32_moe_args(seed, b, h, c, m, dev):
    x, wg, we, be = _moe_args(seed, b, h, c, m, "cpu")
    return [x.to(dev), tmoe.pitched(wg.float().to(dev)),
            tmoe.pitched(we.float().to(dev)), be.to(dev)]


@pytest.mark.parametrize("m", [1, 2, 4, 16])
@pytest.mark.parametrize("b,h,c", [(37, 64, 83), (130, 1024, 4716),
                                   (512, 2048, 4716), (70, 1000, 44),
                                   (5, 999, 31)])
def test_cuda_f32_moe_matches_plain(cuda, m, b, h, c):
    args = _f32_moe_args(b + c + m, b, h, c, m, cuda)
    before = tmoe.moe_head_serving.launches
    got = _moe_serve(*args, m)
    assert tmoe.moe_head_serving.launches == before + 1
    _f32_close(got, tmoe.moe_head_plain(*args, m))


@pytest.mark.parametrize("h", [1000, 999, 40, 8])
def test_cuda_moe_takes_any_hidden_size(cuda, h):
    """The bf16 kernel at H no multiple of 32 (or of 8): x rounded at a
    pitch of H rounded up to 8, the depth past H read as TMA's zeros."""
    args = _moe_args(h, 70, h, 300, 2, cuda)
    _close(tmoe.moe_head_serving(*args, 2), tmoe.moe_head_plain(*args, 2))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,f,d,k", [(5, 13, 128, 8), (3, 300, 1152, 256),
                                     (1, 1, 128, 64), (3, 130, 256, 512),
                                     (4, 70, 100, 37), (6, 65, 1001, 130)])
def test_cuda_f32_netvlad_matches_plain(cuda, x_dtype, b, f, d, k):
    args = _vlad_args(b + f + k, b, f, d, k, x_dtype, cuda)
    args[2] = args[2].float()
    before = tvlad.netvlad_aggregate.launches
    got = _vlad_serve(*args)
    assert tvlad.netvlad_aggregate.launches == before + 1
    # The L2-normalised descriptor's values are small (1/sqrt(K*D) on
    # average): an absolute term of 1e-8 keeps a bf16 rounding out.
    _f32_close(got, tvlad.netvlad_aggregate_plain(*args), abs_=1e-8)
    if b > 2:
        assert torch.all(got[1] == 0)  # num_frames = 0


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_f32_netvlad_ignores_frames_past_num_frames(cuda, x_dtype):
    x, nf, wc, scale, bias, centers = _vlad_args(7, 6, 150, 256, 64,
                                                 x_dtype, cuda)
    past = torch.arange(150, device=cuda)[None, :] >= nf[:, None]
    loud = torch.where(past[..., None], torch.as_tensor(
        255 if x_dtype == torch.uint8 else 1e4, dtype=x.dtype, device=cuda),
        x)
    clean = x.masked_fill(past[..., None], 0)
    wc = wc.float()
    assert torch.equal(_vlad_serve(loud, nf, wc, scale, bias, centers),
                       _vlad_serve(clean, nf, wc, scale, bias, centers))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,f,d,h", [(5, 13, 32, 4), (3, 70, 1001, 3),
                                     (4, 20, 64, 19), (2, 1, 8, 1),
                                     (7, 300, 1152, 8), (6, 300, 1152, 16)])
def test_cuda_f32_attention_matches_plain(cuda, x_dtype, b, f, d, h):
    x, nf, q = _attention_args(b + f + d + h, b, f, d, h, x_dtype, cuda)
    q = q.float()
    before = tap.attention_pool.launches
    got = tap.attention_pool(x, nf, q)
    assert tap.attention_pool.launches == before + -(-h // tap.MAX_HEADS)
    _f32_close(got, tap.attention_pool_plain(x, nf, q))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_f32_attention_ignores_frames_past_num_frames(cuda, x_dtype):
    x, nf, q = _attention_args(3, 64, 300, 1152, 8, x_dtype, cuda)
    q = q.float()
    past = torch.arange(300, device=cuda)[None, :] >= nf[:, None]
    past[nf <= 0] = False  # an empty video averages all its rows
    loud = torch.where(past[..., None], torch.as_tensor(
        255 if x_dtype == torch.uint8 else 1e4, dtype=x.dtype, device=cuda),
        x)
    clean = x.masked_fill(past[..., None], 0)
    assert torch.equal(tap.attention_pool(loud, nf, q),
                       tap.attention_pool(clean, nf, q))


def test_cuda_f32_fused_netvlad_training_matches_cpu(cuda):
    """NetVladModel at --compute_dtype=float32 with --netvlad_fused_train:
    netvlad_core takes the f32 act and frames (it rounds its operands to
    bf16 at either dtype, as the JAX kernel does); one training forward
    and backward on the card and on the CPU: the loss within 2e-3
    relative, each gradient norm within 2e-2 (the bounds of the bf16
    training step above: the core's bf16 operands)."""
    hp = ModelHParams(vocab_size=40, feature_dim=128, max_frames=30,
                      netvlad_cluster_size=64, netvlad_hidden_size=96,
                      compute_dtype="float32", netvlad_fused_train=True)
    g = torch.Generator().manual_seed(3)
    batch = {
        "features": torch.randint(0, 256, (9, 30, 128), generator=g,
                                  dtype=torch.uint8),
        "num_frames": torch.tensor([30, 0, 1, 7, 29, 30, 12, 3, 18],
                                   dtype=torch.int32),
        "labels": (torch.rand(9, 40, generator=g) < 0.1).float(),
        "batch_mask": torch.ones(9),
    }
    results = []
    for dev in (torch.device("cpu"), cuda):
        model = get_model("NetVladModel", hp)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model.to(dev).train()
        before = (tnt.netvlad_core_forward.launches,
                  tnt.netvlad_core_backward.launches)
        total, _, _, _ = compute_loss(
            model, {k: v.to(dev) for k, v in batch.items()},
            get_loss("CrossEntropyLoss"))
        total.backward()
        if dev.type == "cuda":
            assert (tnt.netvlad_core_forward.launches,
                    tnt.netvlad_core_backward.launches) == (
                        before[0] + 1, before[1] + 1)
        results.append((total.item(), {
            n: p.grad.double().norm().item()
            for n, p in model.named_parameters()}))
    (cpu_loss, cpu_norms), (gpu_loss, gpu_norms) = results
    assert abs(gpu_loss - cpu_loss) <= 2e-3 * abs(cpu_loss)
    for n, v in cpu_norms.items():
        assert abs(gpu_norms[n] - v) <= 2e-2 * max(v, 1e-6), n


# ---------------------------------------------------------------------------
# Past the old limits: the MoE head at any M, NetVLAD serving and
# netvlad_core at any K, through their kernels (bf16 and f32 routes).
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [17, 32, 63, 64, 121, 122, 200, 240, 241])
@pytest.mark.parametrize("b,h,c", [(37, 64, 83), (130, 96, 9)])
def test_cuda_moe_any_mixtures(cuda, m, b, h, c):
    """The run-time tile up to M = 121 (every start offset of the bf16
    route), chunks of 120 mixtures above (the dummy gate alone in the
    last chunk at M = 240), on both routes, against the plain version
    with each route's bound."""
    for route, close in (("bf16", _close), ("f32", _f32_close)):
        args = (_moe_args if route == "bf16" else _f32_moe_args)(
            b + c + m, b, h, c, m, cuda)
        before = tmoe.moe_head_serving.launches
        got = _moe_serve(*args, m)
        assert tmoe.moe_head_serving.launches == before + 1
        close(got, tmoe.moe_head_plain(*args, m))


@pytest.mark.parametrize("m", [32, 200])
def test_cuda_moe_any_mixtures_clamps_large_logits(cuda, m):
    """Gate logits far past +-80 in every chunk: finite, the plain
    version's clamped ratio."""
    x, wg, we, be = _moe_args(m, 16, 64, 7, m, cuda)
    for dtype in (torch.bfloat16, torch.float32):
        g = tmoe.pitched((wg.float() * 400).to(dtype))
        e = tmoe.pitched(we.to(dtype))
        got = _moe_serve(x, g, e, be, m)
        assert torch.isfinite(got).all()
        _close(got, tmoe.moe_head_plain(x, g, e, be, m))


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,f,d,k", [(4, 70, 256, 520), (3, 300, 128, 1024),
                                     (2, 130, 256, 2048), (5, 13, 128, 1000)])
def test_cuda_netvlad_any_clusters(cuda, x_dtype, b, f, d, k):
    """K past one assignment block: the logits tiled over K, the softmax
    over all K in a second launch; bf16 and f32 routes against the plain
    version (num_frames F, and from B = 3 also 0 and 1, planted)."""
    args = _vlad_args(b + f + k, b, f, d, k, x_dtype, cuda)
    before = tvlad.netvlad_aggregate.launches
    got = tvlad.netvlad_aggregate(*args)
    assert tvlad.netvlad_aggregate.launches == before + 1
    _vlad_close(got, tvlad.netvlad_aggregate_plain(*args))
    assert b < 3 or torch.all(got[1] == 0)  # num_frames 0 from B = 3
    args[2] = args[2].float()
    got = _vlad_serve(*args)
    _f32_close(got, tvlad.netvlad_aggregate_plain(*args), abs_=1e-8)
    assert b < 3 or torch.all(got[1] == 0)


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_cuda_netvlad_any_clusters_hazards(cuda, x_dtype):
    """At K = 1024: frames past num_frames do not leak, a padded cluster
    (bias -1e30) and a cluster no frame is assigned to give zero rows;
    the scratch is written on the live chunks only."""
    x, nf, wc, scale, bias, centers = _vlad_args(9, 6, 300, 256, 1024,
                                                 x_dtype, cuda)
    bias[5] = -1e4
    bias[1023] = tvlad.PAD_CLUSTER_BIAS
    clean, loud = x.clone(), x.clone()
    for i, n in enumerate(nf.tolist()):
        clean[i, n:] = 0
        loud[i, n:] = 255 if x_dtype == torch.uint8 else 1e4
    got = tvlad.netvlad_aggregate(loud, nf, wc, scale, bias, centers)
    assert torch.equal(
        got, tvlad.netvlad_aggregate(clean, nf, wc, scale, bias, centers))
    assert torch.all(got[:, 5] == 0) and torch.all(got[:, 1023] == 0)
    assert torch.isfinite(got).all()
    _vlad_close(got, tvlad.netvlad_aggregate_plain(loud, nf, wc, scale,
                                                   bias, centers))
    nan = float("nan")
    out, xb, ka, colsum = tvlad._launch(
        loud, nf, wc, scale, bias, centers,
        lambda shape, dtype, device: torch.full(shape, nan, dtype=dtype,
                                                device=device))
    chunk = torch.arange(300, device=cuda) // 64
    live_chunk = chunk[None, :] < (nf[:, None] + 63) // 64
    assert torch.equal(~torch.isnan(ka.float()).all(-1), live_chunk)
    assert torch.equal(~torch.isnan(xb.float()).all(-1), live_chunk)
    past = torch.arange(300, device=cuda)[None, :] >= nf[:, None]
    assert torch.all(ka[live_chunk & past] == 0)
    assert torch.equal(out, got)


@pytest.mark.parametrize("b,f,d,k", [(3, 70, 256, 520), (2, 300, 128, 1024),
                                     (4, 65, 64, 1001), (2, 40, 32, 2048)])
def test_cuda_netvlad_core_any_clusters(cuda, b, f, d, k):
    """K past the backward's registers: the forward's softmax over fewer
    staged rows, the backward's Wide tiles and its row launch; forward,
    backward with and without dx, and a second run bit for bit."""
    args, dvlad = _core_args(b + f + d + k, b, f, d, k, cuda)
    vlad, a_sum = tnt.netvlad_core_forward(*args)
    want_v, want_a = tnt.netvlad_core_plain_forward(*args)
    _close(vlad, want_v)
    _close(a_sum, want_a)
    want_da, want_dx = tnt.netvlad_core_plain_backward(*args, dvlad)
    for need_dx in (True, False):
        dact, dx = tnt.netvlad_core_backward(*args, dvlad, need_dx)
        _close(dact, want_da)
        if need_dx:
            _close(dx, want_dx)
    again = tnt.netvlad_core_forward(*args)
    assert torch.equal(again[0], vlad) and torch.equal(again[1], a_sum)
    assert torch.equal(tnt.netvlad_core_backward(*args, dvlad)[0],
                       tnt.netvlad_core_backward(*args, dvlad)[0])
    got = _core_grads(args, dvlad)
    _close(got[1], want_da)
    nf = args[2]
    past = torch.arange(f, device=cuda)[None, :] >= nf[:, None]
    assert torch.all(got[1][past] == 0) and torch.all(got[2][past] == 0)


# ---------------------------------------------------------------------------
# The serving kernels as custom operators (kernels/ops.py) and the export.
# ---------------------------------------------------------------------------


def _op_args(name, dev):
    """Each operator's arguments at a small shape its kernel takes, on the
    card (bf16 weights: the bf16 routes; `f32` names the f32 routes)."""
    from yt8m_tpu_torch.kernels import ops  # noqa: F401  (registers)

    if name == "dbof_maxpool":
        return [*_dbof_args(1, 6, 5, 64, 64, torch.uint8, dev), []]
    if name == "dbof_maxpool:f32":
        x, w, *vec = _dbof_args(1, 6, 5, 64, 64, torch.uint8, dev)
        return [x, w.float(), *vec, [split_weights(w.float())]]
    if name == "dbof_maxpool_int8":
        return _int8_args(2, 7, 5, 64, 200, dev)
    if name == "moe_head":
        return [*_moe_args(3, 16, 64, 40, 2, dev), 2, []]
    if name == "moe_head:f32":
        x, wg, we, be = _f32_moe_args(3, 16, 64, 40, 2, dev)
        return [x, wg, we, be, 2, [split_weights(wg), split_weights(we)]]
    if name == "topk":
        return [torch.randn(9, 4716, generator=torch.Generator().manual_seed(
            4)).to(dev), 20]
    if name == "netvlad":
        return [*_vlad_args(5, 6, 70, 256, 64, torch.uint8, dev), []]
    if name == "netvlad:f32":
        x, nf, wc, *rest = _vlad_args(5, 6, 70, 256, 64, torch.uint8, dev)
        return [x, nf, wc.float(), *rest, [split_weights(wc.float())]]
    if name == "lstm":
        return [*_lstm_args(6, 12, 5, 128, dev), False]
    if name == "gru":
        return [*_gru_args(7, 12, 5, 128, dev), True]
    if name in ("attention_pool", "attention_pool:f32"):
        x, nf, q = _attention_args(8, 5, 40, 128, 4, torch.uint8, dev)
        return [x, nf, q.float() if name.endswith("f32") else q]
    if name == "nextvlad":
        x, nf, *w = _nextvlad_args(9, 3, 10, 16, 2, 4, 12, torch.uint8, dev)
        lay = tnv.kernel_layout(*w, 4)
        return [x, nf, *w, 4, torch.bfloat16,
                [lay["we"], lay["wc"], lay["wa"]]]
    if name == "frame_uniform":
        return [torch.zeros(6, 300, 8, dtype=torch.uint8, device=dev), 30, 0]
    raise KeyError(name)


OP_CASES = ["dbof_maxpool", "dbof_maxpool:f32", "dbof_maxpool_int8",
            "moe_head", "moe_head:f32", "topk", "netvlad", "netvlad:f32",
            "lstm", "gru", "attention_pool", "attention_pool:f32",
            "nextvlad", "frame_uniform"]


@pytest.mark.parametrize("case", OP_CASES)
def test_cuda_opcheck_serving_ops(cuda, case):
    """torch.library.opcheck on each serving operator with card tensors:
    its schema, its autograd registration, its fake implementation
    against the kernel's outputs, and its trace under a dynamic shape."""
    from yt8m_tpu_torch.kernels import ops

    op = ops.SERVING_OPS[case.split(":")[0]]
    args = _op_args(case, cuda)
    torch.library.opcheck(op, args)


def test_cuda_exported_dbof_model_serves_as_eager(cuda, tmp_path):
    """DbofModel at small widths exported with a dynamic batch on the
    card, loaded back, serving B = 5 and 64: the top-k of the eager step
    with a generator seeded 0, bit for bit, with the same launches a
    batch; two calls give the same bits."""
    from yt8m_tpu_torch.infer.export import export_model, load_serving
    from yt8m_tpu_torch.infer.predict import make_serving_step

    hp = ModelHParams(vocab_size=300, feature_dim=64, max_frames=40,
                      dbof_cluster_size=256, dbof_hidden_size=64,
                      iterations=12, moe_num_mixtures=2)
    model = get_model("DbofModel", hp)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    export_model(str(tmp_path / "dbof"), "DbofModel", hp, model)
    serve, meta = load_serving(str(tmp_path / "dbof"), cuda)
    assert meta["batch_size"] == 0 and meta["device"].startswith("cuda")
    step = make_serving_step(model, csv_top_k=20)
    g = torch.Generator().manual_seed(1)
    for b in (5, 64):
        x = torch.randint(0, 256, (b, 40, 64), generator=g,
                          dtype=torch.uint8).to(cuda)
        nf = torch.randint(1, 41, (b,), generator=g,
                           dtype=torch.int32).to(cuda)
        before = (tdbof.dbof_cluster_maxpool_v2.launches,
                  tmoe.moe_head_serving.launches, ttopk.exact_topk.launches)
        got = serve(x, nf)
        mid = (tdbof.dbof_cluster_maxpool_v2.launches,
               tmoe.moe_head_serving.launches, ttopk.exact_topk.launches)
        want = step(x, nf, torch.Generator(device=cuda).manual_seed(0))["csv"]
        after = (tdbof.dbof_cluster_maxpool_v2.launches,
                 tmoe.moe_head_serving.launches, ttopk.exact_topk.launches)
        assert [m - a for m, a in zip(mid, before)] == [1, 1, 1]
        assert [c - m for c, m in zip(after, mid)] == [1, 1, 1]
        assert got[0].is_cuda and torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])
        again = serve(x, nf)
        assert torch.equal(again[0], got[0])
