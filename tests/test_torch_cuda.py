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
"""

import numpy as np
import pytest
import torch

from yt8m_tpu_torch.cli import inference as cli
from yt8m_tpu_torch.convert import load_model, save_checkpoint
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.kernels import lstm as tlstm
from yt8m_tpu_torch.kernels import lstm_train as tlt
from yt8m_tpu_torch.kernels import moe_head as tmoe
from yt8m_tpu_torch.kernels import netvlad as tvlad
from yt8m_tpu_torch.kernels import netvlad_train as tnt
from yt8m_tpu_torch.kernels import topk as ttopk
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train.losses import get_loss
from yt8m_tpu_torch.train.step import compute_loss


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
                                     (5, 30, 1152, 8192), (1, 1, 32, 8)])
def test_cuda_dbof_matches_plain(cuda, x_dtype, b, s, d, k):
    args = _dbof_args(b + k, b, s, d, k, x_dtype, cuda)
    before = tdbof.dbof_cluster_maxpool_v2.launches
    got = tdbof.dbof_cluster_maxpool_v2(*args)
    assert tdbof.dbof_cluster_maxpool_v2.launches == before + 1
    _close(got, tdbof.dbof_cluster_maxpool_plain(*args))


def test_cuda_dbof_masks_padded_frames(cuda):
    """Every real row is negative before the ReLU; an unmasked zero
    padding row would give relu(act_bias) = 3."""
    x, w, s_in, b_in, s_act, b_act = _dbof_args(0, 6, 30, 64, 64,
                                                torch.uint8, cuda)
    w = torch.full_like(w, -1.0)
    got = tdbof.dbof_cluster_maxpool_v2(
        x, w, torch.ones_like(s_in), torch.ones_like(b_in), s_act,
        torch.full_like(b_act, 3.0))
    assert torch.all(got == 0)


def _moe_args(seed, b, h, c, m, dev):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, generator=g).abs()
    wg = torch.randn(h, c * (m + 1), generator=g) * h ** -0.5
    we = torch.randn(h, c * m, generator=g) * h ** -0.5
    be = 0.1 * torch.randn(c * m, generator=g)
    return [x.to(dev), wg.to(torch.bfloat16).to(dev),
            we.to(torch.bfloat16).to(dev), be.to(dev)]


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
    wg = (wg.float() * 400).to(torch.bfloat16)
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
                                   (512, 4716, 20), (2048, 4716, 20)])
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


def test_cuda_wrappers_reject_what_the_kernels_cannot_take(cuda):
    x = torch.zeros(2, 40, 64, dtype=torch.uint8, device=cuda)
    w = torch.zeros(64, 32, dtype=torch.bfloat16, device=cuda)
    v = torch.zeros(64, device=cuda)
    a = torch.zeros(32, device=cuda)
    with pytest.raises(ValueError):  # D = 48 is no multiple of 32
        tdbof.dbof_cluster_maxpool_v2(
            torch.zeros(2, 8, 48, dtype=torch.uint8, device=cuda), w[:48],
            v[:48], v[:48], a, a)
    with pytest.raises(ValueError):  # f32 weights: the kernel is bf16
        tdbof.dbof_cluster_maxpool_v2(x[:, :8].contiguous(), w.float(), v,
                                      v, a, a)
    with pytest.raises(ValueError):  # M = 17 is not built
        tmoe.moe_head_serving(*_moe_args(0, 4, 32, 8, 17, cuda), 17)


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
                                     (3, 300, 1152, 256), (1, 1, 128, 64)])
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
    with pytest.raises(ValueError):  # f32 weights: the kernel is bf16
        tvlad.netvlad_aggregate(x, nf, wc.float(), scale, bias, centers)
    with pytest.raises(ValueError):  # int64 frame counts
        tvlad.netvlad_aggregate(x, nf.long(), wc, scale, bias, centers)
    with pytest.raises(ValueError):  # K = 520 > 512
        args = _vlad_args(0, 2, 8, 128, 520, torch.float32, cuda)
        tvlad.netvlad_aggregate(*args)
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


@pytest.mark.parametrize("m", [3, 5, 8, 12, 16])
@pytest.mark.parametrize("b,h,c", [(37, 64, 83), (130, 1024, 4716)])
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
        for g, w in zip(got, want):
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
    assert tlt.lstm_train_forward.launches == launches[0] + f
    assert tlt.lstm_train_backward.launches == launches[1] + f
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


def _witness_forward(args, reverse, trainable):
    xp, nf, wh, bias = args
    if trainable:
        outs, gates, cs, c, h = tlt.lstm_train_forward(*args, reverse)
    else:
        outs, (c, h) = tlstm.lstm_recurrence(*args, reverse=reverse)
        outs = outs.to(torch.bfloat16)
    hs, gs, cc, (pc, ph) = tlt.forward_on_stream(outs, xp, nf, wh, bias,
                                                 reverse)
    streams = [(outs, hs)] + ([(gates, gs), (cs, cc)] if trainable else [])
    for kernel, plain in streams:
        _witness_holds(kernel, plain)
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
            assert tlt.lstm_train_forward.launches == before + 2 * 30
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
    args, _ = _core_args(1, 2, 5, 64, 600, cuda)
    with pytest.raises(ValueError, match="K <= 512"):
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
