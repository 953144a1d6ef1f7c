"""The port's kernel modules (yt8m_tpu_torch/kernels) against the JAX
package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode, or its jnp oracle. The same inputs,
made with numpy from a seed, go to both. Tolerances:
  * DBoF and MoE: max|diff| <= 1e-5 * max|ref|. Both sides round the same
    operands to the compute dtype; only the f32 summation order differs.
  * top-k: values bitwise equal and indices equal, ties, NaN and -inf
    rows included.
tests/test_torch_cuda.py holds each CUDA kernel against its plain
version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.dbof import (
    dbof_cluster_maxpool_reference,
    dbof_cluster_maxpool_v2 as jax_dbof_v2,
)
from yt8m_tpu.kernels.moe_head import moe_head_serving as jax_moe
from yt8m_tpu.kernels.topk import TOPK_NEG as JAX_TOPK_NEG
from yt8m_tpu.kernels.topk import exact_topk as jax_exact_topk
from yt8m_tpu.kernels.topk import serving_topk as jax_serving_topk
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.kernels import moe_head as tmoe
from yt8m_tpu_torch.kernels import topk as ttopk


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)) + 1e-7, err


def _dbof_inputs(seed, b, s, d, k, x_dtype):
    rng = np.random.default_rng(seed)
    if x_dtype == "uint8":
        x = rng.integers(0, 256, size=(b, s, d), dtype=np.uint8)
        s_in = (4.0 / 255.0) * rng.uniform(0.5, 1.5, d)
    else:
        x = rng.normal(size=(b, s, d)).astype(np.float32)
        s_in = rng.uniform(0.5, 1.5, d)
    w = rng.normal(size=(d, k)) / np.sqrt(d)
    b_in = rng.normal(size=(d,)) * 0.1
    s_act = rng.uniform(0.5, 1.5, k)
    b_act = rng.normal(size=(k,)) * 0.1
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return x, f32(w), f32(s_in), f32(b_in), f32(s_act), f32(b_act)


def _torch_dbof_args(args, w_dtype):
    x, w, s_in, b_in, s_act, b_act = map(torch.from_numpy, args)
    return (x, w.to(w_dtype), s_in, b_in, s_act, b_act)


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,s,d,k", [(5, 6, 128, 64), (3, 8, 1152, 96)])
def test_dbof_plain_matches_pallas_interpret(x_dtype, b, s, d, k):
    args = _dbof_inputs(b + s + k, b, s, d, k, x_dtype)
    want = jax_dbof_v2(*map(jnp.asarray, args), interpret=True, block_b=2,
                       block_k=32)
    got = tdbof.dbof_cluster_maxpool_v2(
        *_torch_dbof_args(args, torch.bfloat16))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_dbof_plain_matches_jnp_oracle(x_dtype):
    args = _dbof_inputs(3, 4, 7, 256, 64, x_dtype)
    want = dbof_cluster_maxpool_reference(*map(jnp.asarray, args))
    got = tdbof.dbof_cluster_maxpool_plain(
        *_torch_dbof_args(args, torch.bfloat16))
    _close(got.numpy(), np.asarray(want))


def test_dbof_float32_compute_matches_pallas():
    args = _dbof_inputs(11, 3, 5, 64, 32, "uint8")
    want = jax_dbof_v2(*map(jnp.asarray, args), interpret=True, block_b=2,
                       dtype=jnp.float32)
    got = tdbof.dbof_cluster_maxpool_v2(
        *_torch_dbof_args(args, torch.float32))
    _close(got.numpy(), np.asarray(want))


def test_dbof_wrapper_checks_shapes():
    args = _torch_dbof_args(_dbof_inputs(0, 2, 3, 32, 16, "uint8"),
                            torch.bfloat16)
    with pytest.raises(ValueError):
        tdbof.dbof_cluster_maxpool_v2(args[0][0], *args[1:])
    with pytest.raises(ValueError):
        tdbof.dbof_cluster_maxpool_v2(args[0], args[1][:16], *args[2:])


def test_dbof_cpu_does_not_count_launches():
    before = tdbof.dbof_cluster_maxpool_v2.launches
    tdbof.dbof_cluster_maxpool_v2(*_torch_dbof_args(
        _dbof_inputs(0, 2, 3, 32, 16, "uint8"), torch.bfloat16))
    assert tdbof.dbof_cluster_maxpool_v2.launches == before


def _moe_inputs(seed, b, h, c, m):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(b, h))).astype(np.float32)
    wg = (rng.normal(size=(h, c * (m + 1))) / np.sqrt(h)).astype(np.float32)
    we = (rng.normal(size=(h, c * m)) / np.sqrt(h)).astype(np.float32)
    be = (rng.normal(size=(c * m,)) * 0.1).astype(np.float32)
    return x, wg, we, be


@pytest.mark.parametrize("m", [1, 2, 4])
@pytest.mark.parametrize("b,h,c", [(16, 32, 40), (37, 64, 83)])
def test_moe_plain_matches_pallas_interpret(m, b, h, c):
    x, wg, we, be = _moe_inputs(b + c + m, b, h, c, m)
    want = jax_moe(*map(jnp.asarray, (x, wg, we, be)), m,
                   dtype=jnp.bfloat16, interpret=True, block_b=16,
                   block_c=32)
    got = tmoe.moe_head_serving(
        torch.from_numpy(x), torch.from_numpy(wg).to(torch.bfloat16),
        torch.from_numpy(we).to(torch.bfloat16), torch.from_numpy(be), m)
    _close(got.numpy(), np.asarray(want))


def test_moe_clamped_logits_match_pallas():
    """Logits far beyond +-80: both sides clamp, ratios stay finite."""
    x, wg, we, be = _moe_inputs(5, 8, 32, 24, 2)
    wg = wg * 500.0
    want = jax_moe(*map(jnp.asarray, (x, wg, we, be)), 2,
                   dtype=jnp.float32, interpret=True, block_b=8,
                   block_c=24)
    got = tmoe.moe_head_serving(*map(torch.from_numpy, (x, wg, we, be)), 2)
    assert torch.isfinite(got).all()
    _close(got.numpy(), np.asarray(want))


def _topk_cases():
    rng = np.random.default_rng(0)
    plain = rng.random((37, 301)).astype(np.float32)
    ties = np.repeat(rng.random((8, 40)), 3, axis=1).astype(np.float32)
    special = rng.random((6, 130)).astype(np.float32)
    special[0, ::7] = np.nan
    special[0, 3] = np.nan
    special[1, ::3] = -np.inf
    special[2] = -3.4e38
    special[2, 10:20] = np.nan
    special[3] = 0.5
    special[4, :50] = -np.inf
    special[4, 50:] = -3.0e38
    special[5, 1::2] = np.inf
    return {"plain": (plain, 20), "ties": (ties, 10),
            "special": (special, 20), "k1": (plain[:8], 1),
            "k128": (rng.random((4, 300)).astype(np.float32), 128)}


@pytest.mark.parametrize("case", sorted(_topk_cases()))
def test_topk_plain_matches_pallas_interpret_exactly(case):
    x, k = _topk_cases()[case]
    want_v, want_i = jax_exact_topk(jnp.asarray(x), k, interpret=True,
                                    block_b=8)
    got_v, got_i = ttopk.exact_topk(torch.from_numpy(x), k)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_topk_neg_matches_reference_constant():
    assert np.float32(ttopk.TOPK_NEG) == np.float32(JAX_TOPK_NEG)


def test_topk_k_bound_and_range():
    with pytest.raises(ValueError):
        ttopk.exact_topk(torch.zeros(4, 300), 129)
    with pytest.raises(ValueError):
        ttopk.exact_topk(torch.zeros(4, 10), 11)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "planted_ties"])
def test_serving_topk_above_128_matches_jax(ties):
    """k = 200 > 128: the JAX package's serving_topk takes its exact XLA
    op there; the port's serving_topk its library op stable_sort_topk (a
    stable sort). Values and indices equal."""
    rng = np.random.default_rng(7)
    x = rng.random((2, 4716)).astype(np.float32)
    if ties:
        x[0] = np.repeat(rng.random(4716 // 4 + 1), 4)[:4716]
        x[1, ::3] = 0.5
    want_v, want_i = jax_serving_topk(jnp.asarray(x), 200)
    got_v, got_i = ttopk.serving_topk(torch.from_numpy(x), 200)
    assert got_v.shape == (2, 200) and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_serving_topk_matches_lax_top_k_on_finite_rows():
    x = np.random.default_rng(4).random((16, 4716)).astype(np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 20)
    got_v, got_i = ttopk.serving_topk(torch.from_numpy(x), 20)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_mixed_devices_raise():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        tmoe.moe_head_serving(x, torch.zeros(8, 6, device="meta"),
                              torch.zeros(8, 4), torch.zeros(4), 1)


@pytest.mark.parametrize("x_dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("d,k", [(100, 13), (128, 100), (1000, 16)])
def test_netvlad_padding_for_the_card_is_exact(x_dtype, d, k):
    """The card's wrapper pads D to a multiple of 128 and K to one of 8;
    on the plain version the padded problem gives the same descriptors
    (to f32 summation order) and zero rows and columns where padded."""
    from yt8m_tpu_torch.kernels import netvlad as tvlad

    rng = np.random.default_rng(d + k)
    if x_dtype == np.uint8:
        x = rng.integers(0, 256, size=(3, 10, d), dtype=np.uint8)
    else:
        x = rng.normal(size=(3, 10, d)).astype(np.float32)
    nf = torch.tensor([10, 0, 4], dtype=torch.int32)
    w = torch.from_numpy(rng.normal(0, d ** -0.5, (d, k)).astype(
        np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, k).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, k).astype(np.float32))
    centers = torch.from_numpy(rng.normal(0, d ** -0.5, (k, d)).astype(
        np.float32))
    args = (torch.from_numpy(x), w, scale, bias, centers)
    want = tvlad.netvlad_aggregate_plain(args[0], nf, *args[1:])
    xp, wp, sp, bp, cp = tvlad.pad_operands(*args)
    assert xp.shape[2] % 128 == 0 and wp.shape[1] % 8 == 0
    got = tvlad.netvlad_aggregate_plain(xp, nf, wp, sp, bp, cp)
    assert torch.all(got[:, k:] == 0) and torch.all(got[:, :, d:] == 0)
    _close(got[:, :k, :d].numpy(), want.numpy())


def test_lstm_padding_for_the_card_is_exact():
    """H padded to a multiple of 64 with zero weights: the real units'
    outputs and state as without padding (to the f32 summation order of
    the wider product), the padded units exactly 0."""
    from yt8m_tpu_torch.kernels import lstm as tlstm

    rng = np.random.default_rng(5)
    f, b, h = 7, 4, 24
    xp = torch.from_numpy(rng.normal(0, .5, (f, b, 4 * h)).astype(np.float32))
    wh = torch.from_numpy(rng.normal(0, .2, (h, 4 * h)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, .1, 4 * h).astype(np.float32))
    nf = torch.tensor([7, 0, 1, 4], dtype=torch.int32)
    xq, wq, bq = tlstm.pad_units(64, xp, wh, bias)
    assert xq.shape == (f, b, 256) and wq.shape == (64, 256)
    for reverse in (False, True):
        outs, (c, hh) = tlstm.lstm_recurrence_plain(xp, nf, wh, bias, reverse)
        o2, (c2, h2) = tlstm.lstm_recurrence_plain(xq, nf, wq, bq, reverse)
        for got, want in ((o2[..., :h], outs), (c2[:, :h], c),
                          (h2[:, :h], hh)):
            _close(got.numpy(), want.numpy())
        assert torch.all(o2[..., h:] == 0) and torch.all(c2[:, h:] == 0)
