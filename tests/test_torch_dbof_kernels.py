"""The port's DBoF v1 and sampled-gather kernel modules against the JAX
package's Pallas kernels (yt8m_tpu/kernels/dbof.py ::
dbof_cluster_maxpool, dbof_sampled_cluster_maxpool) in interpret mode
and the jnp oracle. No model calls either one; on the CPU each wrapper
runs its plain version. tests/test_torch_cuda.py holds the CUDA kernels
against the plain versions on the card.

Tolerance: max|diff| <= 1e-5 * max|ref|, plus the contraction term
against the Pallas kernels. Both sides apply the input affine in f32,
round it and w to bf16 at the same points and sum exact products in f32;
the summation order differs, and the interpret-mode kernels contract
x * in_scale + in_bias into one FMA where the port (and its CUDA kernel)
rounds the product first. A few affined inputs then lie on either side
of a bf16 rounding boundary; the test computes both roundings with numpy
and adds max_s sum_d |bf16(fma) - bf16(unfused)| |w| |act_scale| (as in
tests/test_torch_dequant_matmul.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.dbof import (
    dbof_cluster_maxpool as jax_v1,
    dbof_cluster_maxpool_reference,
    dbof_sampled_cluster_maxpool as jax_sampled,
)
from test_torch_dequant_matmul import contraction_term
from yt8m_tpu_torch.kernels import dbof as tdbof


def _close(got, want, extra=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * np.max(np.abs(want)) + 1e-7 + extra, err


def _contraction_term(x, w, s_in, b_in, s_act, b_act):
    """The largest move of a pooled value from the inputs whose fused and
    unfused affines round to different bf16 values (ReLU and max are
    1-Lipschitz)."""
    del b_act
    return contraction_term(x.reshape(-1, x.shape[-1]), s_in, b_in, w,
                            s_act)


def _vectors(rng, d, k, x_dtype):
    if x_dtype == "uint8":
        s_in = (4.0 / 255.0) * rng.uniform(0.5, 1.5, d)
        b_in = rng.normal(-2.0, 0.1, d)
    else:
        s_in = rng.uniform(0.5, 1.5, d)
        b_in = 0.1 * rng.normal(size=d)
    w = rng.normal(size=(d, k)) / np.sqrt(d)
    s_act = rng.uniform(0.5, 1.5, k)
    b_act = 0.1 * rng.normal(size=k)
    return [np.asarray(a, np.float32) for a in (w, s_in, b_in, s_act, b_act)]


def _frames(rng, shape, x_dtype):
    if x_dtype == "uint8":
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.normal(size=shape).astype(np.float32)


V1_SHAPES = [(5, 6, 32, 16), (3, 7, 64, 48), (4, 30, 96, 200),
             (2, 40, 128, 64)]


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,s,d,k", V1_SHAPES)
def test_v1_plain_matches_pallas_interpret(x_dtype, b, s, d, k):
    rng = np.random.default_rng(b + s + k)
    args = [_frames(rng, (b, s, d), x_dtype)] + _vectors(rng, d, k, x_dtype)
    want = jax_v1(*map(jnp.asarray, args), interpret=True, block_b=2,
                  block_k=k)
    got = tdbof.dbof_cluster_maxpool(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, _contraction_term(*args))


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_v1_plain_matches_jnp_oracle_and_v2(x_dtype):
    """v1 is v2 with w rounded to bf16 by the wrapper."""
    rng = np.random.default_rng(9)
    args = [_frames(rng, (4, 9, 64), x_dtype)] + _vectors(rng, 64, 32,
                                                              x_dtype)
    want = dbof_cluster_maxpool_reference(*map(jnp.asarray, args))
    t = list(map(torch.from_numpy, args))
    got = tdbof.dbof_cluster_maxpool(*t)
    _close(got.numpy(), want)
    v2 = tdbof.dbof_cluster_maxpool_v2(t[0], t[1].to(torch.bfloat16), *t[2:])
    assert torch.equal(got, v2)


def _sampled_args(seed, b, f, d, s, k):
    rng = np.random.default_rng(seed)
    x = _frames(rng, (b, f, d), "uint8")
    idx = rng.integers(0, f, (b, s)).astype(np.int32)
    return [x, idx] + _vectors(rng, d, k, "uint8")


SAMPLED_SHAPES = [(4, 20, 64, 7, 32), (3, 40, 128, 32, 64),
                  (2, 9, 32, 1, 16), (9, 300, 96, 30, 48)]


@pytest.mark.parametrize("b,f,d,s,k", SAMPLED_SHAPES)
def test_sampled_plain_matches_pallas_interpret(b, f, d, s, k):
    args = _sampled_args(b + f + s, b, f, d, s, k)
    want = jax_sampled(*map(jnp.asarray, args), interpret=True, block_b=4,
                       block_k=k)
    got = tdbof.dbof_sampled_cluster_maxpool(*map(torch.from_numpy, args))
    _close(got.numpy(), want, _sampled_contraction_term(args))


def _sampled_contraction_term(args):
    x, idx, *vec = args
    xs = tdbof.sampled_frames_plain(torch.from_numpy(x), torch.from_numpy(idx))
    return _contraction_term(xs.numpy(), *vec)


def test_sampled_equals_v1_on_the_gathered_frames():
    x, idx, *vec = map(torch.from_numpy, _sampled_args(1, 5, 30, 64, 12, 40))
    got = tdbof.dbof_sampled_cluster_maxpool(x, idx, *vec)
    rows = torch.arange(5)[:, None]
    want = tdbof.dbof_cluster_maxpool(x[rows, idx.long()], *vec)
    assert torch.equal(got, want)


def test_sampled_out_of_range_indices_select_a_zero_frame():
    """The TPU kernel's one-hot select gives a zero frame for an index
    outside [0, F); so does the port, without reading out of bounds."""
    args = _sampled_args(2, 4, 10, 64, 6, 32)
    idx = args[1]
    idx[0, :3] = [-1, 10, 1 << 20]
    idx[2, :] = -5
    want = jax_sampled(*map(jnp.asarray, args), interpret=True, block_b=2,
                       block_k=32)
    t = list(map(torch.from_numpy, args))
    got = tdbof.dbof_sampled_cluster_maxpool(*t)
    _close(got.numpy(), want, _sampled_contraction_term(args))
    xs = tdbof.sampled_frames_plain(t[0], t[1])
    assert torch.all(xs[0, :3] == 0) and torch.all(xs[2] == 0)
    assert torch.equal(xs[1], t[0][1][t[1][1].long()])


def test_sampled_rejects_what_the_tpu_kernel_rejects():
    x, idx, *vec = map(torch.from_numpy, _sampled_args(3, 2, 40, 32, 33, 16))
    with pytest.raises(ValueError, match="num samples 33"):
        tdbof.dbof_sampled_cluster_maxpool(x, idx, *vec)
    with pytest.raises(ValueError, match="uint8"):
        tdbof.dbof_sampled_cluster_maxpool(x.float(), idx[:, :4], *vec)


def test_cpu_calls_count_no_launches():
    x, idx, *vec = map(torch.from_numpy, _sampled_args(4, 2, 8, 32, 4, 16))
    before = (tdbof.dbof_cluster_maxpool.launches,
              tdbof.dbof_sampled_cluster_maxpool.launches)
    tdbof.dbof_sampled_cluster_maxpool(x, idx, *vec)
    tdbof.dbof_cluster_maxpool(x, *vec)
    assert (tdbof.dbof_cluster_maxpool.launches,
            tdbof.dbof_sampled_cluster_maxpool.launches) == before
