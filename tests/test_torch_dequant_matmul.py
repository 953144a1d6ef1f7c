"""The port's dequant_affine_matmul (yt8m_tpu_torch/kernels/dequant_matmul.py)
against the JAX package's Pallas kernel (yt8m_tpu/kernels/dequant_matmul.py)
in interpret mode and its jnp oracle. No model calls it; on the CPU the
wrapper runs its plain version. tests/test_torch_cuda.py holds the CUDA
kernel against the plain version on the card.

Tolerance: max|diff| <= 1e-5 * max|ref| for both compute dtypes (bf16
operands from D = 512, f32 below), plus the contraction term. Both sides
apply the affine in f32 and round the same operands to the compute
dtype; the f32 summation order differs, and the interpret-mode Pallas
kernel contracts x * scale + bias into one FMA where the port rounds the
product first. In bf16 a few affined inputs then lie on either side of a
rounding boundary and differ by one bf16 step; the test computes both
roundings with numpy and adds sum_d |bf16(fma) - bf16(unfused)| |w| to
the bound (0 where no input flips).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.dequant_matmul import (
    dequant_affine_matmul as jax_dequant,
    dequant_affine_matmul_reference,
)
from yt8m_tpu_torch.kernels import dequant_matmul as tdq


def _args(seed, m, d, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(m, d), dtype=np.uint8)
    w = (rng.normal(size=(d, n)) / np.sqrt(d)).astype(np.float32)
    scale = ((4.0 / 255.0) * rng.uniform(0.5, 1.5, d)).astype(np.float32)
    bias = rng.normal(-2.0, 0.1, d).astype(np.float32)
    return x, w, scale, bias


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


def contraction_term(x, scale, bias, w, col_scale=1.0):
    """|y| moved by the inputs whose fused and unfused affines round to
    different bf16 values: the largest element of sum_d |bf16(fma) -
    bf16(unfused)| |bf16(w)|, times |col_scale| per column. x [M, D]."""
    xf = x.astype(np.float32)
    unfused = xf * scale + bias
    fused = (xf.astype(np.float64) * scale + bias).astype(np.float32)
    flips = np.abs(_bf16(fused) - _bf16(unfused))
    moved = (flips @ np.abs(_bf16(w))) * np.abs(col_scale)
    return float(np.max(moved, initial=0.0))


def _close(got, want, extra=0.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * np.max(np.abs(want)) + 1e-7 + extra, err


# (M, D, N): f32 below D = 512, bf16 from it; M and N ragged.
SHAPES = [(37, 128, 200), (5, 64, 7), (130, 384, 96), (70, 512, 130),
          (9, 640, 1000), (1, 1024, 33), (300, 1152, 256)]


@pytest.mark.parametrize("m,d,n", SHAPES)
def test_plain_matches_pallas_interpret(m, d, n):
    args = _args(m + d + n, m, d, n)
    want = jax_dequant(*map(jnp.asarray, args), block_m=32, block_n=128,
                       interpret=True)
    got = tdq.dequant_affine_matmul(*map(torch.from_numpy, args))
    assert got.dtype == torch.float32
    x, w, scale, bias = args
    extra = contraction_term(x, scale, bias, w) if d >= 512 else 0.0
    _close(got.numpy(), want, extra)


@pytest.mark.parametrize("d", [256, 511, 512, 768])
def test_compute_dtype_follows_the_tpu_kernel(d):
    args = _args(d, 16, d, 24)
    want_dt = jnp.bfloat16 if d >= 512 else jnp.float32
    assert tdq.compute_dtype(d) == (torch.bfloat16 if d >= 512
                                    else torch.float32)
    want = dequant_affine_matmul_reference(*map(jnp.asarray, args),
                                           compute_dtype=want_dt)
    got = tdq.dequant_affine_matmul(*map(torch.from_numpy, args))
    _close(got.numpy(), want)


def test_shape_checks_and_no_cpu_launch_count():
    x, w, scale, bias = map(torch.from_numpy, _args(0, 4, 64, 8))
    with pytest.raises(ValueError):
        tdq.dequant_affine_matmul(x[0], w, scale, bias)
    with pytest.raises(ValueError):
        tdq.dequant_affine_matmul(x, w[:32], scale, bias)
    before = tdq.dequant_affine_matmul.launches
    tdq.dequant_affine_matmul(x, w, scale, bias)
    assert tdq.dequant_affine_matmul.launches == before
