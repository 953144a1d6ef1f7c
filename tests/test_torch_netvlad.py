"""The port's NetVLAD aggregation (yt8m_tpu_torch/kernels/netvlad.py) and
frame helpers against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; the JAX side runs
the Pallas kernel in interpret mode (which pads F to a multiple of 8), or
its jnp oracle. The same inputs, made with numpy from a seed, go to both.
Tolerance: max|diff| <= 1e-5 * max|ref| + 1e-7. Both sides round the same
operands to the compute dtype at the same points; only the f32 summation
order differs. tests/test_torch_cuda.py holds the CUDA kernel against the
plain version on the card.

Dequantization: the port (and the JAX oracle) round x * scale and then
+ bias; the Pallas kernel, traced under jit on the CPU, contracts the two
into one fused multiply-add. The one-ulp difference moves some frames by
one bf16 step before the products (kernel vs its own oracle: 5e-4 on
unit-norm outputs). So the port's uint8 path is held against the oracle,
and the interpret-mode kernel is given the frames the port dequantized.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.netvlad import (
    netvlad_aggregate as jax_netvlad,
    netvlad_aggregate_reference,
)
from yt8m_tpu.models import frame_utils as jfu
from yt8m_tpu_torch.kernels import netvlad as tvlad
from yt8m_tpu_torch.models import frame_utils as tfu

B, F, D, K = 4, 13, 32, 8
NUM_FRAMES = np.array([13, 1, 0, 7], np.int32)


def _close(got, want, rel=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)) + 1e-7, err


def _inputs(seed, x_dtype, f=F):
    rng = np.random.default_rng(seed)
    if x_dtype == "uint8":
        x = rng.integers(0, 256, size=(B, f, D), dtype=np.uint8)
    else:
        x = rng.normal(size=(B, f, D)).astype(np.float32)
    wc = (rng.normal(size=(D, K)) / np.sqrt(D)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, K).astype(np.float32)
    bias = (0.3 * rng.normal(size=K)).astype(np.float32)
    centers = (rng.normal(size=(K, D)) / np.sqrt(D)).astype(np.float32)
    return x, NUM_FRAMES, wc, scale, bias, centers


def _port(args, w_dtype=torch.bfloat16):
    x, nf, wc, scale, bias, centers = map(torch.from_numpy, args)
    return tvlad.netvlad_aggregate(x, nf, wc.to(w_dtype), scale, bias,
                                   centers).numpy()


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_netvlad_plain_matches_pallas_interpret(x_dtype):
    args = _inputs(1, x_dtype)
    frames = tfu.ensure_float(torch.from_numpy(args[0])).numpy()
    want = jax_netvlad(*map(jnp.asarray, (frames,) + args[1:]),
                       interpret=True)
    got = _port(args)
    assert got.shape == (B, K, D) and got.dtype == np.float32
    _close(got, np.asarray(want))
    # num_frames 0 gives exact zeros; the others are unit vectors.
    assert np.all(got[2] == 0)
    np.testing.assert_allclose(
        np.linalg.norm(got.reshape(B, -1)[[0, 1, 3]], axis=1), 1.0,
        atol=1e-5)


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_netvlad_plain_matches_jnp_oracle(x_dtype):
    args = _inputs(2, x_dtype, f=16)
    want = netvlad_aggregate_reference(*map(jnp.asarray, args))
    _close(_port(args), np.asarray(want))


def test_netvlad_plain_float32_compute_matches_pallas_interpret():
    args = _inputs(3, "float32")
    want = jax_netvlad(*map(jnp.asarray, args), interpret=True,
                       dtype=jnp.float32)
    _close(_port(args, torch.float32), np.asarray(want))


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_netvlad_frames_past_num_frames_do_not_leak(x_dtype):
    args = list(_inputs(4, x_dtype))
    clean = args[0].copy()
    loud = args[0].copy()
    for i, n in enumerate(NUM_FRAMES):
        clean[i, n:] = 0
        loud[i, n:] = 255 if x_dtype == "uint8" else 1e4
    got_clean = _port([clean] + args[1:])
    got_loud = _port([loud] + args[1:])
    np.testing.assert_array_equal(got_loud, got_clean)


def test_netvlad_cluster_with_no_assignment_is_zero():
    x, nf, wc, scale, bias, centers = _inputs(5, "float32")
    bias = bias.copy()
    bias[3] = -1e4  # softmax weight exactly 0 for every frame
    got = _port((x, nf, wc, scale, bias, centers))
    assert np.all(got[:, 3] == 0)
    want = jax_netvlad(*map(jnp.asarray, (x, nf, wc, scale, bias, centers)),
                       interpret=True)
    _close(got, np.asarray(want))


@pytest.mark.parametrize("method", ["max", "mean", "average"])
def test_masked_frame_pooling_matches_jax(method):
    rng = np.random.default_rng(6)
    frames = rng.normal(size=(B, F, 5)).astype(np.float32)
    mask = (np.arange(F)[None, :] < NUM_FRAMES[:, None]).astype(np.float32)
    want = jfu.frame_pooling(jnp.asarray(frames), method, jnp.asarray(mask))
    got = tfu.frame_pooling(torch.from_numpy(frames), method,
                            torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


def test_l2_normalize_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 6, 5)).astype(np.float32)
    x[1] = 0.0
    x[2, 0] = 1e-8
    for axis in (1, 2):
        want = jfu.l2_normalize(jnp.asarray(x), axis=axis)
        got = tfu.l2_normalize(torch.from_numpy(x), dim=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=0)
    assert np.all(tfu.l2_normalize(torch.from_numpy(x), dim=2).numpy()[1]
                  == 0)
