"""The port's attention pooling (yt8m_tpu_torch/kernels/attention_pool.py)
and its attention models (models/attention.py) against the JAX package.

On the CPU the pooling wrapper runs its plain PyTorch version. The JAX
model reaches its Pallas kernel only on a TPU backend (the JAX package's
models/attention.py:51), so the pooling is held directly against the
JAX kernel in interpret mode and against its jnp reference, and the
models against the JAX models' graph. The same inputs, made with numpy
from a seed, go to both. Tolerances:
  * attention_pool_plain against attention_pool_reference: max|diff| <=
    1e-3 * max|ref| + 1e-5. Both round x, Q and the attention to bf16 at
    the same points; the softmax's f32 sums run in another order, which
    can move a bf16 attention weight one step at a rounding boundary.
  * against the JAX kernel in interpret mode: the JAX test's own 2e-2 *
    max|ref| (tests/test_kernels.py), for num_frames >= 1. At num_frames
    = 0 the JAX kernel averages F rounded up to a multiple of 8 rows,
    the padded ones dequantized from uint8 zeros; the port follows the
    reference and the JAX model's graph, the mean over the F rows.
  * the models' predictions, eval and training mode: 1e-5 at float32,
    3e-3 at bf16 (a last-bit difference before a bf16 rounding moves an
    operand one bf16 step; docs/KERNELS.md, "bf16 divergence vs XLA").
  * one SGD step: at float32 every variable and BatchNorm statistic
    within 1e-5 * max(1, max|ref|) (tests/test_torch_train.py's
    trajectory bound); at bf16 the loss within 3e-3 and each variable's
    move within 2e-2 of its largest move (the bound that file holds the
    bf16 LSTM family to).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as train_tests
from yt8m_tpu.kernels.attention_pool import (
    attention_pool as jax_pool,
    attention_pool_reference,
)
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.kernels import attention_pool as tap
from yt8m_tpu_torch.models import ModelHParams, get_model

B, F, D, H = 4, 13, 32, 4
NUM_FRAMES = np.array([13, 5, 1, 9], np.int32)


def _inputs(seed, dtype, b=B, f=F, d=D, h=H):
    rng = np.random.default_rng(seed)
    if dtype == "uint8":
        frames = rng.integers(0, 256, size=(b, f, d), dtype=np.uint8)
    else:
        frames = rng.normal(size=(b, f, d)).astype(np.float32)
    query = rng.normal(0, 0.1, size=(d, h)).astype(np.float32)
    return frames, query


def _port(frames, num_frames, query):
    """The bf16 route (the JAX kernel's and reference's default dtype):
    the query in bf16, as the model's serving constant."""
    return tap.attention_pool(torch.from_numpy(frames),
                              torch.from_numpy(num_frames),
                              torch.from_numpy(query).to(torch.bfloat16)
                              ).numpy()


def _rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)), np.max(np.abs(want))


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_attention_pool_plain_matches_jax(dtype):
    frames, query = _inputs(1, dtype)
    got = _port(frames, NUM_FRAMES, query)
    assert got.shape == (B, H, D) and got.dtype == np.float32
    args = (jnp.asarray(frames), jnp.asarray(NUM_FRAMES), jnp.asarray(query))
    err, scale = _rel_err(got, attention_pool_reference(*args))
    assert err <= 1e-3 * scale + 1e-5, err
    err, scale = _rel_err(got, jax_pool(*args, interpret=True))
    assert err <= 2e-2 * scale, err


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_attention_pool_empty_video_is_the_reference_mean(dtype):
    """num_frames = 0: every score -1e9, a uniform softmax over the F
    rows, as the reference computes; the JAX kernel's padded rows move
    its mean elsewhere (a JAX-side difference, not the port's)."""
    frames, query = _inputs(2, dtype)
    nf = np.array([0, 5, 0, 13], np.int32)
    got = _port(frames, nf, query)
    args = (jnp.asarray(frames), jnp.asarray(nf), jnp.asarray(query))
    want = np.asarray(attention_pool_reference(*args))
    err, scale = _rel_err(got, want)
    assert err <= 1e-3 * scale + 1e-5, err
    x = torch.from_numpy(frames).to(torch.float32)
    if dtype == "uint8":
        x = x * (4.0 / 255.0) + (4.0 / 512.0 - 2.0)
    xb = x.to(torch.bfloat16).to(torch.float32)
    mean = (xb[0] * torch.tensor(1.0 / F).to(torch.bfloat16).float()).sum(0)
    np.testing.assert_allclose(got[0], np.broadcast_to(mean.numpy(), (H, D)),
                               rtol=0, atol=1e-5)
    kernel = np.asarray(jax_pool(*args, interpret=True))
    if dtype == "uint8":  # F=13 pads to 16 rows of dequantized zeros
        assert np.max(np.abs(kernel[0] - want[0])) > 0.1
    np.testing.assert_allclose(kernel[1], want[1], rtol=0,
                               atol=2e-2 * np.abs(want[1]).max())


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_attention_pool_ignores_frames_past_num_frames(dtype):
    frames, query = _inputs(3, dtype)
    clean, loud = frames.copy(), frames.copy()
    for i, n in enumerate(NUM_FRAMES):
        clean[i, n:] = 0
        loud[i, n:] = 255 if dtype == "uint8" else 1e4
    np.testing.assert_array_equal(_port(clean, NUM_FRAMES, query),
                                  _port(loud, NUM_FRAMES, query))


def _boundary_case():
    """One video of two f32 frames whose first attention weight lies on
    the bf16 rounding boundary between 0.75 and 0.75 + 2^-8: its score,
    a sum of three exact bf16 products, hits logit(0.75 + 2^-9) to f32
    precision; the second frame is orthogonal to the query (score 0), so
    its weight is 1 - that, 0.248046875, a bf16 value far from any
    boundary. (frames, num_frames, query, the kernel's weights with the
    first weight rounded to the other side.)"""
    target = float(np.log((0.75 + 2.0 ** -9) / (0.25 - 2.0 ** -9)))
    parts, rest = [], target
    for scale in (1.0, 2.0 ** -8, 2.0 ** -16):
        v = torch.tensor(rest / scale).to(torch.bfloat16).item()
        parts.append(v)
        rest -= v * scale
    frames = torch.tensor([[[*parts, 0.0], [0.0, 0.0, 0.0, 1.0]]])
    query = torch.tensor([[1.0], [2.0 ** -8], [2.0 ** -16], [0.0]])
    nf = torch.tensor([2], dtype=torch.int32)
    attn = torch.softmax(frames @ query, dim=1)  # [1, 2, 1], exact operands
    plain = attn.to(torch.bfloat16).to(torch.float32)
    assert abs(attn[0, 0, 0].item() - (0.75 + 2.0 ** -9)) < 2.0 ** -20
    kernel = plain.clone()
    up = plain[0, 0, 0].item() > 0.75
    kernel[0, 0, 0] = 0.75 if up else 0.75 + 2.0 ** -8
    return frames, nf, query, kernel


def test_rounding_limit_covers_a_weight_one_step_over_a_boundary():
    """The card's attention limit (rounding_limit) on a hand-built draw: a
    kernel whose weight at a rounding boundary landed one bf16 step from
    the plain version's. The fixed 1e-3 * max|ref| + 1e-5 refuses it
    (2^-8 * 1.109 against ~8.4e-4); the derived limit covers it, and
    reads one flip, at the boundary."""
    frames, nf, query, kernel = _boundary_case()
    want = tap.attention_pool_plain(frames, nf, query.to(torch.bfloat16))
    got = torch.matmul(kernel.transpose(1, 2), frames)
    err = (got - want).abs()
    assert err.max().item() > 1e-3 * want.abs().max().item() + 1e-5
    r = tap.rounding_limit(frames, nf, query, got, want)
    assert r.explained and r.explain_err == 0.0
    assert (r.flips, r.away, r.unresolved) == (1, 0, 0)
    assert (r.near, r.weights) == (1, 2)
    assert r.worst < 2.0 ** -14
    assert torch.all(err <= r.limit)


def test_rounding_limit_refuses_a_weight_off_away_from_a_boundary():
    """The second weight (a bf16 value, far from any rounding boundary)
    one bf16 step off: rounding explains no such move; the limit reads it
    as a weight that differs away from a boundary, and does not cover
    it."""
    frames, nf, query, _ = _boundary_case()
    want = tap.attention_pool_plain(frames, nf, query.to(torch.bfloat16))
    kernel = torch.softmax(frames @ query, dim=1).to(torch.bfloat16)
    kernel[0, 1, 0] = torch.tensor(0.248046875 + 2.0 ** -10,
                                   dtype=torch.bfloat16)
    got = torch.matmul(kernel.to(torch.float32).transpose(1, 2), frames)
    r = tap.rounding_limit(frames, nf, query, got, want)
    assert r.explained and (r.flips, r.away) == (1, 1)
    assert not torch.all((got - want).abs() <= r.limit)


def test_attention_pool_wrapper_checks_shapes():
    frames, query = _inputs(4, "float32")
    with pytest.raises(ValueError):
        tap.attention_pool(torch.from_numpy(frames),
                           torch.from_numpy(NUM_FRAMES),
                           torch.from_numpy(query[:-1]))
    assert tap._heads_padded(1) == 8 and tap._heads_padded(5) == 8
    assert tap._heads_padded(9) == 16 and tap._heads_padded(16) == 16


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

CFG = dict(attention_heads=H, attention_hidden_size=24)
MODELS = ("AttentionPoolingModel", "MultiHeadAttentionModel")


def _jax_variables(jmodel, batch):
    variables, _ = train_tests._jax_state(jmodel, batch)
    rng = np.random.default_rng(7)

    def perturb(path, a):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim == 1:
            return (a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_attention_models_forward_match_jax(name, dtype, train):
    batch = train_tests._batches(3, 1)[0]
    batch["num_frames"][1] = 0  # an empty video
    jmodel = jax_get_model(name, train_tests._hparams(JaxHParams, CFG, dtype))
    variables = _jax_variables(jmodel, batch)
    args = (jnp.asarray(batch["features"]), jnp.asarray(batch["num_frames"]))
    if train:
        want, _ = jmodel.apply(variables, *args, train=True,
                               mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, *args, train=False)
    model = get_model(name, train_tests._hparams(ModelHParams, CFG, dtype))
    model.load_state_dict(state_dict_from_jax(variables))
    model.train(train)
    with torch.set_grad_enabled(train):
        got = model(torch.from_numpy(batch["features"]),
                    torch.from_numpy(batch["num_frames"]))
    tol = 1e-5 if dtype == "float32" else 3e-3
    np.testing.assert_allclose(got["predictions"].detach().numpy(),
                               np.asarray(want["predictions"]), rtol=0,
                               atol=tol)
    if train:
        np.testing.assert_allclose(
            got["regularization_loss"].item(),
            float(want["regularization_loss"]), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_attention_models_sgd_step_matches_jax(name, dtype, monkeypatch):
    jmodel = jax_get_model(name, train_tests._hparams(JaxHParams, CFG, dtype))
    start = train_tests._flat_params(train_tests._jax_state(
        jmodel, train_tests._batches(0, 1)[0])[0]["params"])
    record = []
    jloss, ploss, jstate, state, _, _, _ = train_tests._run_both(
        name, CFG, dtype, monkeypatch, steps=1, optimizer="SgdOptimizer",
        record=record)
    got, want = record[0]
    assert set(got) == set(want) == set(start)
    if dtype == "float32":
        np.testing.assert_allclose(ploss, jloss, rtol=1e-5)
        train_tests._compare_variables(state, jstate, 1e-5, {})
        return
    np.testing.assert_allclose(ploss, jloss, rtol=3e-3)
    for key in want:
        moved = want[key].astype(np.float64) - start[key]
        err = np.max(np.abs(got[key] - want[key]))
        assert err <= 2e-2 * np.max(np.abs(moved)), (key, err)
