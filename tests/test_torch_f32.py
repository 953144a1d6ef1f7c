"""The port's --compute_dtype=float32 routes against the JAX package.

At float32 the four TPU kernels that take a `dtype` (DBoF v2, the MoE
head, NetVLAD, attention pooling) round nothing; the port's card routes
for an f32 weight are f32 kernels whose plain versions, which the CPU
runs, are these tests' subject. Each plain version is held against the
JAX kernel at dtype=float32 in interpret mode on the same inputs, made
with numpy from a seed: uint8 and f32 frames where the kernel takes
both, ragged num_frames with 0 and F, odd widths. Tolerance: max|diff|
<= 1e-5 * max|ref| + 1e-6 (only the order of the f32 sums differs, and
the interpret-mode kernels contract an affine into one FMA).

Then the models whose serving paths reach those kernels (DbofModel,
MoeModel, the flagship NetVladLstmModel, AttentionPoolingModel,
NeXtVladModel) at compute_dtype float32 against the JAX models run with
YT8M_PALLAS_INTERPRET=1, so that JAX takes its f32 kernels where it
takes any: 1e-5 on the probabilities, tests/test_torch_model.py's f32
bound. NeXtVladModel's JAX kernel runs in interpret mode at any dtype;
the port takes the JAX model's TPU route at float32, its plain graph.
JAX's LSTM recurrence kernel, forced into interpret mode, also runs at
any dtype and rounds to bf16 (yt8m_tpu/models/rnn.py: "interpret-mode
tests keep exercising the kernels at any dtype"); its TPU route at
float32 is the scan graph, which the flagship's JAX side is pinned to
with lstm_use_pallas=False (both sides read the same flags).

Last, the MoE head's bf16 card kernel at an H that is no multiple of its
64-deep stages: the padded operands it multiplies (zero columns of x and
zero rows of the weights, TMA's zero fill) against the JAX kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_zoo as zoo
from yt8m_tpu.kernels.attention_pool import attention_pool as jax_attention
from yt8m_tpu.kernels.dbof import dbof_cluster_maxpool_v2 as jax_dbof_v2
from yt8m_tpu.kernels.moe_head import moe_head_serving as jax_moe
from yt8m_tpu.kernels.netvlad import netvlad_aggregate as jax_netvlad
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.kernels import attention_pool as tap
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.kernels import moe_head as tmoe
from yt8m_tpu_torch.kernels import netvlad as tvlad
from yt8m_tpu_torch.models import ModelHParams

F32 = jnp.float32


def _close(got, want, rel=1e-5, abs_=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    bound = rel * np.max(np.abs(want)) + abs_
    assert err <= bound, (err, bound)


def _frames(rng, shape, x_dtype):
    if x_dtype == "uint8":
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.normal(size=shape).astype(np.float32)


def _num_frames(rng, b, f):
    """Ragged counts with F, 0 and 1 planted."""
    nf = rng.integers(1, f + 1, size=b).astype(np.int32)
    nf[: min(b, 3)] = np.array([f, 0, 1], np.int32)[: min(b, 3)]
    return nf


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the four kernels' f32 plain versions against the JAX kernels
# ---------------------------------------------------------------------------

# (B, S, D, K): odd S, D and K; S past one 32-frame launch of the card.
DBOF_SHAPES = [(3, 5, 32, 24), (4, 7, 37, 100), (2, 1, 64, 8),
               (5, 33, 33, 17)]


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,s,d,k", DBOF_SHAPES)
def test_dbof_v2_f32_plain_matches_jax(b, s, d, k, x_dtype):
    rng = np.random.default_rng(b + s + d + k)
    x = _frames(rng, (b, s, d), x_dtype)
    w = rng.normal(0, d ** -0.5, (d, k)).astype(np.float32)
    unit = 4.0 / 255.0 if x_dtype == "uint8" else 1.0
    in_scale = (unit * rng.uniform(0.5, 1.5, d)).astype(np.float32)
    in_bias = rng.normal(0, 0.3, d).astype(np.float32)
    act_scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    act_bias = rng.normal(0, 0.3, k).astype(np.float32)
    args = (x, w, in_scale, in_bias, act_scale, act_bias)
    got = tdbof.dbof_cluster_maxpool_v2(*_t(*args))
    want = jax_dbof_v2(*map(jnp.asarray, args), interpret=True, block_b=2,
                       dtype=F32)
    assert got.dtype == torch.float32
    assert tdbof.dbof_cluster_maxpool_v2.launches == 0  # the CPU: plain
    _close(got.numpy(), want)


# (B, H, C, M): odd H and C, M from 1 to 16.
MOE_SHAPES = [(5, 32, 7, 2), (3, 37, 11, 1), (4, 20, 9, 4), (2, 64, 5, 16),
              (6, 1000, 13, 2)]


def _moe_args(rng, b, h, c, m):
    x = rng.normal(size=(b, h)).astype(np.float32)
    gates = rng.normal(0, h ** -0.5, (h, c * (m + 1))).astype(np.float32)
    experts = rng.normal(0, h ** -0.5, (h, c * m)).astype(np.float32)
    bias = rng.normal(0, 0.3, c * m).astype(np.float32)
    return x, gates, experts, bias


@pytest.mark.parametrize("b,h,c,m", MOE_SHAPES)
def test_moe_head_f32_plain_matches_jax(b, h, c, m):
    rng = np.random.default_rng(b + h + c + m)
    x, gates, experts, bias = _moe_args(rng, b, h, c, m)
    got = tmoe.moe_head_serving(*_t(x, gates, experts, bias), m)
    want = jax_moe(*map(jnp.asarray, (x, gates, experts, bias)), m,
                   dtype=F32, interpret=True, block_b=4, block_c=4)
    _close(got.numpy(), want)


def _padded(x, gates, experts):
    """H padded to a multiple of the card kernel's 64-deep stages: zero
    columns of x, zero rows of the weights."""
    pad = -(-x.shape[1] // tmoe.DEPTH) * tmoe.DEPTH - x.shape[1]
    f = torch.nn.functional.pad
    return f(x, (0, pad)), f(gates, (0, 0, 0, pad)), f(experts, (0, 0, 0, pad))


@pytest.mark.parametrize("h", [1000, 37])
def test_moe_head_padding_to_the_card_depth_matches_jax(h):
    """The bf16 card kernel at an H no multiple of its 64-deep stages
    multiplies zero columns of x by zero rows of the weights past H (TMA's
    zero fill): `_padded` is that arithmetic. It meets the JAX
    kernel at bf16 within the MoE bound (1e-3 * max|ref| + 1e-6: the same
    bf16 operands, another summation order) and the unpadded plain
    version within the f32 sums' order."""
    b, c, m = 6, 13, 2
    rng = np.random.default_rng(h)
    x, gates, experts, bias = _moe_args(rng, b, h, c, m)
    tx, tg, te, tb = _t(x, gates, experts, bias)
    px, pg, pe = _padded(tx, tg.to(torch.bfloat16), te.to(torch.bfloat16))
    assert px.shape[1] % tmoe.DEPTH == 0 and px.shape[1] >= h
    assert torch.all(px[:, h:] == 0) and torch.all(pg[h:] == 0)
    got = tmoe.moe_head_plain(px, pg, pe, tb, m)
    want = jax_moe(*map(jnp.asarray, (x, gates, experts, bias)), m,
                   interpret=True, block_b=4, block_c=4)
    _close(got.numpy(), want, rel=1e-3)
    unpadded = tmoe.moe_head_plain(tx, tg.to(torch.bfloat16),
                                   te.to(torch.bfloat16), tb, m)
    _close(got.numpy(), unpadded.numpy())


# (B, F, D, K): ragged num_frames with 0 and F, odd D and K.
VLAD_SHAPES = [(4, 13, 24, 8), (3, 70, 37, 100), (4, 16, 64, 17),
               (5, 65, 33, 256)]


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,f,d,k", VLAD_SHAPES)
def test_netvlad_f32_plain_matches_jax(b, f, d, k, x_dtype):
    rng = np.random.default_rng(b + f + d + k)
    frames = _frames(rng, (b, f, d), x_dtype)
    nf = _num_frames(rng, b, f)
    wc = rng.normal(0, d ** -0.5, (d, k)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = rng.normal(0, 0.3, k).astype(np.float32)
    centers = rng.normal(0, 0.5, (k, d)).astype(np.float32)
    args = (frames, nf, wc, scale, bias, centers)
    got = tvlad.netvlad_aggregate(*_t(*args))
    want = jax_netvlad(*map(jnp.asarray, args), interpret=True, dtype=F32)
    _close(got.numpy(), want)
    assert np.all(got[1].numpy() == 0)  # num_frames = 0: a zero descriptor


# (B, F, D, H): F a multiple of 8 (the JAX kernel's padding then adds no
# row to the num_frames = 0 mean), odd D, up to 19 heads.
ATTN_SHAPES = [(4, 16, 32, 4), (3, 24, 37, 3), (4, 8, 64, 16),
               (3, 16, 8, 19), (4, 40, 1152, 8)]


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,f,d,h", ATTN_SHAPES)
def test_attention_pool_f32_plain_matches_jax(b, f, d, h, x_dtype):
    rng = np.random.default_rng(b + f + d + h)
    frames = _frames(rng, (b, f, d), x_dtype)
    nf = _num_frames(rng, b, f)
    query = rng.normal(0, d ** -0.5, (d, h)).astype(np.float32)
    got = tap.attention_pool(*_t(frames, nf, query))
    want = jax_attention(*map(jnp.asarray, (frames, nf, query)),
                         interpret=True, dtype=F32)
    _close(got.numpy(), want)


def test_attention_pool_compute_dtype_follows_the_query():
    """An f32 query computes in f32; a bf16 one rounds x, Q and the
    attention to bf16 (the bf16 route), as the JAX kernel at each
    dtype."""
    rng = np.random.default_rng(5)
    frames = _frames(rng, (3, 16, 40), "float32")
    nf = _num_frames(rng, 3, 16)
    query = rng.normal(0, 40 ** -0.5, (40, 4)).astype(np.float32)
    x, n, q = _t(frames, nf, query)
    assert tap.compute_dtype(q) == torch.float32
    assert tap.compute_dtype(q.to(torch.bfloat16)) == torch.bfloat16
    f32 = tap.attention_pool(x, n, q).numpy()
    bf16 = tap.attention_pool(x, n, q.to(torch.bfloat16)).numpy()
    args = tuple(map(jnp.asarray, (frames, nf, query)))
    _close(f32, jax_attention(*args, interpret=True, dtype=F32))
    _close(bf16, jax_attention(*args, interpret=True), rel=2e-2)
    assert np.max(np.abs(f32 - bf16)) > 1e-4  # the bf16 rounding shows


# ---------------------------------------------------------------------------
# the models at float32 against the JAX models with their f32 kernels
# ---------------------------------------------------------------------------

F32_MODELS = ("DbofModel", "MoeModel", "NetVladLstmModel",
              "AttentionPoolingModel", "NeXtVladModel")
# The JAX TPU route at float32 for the recurrence: its scan graph.
F32_FLAGS = {"NetVladLstmModel": dict(lstm_use_pallas=False)}


@pytest.mark.parametrize("name", F32_MODELS)
def test_f32_model_serving_matches_jax_kernels(name, monkeypatch):
    feats, nf = zoo._inputs(name)
    kw = F32_FLAGS.get(name, {})
    jmodel = jax_get_model(name, zoo._hp(JaxHParams, "float32", **kw))
    variables = zoo._jax_variables(jmodel, feats, nf)
    monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    want = np.asarray(jmodel.apply(
        variables, jnp.asarray(feats), jnp.asarray(nf), train=False,
        rngs={"sample": jax.random.PRNGKey(3)})["predictions"])
    got = zoo._port_forward(name, "float32", variables, feats, nf, False,
                            **kw)
    got = got["predictions"].detach().numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_nextvlad_f32_builds_no_kernel_layout():
    """At float32 NeXtVladModel takes the JAX model's plain graph: its
    serving constants hold no kernel layout, and the aggregation is the
    plain one in eval and in training."""
    model = zoo.get_model("NeXtVladModel", zoo._hp(ModelHParams, "float32"))
    assert not model.kernel_dtype()
    assert model.make_serving_constants()["layout"] is None
    bf16 = zoo.get_model("NeXtVladModel", zoo._hp(ModelHParams, "bfloat16"))
    assert bf16.kernel_dtype()
