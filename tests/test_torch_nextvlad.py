"""The port's NeXtVLAD aggregation (yt8m_tpu_torch/kernels/nextvlad.py) and
NeXtVladModel serving against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernel in interpret mode and its jnp oracle
(nextvlad_aggregate_reference). The same inputs, made with numpy from a
seed, go to both. Tolerance: max|diff| <= 3e-3 * max(1, max|ref|) on
every row, the bf16 level of the JAX package's own test, except rows
whose pre-norm magnitude (the oracle's, normalize=False) is below 0.05:
those fall back to that test's angular check (unit norm, cosine > 0.99),
since normalising a tiny row amplifies a last-bit difference of its
sums into a visible change of direction. No other row does. The oracle
and the port round at the same points and agree to ~1e-5; the interpret-
mode kernel contracts the uint8 dequantization into one fused
multiply-add, which moves a frame by one bf16 step now and then (up to
2e-2 on tiny rows at P=2, 1.7e-3 elsewhere, read here).
tests/test_torch_cuda.py holds the CUDA kernel against the plain version
on the card.

The model: NeXtVladModel at small widths with the JAX model's weights
(`state_dict_from_jax`) and non-trivial BatchNorm statistics, serving in
eval mode, JAX with YT8M_PALLAS_INTERPRET=1 so that it takes its kernel
path, probabilities within 3e-3; and the plain graphs
(--nextvlad_use_pallas=false on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.nextvlad import (
    nextvlad_aggregate as jax_nextvlad,
    nextvlad_aggregate_reference,
)
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.convert import state_dict_from_jax, variables_from_model
from yt8m_tpu_torch.kernels import nextvlad as tnv
from yt8m_tpu_torch.models import ModelHParams, get_model

BF16 = 3e-3
SHAPES = [
    (16, 2, 4, 12),   # P=8, K=12: heavy padding
    (64, 2, 1, 128),  # P=128, K=128, one group
    (32, 1, 16, 96),  # lambda=1, 16 groups, P=2
    (96, 3, 2, 130),  # P=144, K=130: misaligned, K past one tile
]
B, F = 4, 10
NUM_FRAMES = np.array([10, 4, 1, 0], np.int32)


def _weights(rng, d, lam, g, k):
    de = lam * d
    p = de // g
    return [rng.normal(0, 0.1, shape).astype(np.float32) for shape in
            ((d, de), (de, g), (g,), (de, g * k), (k, p))]


def _inputs(seed, x_dtype, d, lam, g, k):
    rng = np.random.default_rng(seed)
    if x_dtype == "uint8":
        x = rng.integers(0, 256, size=(B, F, d), dtype=np.uint8)
    else:
        x = rng.normal(size=(B, F, d)).astype(np.float32)
    w = _weights(rng, d, lam, g, k)
    w[2] = (0.5 * w[2]).astype(np.float32)
    return x, NUM_FRAMES, w


def _port(x, nf, w, g, dtype=torch.bfloat16):
    return tnv.nextvlad_aggregate(torch.from_numpy(x), torch.from_numpy(nf),
                                  *map(torch.from_numpy, w), g,
                                  dtype).numpy()


def _hold(got, want, prenorm):
    """The bf16 bound on every row but the tiny ones, which get the
    angular check."""
    scale = BF16 * max(1.0, np.max(np.abs(want)))
    rowbad = np.abs(got - want).max(axis=2) > scale
    tiny = prenorm < 0.05
    assert not (rowbad & ~tiny).any(), np.abs(got - want)[~tiny].max()
    if rowbad.any():
        np.testing.assert_allclose(
            np.linalg.norm(want[rowbad], axis=-1), 1.0, atol=1e-4)
        cos = np.sum(got[rowbad] * want[rowbad], axis=-1)
        assert np.all(cos > 0.99), cos.min()


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("d,lam,g,k", SHAPES)
def test_nextvlad_plain_matches_jax_kernel_and_oracle(x_dtype, d, lam, g, k):
    x, nf, w = _inputs(d + g + k, x_dtype, d, lam, g, k)
    jargs = [jnp.asarray(v) for v in (x, nf, *w)]
    kernel = np.asarray(jax_nextvlad(*jargs, groups=g, interpret=True))
    oracle = np.asarray(nextvlad_aggregate_reference(*jargs, groups=g))
    prenorm = np.linalg.norm(np.asarray(nextvlad_aggregate_reference(
        *jargs, groups=g, normalize=False)), axis=2)
    got = _port(x, nf, w, g)
    assert got.shape == (B, k, lam * d // g) and got.dtype == np.float32
    _hold(got, kernel, prenorm)
    _hold(got, oracle, prenorm)
    # num_frames = 0 gives exact zeros; the other rows are unit vectors
    # or exactly zero.
    assert np.all(got[3] == 0)
    norms = np.linalg.norm(got, axis=2)
    assert np.all((np.abs(norms - 1.0) < 1e-4) | (norms < 1e-3))


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_nextvlad_plain_float32_compute_matches_jax_kernel(x_dtype):
    d, lam, g, k = SHAPES[3]
    x, nf, w = _inputs(5, x_dtype, d, lam, g, k)
    jargs = [jnp.asarray(v) for v in (x, nf, *w)]
    want = np.asarray(jax_nextvlad(*jargs, groups=g, interpret=True,
                                   dtype=jnp.float32))
    got = _port(x, nf, w, g, torch.float32)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_nextvlad_frames_past_num_frames_do_not_leak(x_dtype):
    d, lam, g, k = SHAPES[0]
    x, nf, w = _inputs(6, x_dtype, d, lam, g, k)
    clean, loud = x.copy(), x.copy()
    for i, n in enumerate(nf):
        clean[i, n:] = 0
        loud[i, n:] = 255 if x_dtype == "uint8" else 1e4
    np.testing.assert_array_equal(_port(loud, nf, w, g),
                                  _port(clean, nf, w, g))


def test_nextvlad_wrapper_rejects_bad_shapes():
    d, lam, g, k = SHAPES[0]
    x, nf, w = _inputs(7, "float32", d, lam, g, k)
    t = [torch.from_numpy(v) for v in (x, nf, *w)]
    with pytest.raises(ValueError, match="divisible"):
        tnv.nextvlad_aggregate(*t, 3)
    with pytest.raises(ValueError, match="centers"):
        tnv.nextvlad_aggregate(*t[:6], t[6][:, :-1], g)


# ---------------------------------------------------------------------------
# NeXtVladModel serving
# ---------------------------------------------------------------------------

VOCAB, MD, MF = 20, 16, 10
WIDTHS = dict(nextvlad_groups=4, nextvlad_expansion=2,
              nextvlad_cluster_size=12, nextvlad_hidden_size=24,
              moe_num_mixtures=2)


def _hp(cls, **kw):
    return cls(vocab_size=VOCAB, feature_dim=MD, max_frames=MF,
               **{**WIDTHS, **kw})


def _jax_variables(seed):
    """JAX's init of a small NeXtVladModel, BatchNorm statistics and
    biases drawn so that every BN and bias does something."""
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(2, MF, MD), dtype=np.uint8)
    model = jax_get_model("NeXtVladModel", _hp(JaxHParams))
    variables = model.init(
        {"params": jax.random.PRNGKey(seed), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(feats), jnp.asarray([MF, 3]), train=False)
    variables = jax.tree_util.tree_map(np.array, variables)

    def perturb(tree, kind):
        for key, v in tree.items():
            if isinstance(v, dict):
                perturb(v, kind)
            elif kind == "stats":
                tree[key] = (rng.uniform(0.5, 1.5, v.shape) if key == "var"
                             else 0.3 * rng.normal(size=v.shape)
                             ).astype(np.float32)
            elif v.ndim == 1:
                tree[key] = (v + 0.1 * rng.normal(size=v.shape)
                             ).astype(np.float32)

    perturb(variables["batch_stats"], "stats")
    perturb(variables["params"], "params")
    return variables


def _batch(seed, b=5):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(b, MF, MD), dtype=np.uint8)
    nf = rng.integers(1, MF + 1, size=b).astype(np.int32)
    nf[:2] = [MF, 1]
    return feats, nf


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_nextvlad_model_serving_matches_jax(use_pallas, compute_dtype,
                                            monkeypatch):
    monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    variables = _jax_variables(1)
    feats, nf = _batch(2)
    kw = dict(compute_dtype=compute_dtype, nextvlad_use_pallas=use_pallas)
    jmodel = jax_get_model("NeXtVladModel", _hp(JaxHParams, **kw))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(feats),
                                   jnp.asarray(nf), train=False)["predictions"])
    model = get_model("NeXtVladModel", _hp(ModelHParams, **kw))
    model.load_state_dict(state_dict_from_jax(variables))
    calls = tnv.nextvlad_aggregate.launches
    with torch.inference_mode():
        got = model.eval()(torch.from_numpy(feats),
                           torch.from_numpy(nf))["predictions"].numpy()
    assert tnv.nextvlad_aggregate.launches == calls  # CPU: plain version
    assert got.shape == (5, VOCAB)
    np.testing.assert_allclose(got, want, atol=BF16)


def test_nextvlad_model_paths_agree_and_dispatch(monkeypatch):
    """The fused aggregation and the plain graph of the port agree at the
    bf16 level; --nextvlad_use_pallas selects the wrapper."""
    variables = _jax_variables(3)
    feats, nf = _batch(4)
    seen = []
    real = tnv.nextvlad_aggregate

    def counting(*a, **kw):
        seen.append(1)
        return real(*a, **kw)

    import yt8m_tpu_torch.models.nextvlad as mnv

    monkeypatch.setattr(mnv, "nextvlad_aggregate", counting)
    out = {}
    for use_pallas in (True, False):
        model = get_model("NeXtVladModel", _hp(
            ModelHParams, nextvlad_use_pallas=use_pallas))
        model.load_state_dict(state_dict_from_jax(variables))
        with torch.inference_mode():
            out[use_pallas] = model.eval()(
                torch.from_numpy(feats), torch.from_numpy(nf))["predictions"]
        assert len(seen) == 1  # the plain graph adds no call
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(),
                               atol=BF16)


def test_nextvlad_variables_round_trip():
    """JAX variables -> the port -> variables_from_model: the same tree,
    names, shapes and values."""
    variables = _jax_variables(5)
    model = get_model("NeXtVladModel", _hp(ModelHParams))
    model.load_state_dict(state_dict_from_jax(variables))
    back = variables_from_model(model)

    def flat(tree, prefix=""):
        out = {}
        for key, v in tree.items():
            name = f"{prefix}/{key}"
            out.update(flat(v, name) if isinstance(v, dict) else {name: v})
        return out

    for part in ("params", "batch_stats"):
        a, b = flat(variables[part]), flat(back[part])
        assert set(a) == set(b), part
        for name in a:
            np.testing.assert_array_equal(a[name], b[name])
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(v.size for v in flat(variables["params"]).values())
