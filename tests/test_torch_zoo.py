"""The whole model zoo: every model of the JAX package's registry against
the port's model of the same name, at small widths, with the JAX
variables carried across by `state_dict_from_jax`.

For each name and compute dtype: the serving `predictions` (JAX's Pallas
kernels in interpret mode at bf16, as tests/test_torch_model.py runs
them; its XLA graph at float32, where the port's CPU route computes the
same f32 function), the training forward's `predictions`,
`aux_predictions` and `regularization_loss` (BatchNorms on batch
moments), and the `frame_level` flag. Tolerances:
  * float32: <= 1e-5 * max|ref| (summation order, the BN folds);
  * bfloat16: 3e-3 (docs/KERNELS.md, "bf16 divergence vs XLA": a
    last-bit difference before a bf16 rounding moves an operand one bf16
    step);
  * regularization_loss: 1e-5 relative at either dtype (sums of squares
    of the same f32 weights).
Then direct cases for the layouts and the arithmetic the new models add:
the CNN's even kernel and its BatchNorm over [B*F], the LayerNorm LSTM's
parameters and masked steps, soft DBoF pooling on DbofModel, NetFV's
sigma floor, the logistic classifier head of the frame models, and a
variables round trip for each new model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.models import is_frame_level_model as jax_is_frame_level
from yt8m_tpu.models import list_models as jax_list_models
from yt8m_tpu_torch.convert import state_dict_from_jax, variables_from_model
from yt8m_tpu_torch.models import (
    ModelHParams,
    get_model,
    is_frame_level_model,
    list_models,
)
from yt8m_tpu_torch.models.netfv import SIGMA_FLOOR, netfv_sigma

B, F, D, C = 5, 10, 32, 20
NUM_FRAMES = np.array([10, 1, 7, 4, 10], np.int32)
WIDTHS = dict(
    vocab_size=C, feature_dim=D, max_frames=F,
    dbof_cluster_size=64, dbof_hidden_size=16, iterations=F,
    sample_random_frames=False,
    lstm_cells=16, lstm_layers=2, gru_cells=16, gru_layers=2,
    netvlad_cluster_size=8, netvlad_hidden_size=24,
    attention_heads=4, attention_hidden_size=24,
    nextvlad_groups=4, nextvlad_expansion=2, nextvlad_cluster_size=12,
    nextvlad_hidden_size=24,
    cnn_filters=16, cnn_layers=2, cnn_kernel=3,
    chain_stages=3, chain_hidden_size=16,
)
NEW_MODELS = ("LogisticModel", "MoeModel", "FrameLevelLogisticModel",
              "GatedDbofModel", "SoftDbofModel", "LayerNormLstmModel",
              "FrameCnnModel", "NetFVModel", "ChainMoeModel",
              "ChainFrameModel", "ChainNetVladModel", "DeepCombineChainModel")


def _hp(cls, dtype="float32", **kw):
    return cls(**{**WIDTHS, "compute_dtype": dtype, **kw})


def _inputs(name, seed=0):
    rng = np.random.default_rng(seed)
    if jax_is_frame_level(name):
        feats = rng.integers(0, 256, size=(B, F, D), dtype=np.uint8)
        return feats, NUM_FRAMES
    feats = rng.normal(size=(B, D)).astype(np.float32)
    return feats, np.ones(B, np.int32)


def _jax_variables(jmodel, feats, nf, seed=1):
    """JAX's init, with BatchNorm statistics, every 1-D parameter, the
    layer norms and NetFV's covariances drawn, so that each does
    something."""
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(feats), jnp.asarray(nf), train=False)
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if name.endswith("var"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if a.ndim == 1 or name.endswith(("ln_scale", "ln_bias",
                                         "covar_weights")):
            return (a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, variables)


def _jax_forward(jmodel, variables, feats, nf, train, monkeypatch, dtype):
    if dtype == "bfloat16":
        monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    args = (jnp.asarray(feats), jnp.asarray(nf))
    rngs = {"sample": jax.random.PRNGKey(3)}
    if train:
        out, _ = jmodel.apply(variables, *args, train=True, rngs=rngs,
                              mutable=["batch_stats"])
        return out
    return jmodel.apply(variables, *args, train=False, rngs=rngs)


def _port_forward(name, dtype, variables, feats, nf, train, **kw):
    model = get_model(name, _hp(ModelHParams, dtype, **kw))
    model.load_state_dict(state_dict_from_jax(variables))
    model.train(train)
    with torch.set_grad_enabled(train):
        return model(torch.from_numpy(feats), torch.from_numpy(nf))


def _close(got, want, dtype, what):
    got = np.asarray(got.detach().numpy() if torch.is_tensor(got) else got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = (1e-5 * np.max(np.abs(want)) if dtype == "float32" else 3e-3)
    err = np.max(np.abs(got.astype(np.float64) - want))
    assert err <= bound, (what, err, bound)


def _compare(name, dtype, monkeypatch, edit=None, **kw):
    """Serving and training forwards of `name` against JAX; `edit`
    changes the JAX variables (numpy leaves, in place) first."""
    feats, nf = _inputs(name)
    jmodel = jax_get_model(name, _hp(JaxHParams, dtype, **kw))
    variables = _jax_variables(jmodel, feats, nf)
    if edit is not None:
        edit(variables)
    for train in (False, True):
        want = _jax_forward(jmodel, variables, feats, nf, train, monkeypatch,
                            dtype)
        got = _port_forward(name, dtype, variables, feats, nf, train, **kw)
        tag = f"{name} {dtype} {'train' if train else 'serve'}"
        _close(got["predictions"], want["predictions"], dtype, tag)
        want_aux = want.get("aux_predictions", [])
        got_aux = got.get("aux_predictions", [])
        assert len(got_aux) == len(want_aux), tag
        for i, (g, w) in enumerate(zip(got_aux, want_aux)):
            _close(g, w, dtype, f"{tag} aux {i}")
        if train:
            w = float(want["regularization_loss"])
            g = float(got["regularization_loss"].detach())
            assert abs(g - w) <= 1e-5 * abs(w), (tag, g, w)


def test_the_port_registers_every_jax_model():
    assert list_models() == jax_list_models()
    assert len(list_models()) == 24


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", jax_list_models())
def test_every_model_matches_jax(name, dtype, monkeypatch):
    assert is_frame_level_model(name) == jax_is_frame_level(name)
    _compare(name, dtype, monkeypatch)


# ---------------------------------------------------------------------------
# direct cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cnn_same_padding_matches_jax(kernel, dtype, monkeypatch):
    """An even kernel pads (k-1)//2 frames below and k//2 above."""
    _compare("FrameCnnModel", dtype, monkeypatch, cnn_kernel=kernel)


def _flat(tree, prefix=""):
    out = {}
    for key, val in tree.items():
        name = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(_flat(val, name))
        else:
            out[name] = np.asarray(val)
    return out


@pytest.mark.parametrize("name", NEW_MODELS)
def test_training_forward_moves_batch_stats_as_jax(name, monkeypatch):
    """One float32 training forward: every running statistic the port
    moves equals JAX's (FrameCnnModel's conv{i}_bn and NetFV's cluster_bn
    over the [B*F] rows, padded frames included)."""
    monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    feats, nf = _inputs(name)
    jmodel = jax_get_model(name, _hp(JaxHParams))
    variables = _jax_variables(jmodel, feats, nf)
    _, moved = jmodel.apply(variables, jnp.asarray(feats), jnp.asarray(nf),
                            train=True, rngs={"sample": jax.random.PRNGKey(3)},
                            mutable=["batch_stats"])
    model = get_model(name, _hp(ModelHParams))
    model.load_state_dict(state_dict_from_jax(variables))
    model.train()(torch.from_numpy(feats), torch.from_numpy(nf))
    got = _flat(variables_from_model(model)["batch_stats"])
    want = _flat(jax.tree_util.tree_map(np.asarray,
                                        dict(moved.get("batch_stats", {}))))
    assert set(got) == set(want)
    before = _flat(jax.tree_util.tree_map(np.asarray,
                                          dict(variables.get("batch_stats",
                                                             {}))))
    for key, w in want.items():
        assert not np.array_equal(w, before[key]), key  # the stat moved
        err = np.max(np.abs(got[key].astype(np.float64) - w))
        assert err <= 1e-5 * max(1.0, np.max(np.abs(w))), (key, err)


def test_cnn_conv_layout_and_batchnorm_over_frames():
    """`conv{i}.kernel` keeps flax's [k, in, out]; the training BatchNorm
    averages the conv output over all B*F rows, padded frames included
    (not over B, and not over the live frames only)."""
    hp = _hp(ModelHParams, cnn_kernel=4)
    model = get_model("FrameCnnModel", hp)
    assert tuple(model.conv0.kernel.shape) == (4, D, hp.cnn_filters)
    assert tuple(model.conv1.kernel.shape) == (4, hp.cnn_filters,
                                               hp.cnn_filters)
    seen = []
    model.conv0.register_forward_hook(lambda m, i, o: seen.append(o))
    feats, nf = _inputs("FrameCnnModel")
    before = model.conv0_bn.mean.clone()
    model.train()(torch.from_numpy(feats), torch.from_numpy(nf))
    rows = seen[0].detach().reshape(B * F, -1)
    want = 0.99 * before + 0.01 * rows.mean(0)
    torch.testing.assert_close(model.conv0_bn.mean, want, rtol=0, atol=1e-6)
    live = rows[(np.arange(F)[None, :] < nf[:, None]).reshape(-1)]
    assert not torch.allclose(model.conv0_bn.mean,
                              0.99 * before + 0.01 * live.mean(0))


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_lstm_layer_matches_jax(reverse, dtype):
    """TF1's LayerNormBasicLSTMCell: `ln_scale`/`ln_bias` [5, H] and no
    `bias`, against the JAX layer; frames past num_frames are skipped
    (loud frames there give the same bits as zeros)."""
    from yt8m_tpu.models.rnn import _LstmLayer
    from yt8m_tpu_torch.models.rnn import LstmLayer

    h = 16
    rng = np.random.default_rng(4)
    xs = rng.normal(size=(F, B, D)).astype(np.float32)
    mask = (np.arange(F)[:, None] < NUM_FRAMES[None, :]).astype(np.float32)
    jl = _LstmLayer(hidden=h, dtype=jnp.dtype(dtype), reverse=reverse,
                    layer_norm=True)
    params = jl.init(jax.random.PRNGKey(5), jnp.asarray(xs),
                     jnp.asarray(mask[:, :, None]))
    params = jax.tree_util.tree_map(np.array, params)
    p = params["params"]
    assert set(p) == {"kernel", "ln_scale", "ln_bias"}
    p["ln_scale"] += 0.3 * rng.normal(size=(5, h)).astype(np.float32)
    p["ln_bias"] += 0.3 * rng.normal(size=(5, h)).astype(np.float32)
    want, (wc, wh) = jl.apply(params, jnp.asarray(xs),
                              jnp.asarray(mask[:, :, None]))
    port = LstmLayer(D, h, getattr(torch, dtype), reverse=reverse,
                     layer_norm=True)
    assert {n: tuple(t.shape) for n, t in port.state_dict().items()} == {
        "kernel": (D + h, 4 * h), "ln_scale": (5, h), "ln_bias": (5, h)}
    port.load_state_dict(state_dict_from_jax(params))
    nf = torch.from_numpy(NUM_FRAMES)
    with torch.no_grad():
        out, (c, hh) = port(torch.from_numpy(xs), nf)
        loud = torch.from_numpy(np.where(mask[:, :, None] > 0, xs, 1e3))
        out2, (c2, h2) = port(loud, nf)
    tol = 1e-5 if dtype == "float32" else 3e-3
    for got, ref in ((out, want), (c, wc), (hh, wh)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=tol)
    assert torch.equal(out, out2) and torch.equal(c, c2)
    assert torch.equal(hh, h2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["LstmModel", "NetVladBiLstmModel"])
def test_lstm_layer_norm_flag_matches_jax(name, dtype, monkeypatch):
    """--lstm_layer_norm on the LSTM models and the flagship family: the
    layer-norm cells on the scan graph, as in the JAX package."""
    _compare(name, dtype, monkeypatch, lstm_layer_norm=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dbof_soft_pooling_flag_matches_jax(dtype, monkeypatch):
    """--dbof_pooling_method=soft on DbofModel (the unfused graph)."""
    _compare("DbofModel", dtype, monkeypatch, dbof_pooling_method="soft")


def test_netfv_sigma_floor(monkeypatch):
    """sigma = max(softplus(covar_weights), 1e-3): below the floor the
    model divides by 1e-3, as the JAX model does."""
    import flax.linen as fnn

    w = np.array([-20.0, -7.5, -6.0, 0.0, 3.0], np.float32)
    want = np.asarray(jnp.maximum(fnn.softplus(jnp.asarray(w)), 1e-3))
    got = netfv_sigma(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == got[1] == np.float32(SIGMA_FLOOR) < got[2]

    def floor(variables):
        cov = variables["params"]["covar_weights"]
        cov[: cov.shape[0] // 2] = -20.0  # half the clusters at the floor

    _compare("NetFVModel", "float32", monkeypatch, edit=floor)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["DbofModel", "GatedNetVladModel"])
def test_logistic_classifier_head_matches_jax(name, dtype, monkeypatch):
    """--*_video_level_classifier_model=LogisticModel on frame models."""
    _compare(name, dtype, monkeypatch,
             video_level_classifier_model="LogisticModel")


@pytest.mark.parametrize("name", NEW_MODELS)
def test_variables_round_trip(name):
    """variables_from_model -> state_dict_from_jax gives back the same
    state_dict, in JAX's tree: the names and shapes of JAX's init."""
    model = get_model(name, _hp(ModelHParams))
    model.reset_parameters(torch.Generator().manual_seed(11))
    variables = variables_from_model(model)
    again = get_model(name, _hp(ModelHParams))
    again.load_state_dict(state_dict_from_jax(variables))
    for key, value in model.state_dict().items():
        assert torch.equal(again.state_dict()[key], value), key
    feats, nf = _inputs(name)
    jvars = jax_get_model(name, _hp(JaxHParams)).init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(feats), jnp.asarray(nf), train=False)
    for col in ("params", "batch_stats"):
        got = {k: v.shape for k, v in _flat(variables[col]).items()}
        want = {k: np.shape(v) for k, v in
                _flat(jax.tree_util.tree_map(np.asarray,
                                             dict(jvars.get(col, {})))).items()}
        assert got == want, col
