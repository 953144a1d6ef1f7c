"""The port's DbofModel serving forward (yt8m_tpu_torch) against the JAX
package's DbofModel, with the weights carried over by convert.py.

The JAX model runs twice: with its Pallas kernels in interpret mode
(YT8M_PALLAS_INTERPRET=1) and with them off (the XLA graph, BatchNorm
unfolded). Tolerances on the probabilities (docs/KERNELS.md, "bf16
divergence vs XLA"):
  * compute_dtype float32: 1e-5 — only summation order and the BN fold
    differ;
  * compute_dtype bfloat16: 3e-3 — a last-bit difference before a bf16
    rounding moves that operand by one bf16 step.
Frame sampling: `sample_random_frames=False` with num_frames <= iterations
makes SampleRandomSequence start at frame 0 on both sides; the samplers
themselves are compared exactly, fed the JAX uniforms.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.models import frame_utils as jfu
from yt8m_tpu.train.step import make_topk_predict_step as jax_topk_step
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.infer.predict import make_topk_predict_step
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.models import frame_utils as tfu

B, F, D, K, H, C, S = 5, 12, 96, 64, 32, 40, 8
NUM_FRAMES = np.array([8, 3, 5, 1, 8], np.int32)

CONFIGS = {
    "f32": dict(compute_dtype="float32"),
    "bf16": dict(compute_dtype="bfloat16"),
    "f32_no_bn": dict(compute_dtype="float32", dbof_add_batch_norm=False),
    "f32_average": dict(compute_dtype="float32",
                        dbof_pooling_method="average"),
    "bf16_m4": dict(compute_dtype="bfloat16", moe_num_mixtures=4),
}
TOL = {"float32": 1e-5, "bfloat16": 3e-3}


def _hparams(cls, **kw):
    base = dict(vocab_size=C, feature_dim=D, max_frames=F,
                dbof_cluster_size=K, dbof_hidden_size=H, iterations=S,
                sample_random_frames=False)
    base.update(kw)
    return cls(**base)


def _features(x_dtype):
    rng = np.random.default_rng(0)
    if x_dtype == "uint8":
        return rng.integers(0, 256, size=(B, F, D), dtype=np.uint8)
    return rng.normal(size=(B, F, D)).astype(np.float32)


def _jax_variables(model, feats):
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(feats), jnp.asarray(NUM_FRAMES), train=False,
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(1)

    def perturb(tree, path=""):
        out = {}
        for key, val in tree.items():
            name = f"{path}/{key}"
            if isinstance(val, dict):
                out[key] = perturb(val, name)
            elif name.endswith(("var",)):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif name.endswith(("mean", "bias")):
                out[key] = (0.3 * rng.normal(size=val.shape)).astype(
                    np.float32)
            elif name.endswith("scale"):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            else:
                out[key] = val
        return out

    return {k: perturb(v) for k, v in variables.items()}


def _jax_predict(model, variables, feats, monkeypatch, interpret):
    if interpret:
        monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    out = model.apply(variables, jnp.asarray(feats), jnp.asarray(NUM_FRAMES),
                      train=False, rngs={"sample": jax.random.PRNGKey(3)})
    return np.asarray(out["predictions"])


def _port_model(cfg, variables):
    model = get_model("DbofModel", _hparams(ModelHParams, **cfg))
    model.load_state_dict(state_dict_from_jax(variables))
    return model.eval()


@pytest.mark.parametrize("interpret", [True, False],
                         ids=["pallas_interpret", "xla_graph"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_dbof_model_matches_jax(config, interpret, monkeypatch):
    cfg = CONFIGS[config]
    feats = _features("uint8")
    jmodel = jax_get_model("DbofModel", _hparams(JaxHParams, **cfg))
    variables = _jax_variables(jmodel, feats)
    want = _jax_predict(jmodel, variables, feats, monkeypatch, interpret)
    model = _port_model(cfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(feats),
                    torch.from_numpy(NUM_FRAMES))["predictions"].numpy()
    assert got.shape == (B, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[cfg["compute_dtype"]])


def test_dbof_model_float_features_match_jax(monkeypatch):
    cfg = CONFIGS["f32"]
    feats = _features("float32")
    jmodel = jax_get_model("DbofModel", _hparams(JaxHParams, **cfg))
    variables = _jax_variables(jmodel, feats)
    want = _jax_predict(jmodel, variables, feats, monkeypatch, True)
    with torch.no_grad():
        got = _port_model(cfg, variables)(
            torch.from_numpy(feats), torch.from_numpy(NUM_FRAMES))
    np.testing.assert_allclose(got["predictions"].numpy(), want, rtol=0,
                               atol=1e-5)


def test_topk_predict_step_matches_jax(monkeypatch):
    """The whole serving step: forward + exact top-k, f32 config."""
    cfg = CONFIGS["f32"]
    feats = _features("uint8")
    jmodel = jax_get_model("DbofModel", _hparams(JaxHParams, **cfg))
    variables = _jax_variables(jmodel, feats)
    monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    state = collections.namedtuple("State", "params batch_stats")(
        variables["params"], variables["batch_stats"])
    batch = {"features": jnp.asarray(feats),
             "num_frames": jnp.asarray(NUM_FRAMES)}
    want_v, want_i = jax_topk_step(jmodel, 20)(
        state, batch, jax.random.PRNGKey(3))
    step = make_topk_predict_step(_port_model(cfg, variables), 20)
    got_v, got_i = step(torch.from_numpy(feats),
                        torch.from_numpy(NUM_FRAMES))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=1e-5)


def test_converted_state_dict_keeps_names_and_layout():
    feats = _features("uint8")
    jmodel = jax_get_model("DbofModel", _hparams(JaxHParams))
    variables = _jax_variables(jmodel, feats)
    sd = state_dict_from_jax(variables)
    params = variables["params"]
    np.testing.assert_array_equal(sd["cluster_kernel"].numpy(),
                                  params["cluster_kernel"])
    assert tuple(sd["cluster_kernel"].shape) == (D, K)
    assert tuple(sd["hidden_kernel"].shape) == (K, H)
    gates = params["video_classifier"]["gates_kernel"]
    assert tuple(sd["video_classifier.gates_kernel"].shape) == (H, C * 3)
    np.testing.assert_array_equal(sd["video_classifier.gates_kernel"], gates)
    np.testing.assert_array_equal(
        sd["hidden_bn.mean"], variables["batch_stats"]["hidden_bn"]["mean"])
    model = get_model("DbofModel", _hparams(ModelHParams))
    assert set(sd) == set(model.state_dict())


def test_model_training_mode_raises():
    """Training mode no longer raises (the training slice ports it): the
    forward returns predictions and a regularization loss, the backward
    reaches every parameter and the BatchNorm statistics move.
    tests/test_torch_train.py holds it against the JAX model."""
    model = get_model("DbofModel", _hparams(ModelHParams))
    feats = torch.from_numpy(_features("uint8"))
    before = model.hidden_bn.mean.clone()
    out = model.train()(feats, torch.from_numpy(NUM_FRAMES))
    assert torch.isfinite(out["predictions"]).all()
    (out["predictions"].sum() + out["regularization_loss"]).backward()
    assert all(p.grad is not None for p in model.parameters())
    assert not torch.equal(model.hidden_bn.mean, before)


def test_serving_constants_follow_reloaded_weights():
    model = get_model("DbofModel", _hparams(ModelHParams)).eval()
    feats = torch.from_numpy(_features("uint8"))
    nf = torch.from_numpy(NUM_FRAMES)
    with torch.no_grad():
        before = model(feats, nf)["predictions"]
        other = get_model("DbofModel", _hparams(ModelHParams))
        other.reset_parameters(torch.Generator().manual_seed(9))
        model.load_state_dict(other.state_dict())
        after = model(feats, nf)["predictions"]
        want = other.eval()(feats, nf)["predictions"]
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


@pytest.mark.parametrize("num_samples", [1, 8, 30])
def test_sample_random_frames_matches_jax_given_its_uniforms(num_samples):
    feats = _features("uint8")
    nf = np.array([12, 1, 0, 7, 5], np.int32)
    rng = jax.random.PRNGKey(num_samples)
    want = jfu.sample_random_frames(rng, jnp.asarray(feats),
                                    jnp.asarray(nf), num_samples)
    u = np.array(jax.random.uniform(rng, (B, num_samples)))
    got = tfu.sample_random_frames(torch.from_numpy(feats),
                                   torch.from_numpy(nf), num_samples,
                                   u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_samples", [1, 4, 8])
def test_sample_random_sequence_matches_jax_given_its_uniforms(num_samples):
    feats = _features("uint8")
    nf = np.array([12, 1, 0, 7, 5], np.int32)
    rng = jax.random.PRNGKey(10 + num_samples)
    want = jfu.sample_random_sequence(rng, jnp.asarray(feats),
                                      jnp.asarray(nf), num_samples)
    u = np.array(jax.random.uniform(rng, (B, 1)))
    got = tfu.sample_random_sequence(torch.from_numpy(feats),
                                     torch.from_numpy(nf), num_samples,
                                     u=torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampling_from_generator_is_seeded():
    feats = torch.from_numpy(_features("uint8"))
    nf = torch.from_numpy(NUM_FRAMES)
    a = tfu.sample_random_frames(feats, nf, 8,
                                 generator=torch.Generator().manual_seed(5))
    b = tfu.sample_random_frames(feats, nf, 8,
                                 generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b)


def test_ensure_float_and_frame_mask_match_jax():
    feats = _features("uint8")[:, :3, :7]
    np.testing.assert_array_equal(
        tfu.ensure_float(torch.from_numpy(feats)).numpy(),
        np.asarray(jfu.ensure_float(jnp.asarray(feats))))
    np.testing.assert_array_equal(
        tfu.frame_mask(torch.from_numpy(NUM_FRAMES), F).numpy(),
        np.asarray(jfu.frame_mask(jnp.asarray(NUM_FRAMES), F)))


def test_hparams_field_names_and_defaults_match_jax():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(JaxHParams)}
    tf = {f.name: f.default for f in dataclasses.fields(ModelHParams)}
    assert jf == tf
    assert ModelHParams().dtype == torch.bfloat16
    assert ModelHParams(compute_dtype="float32").dtype == torch.float32
