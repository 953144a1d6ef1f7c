"""The port's NetVLAD family and the flagship NetVladLstmModel
(yt8m_tpu_torch) against the JAX package's models, with the weights
carried over by convert.py and non-trivial BatchNorm statistics.

Two configurations, as for DbofModel (tests/test_torch_model.py):
  * compute_dtype float32, JAX kernels off: JAX runs its LSTM scan graph
    and its jnp VLAD graph (BatchNorm unfolded), the port its float32
    scan and the plain VLAD (BatchNorm folded). Tolerance 1e-5 on the
    probabilities: only summation order and the BN fold differ.
  * compute_dtype bfloat16 with YT8M_PALLAS_INTERPRET=1: JAX's LSTM goes
    through its Pallas kernel in interpret mode, the port through the
    recurrence's plain version. Tolerance 3e-3: a last-bit difference
    before a bf16 rounding moves that operand by one bf16 step
    (docs/KERNELS.md, "bf16 divergence vs XLA").
An empty video (num_frames 0) under masked max pooling has -1e9
features, which saturate the MoE head. The port's head always has the
TPU kernel's numerics (gate logits clamped to +-80), as JAX's has when
its kernels run; JAX's XLA head (kernels off) takes an unclamped softmax
and breaks the resulting ties otherwise. So max pooling meets an empty
video only in the bfloat16 configuration, where JAX runs its head kernel.

The JAX VLAD kernel runs only on a TPU backend (the JAX package's
models/netvlad.py:112), so at the model level the port's VLAD is held
against the JAX jnp graph in both configurations;
tests/test_torch_netvlad.py holds it against the kernel itself.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yt8m_tpu.models.netvlad as jax_netvlad_models
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.infer.predict import make_topk_predict_step
from yt8m_tpu_torch.models import ModelHParams, get_model

B, F, D, K, HV, HL, C = 5, 16, 32, 8, 24, 16, 64
NUM_FRAMES = np.array([16, 1, 0, 9, 13], np.int32)
MODELS = ("NetVladLstmModel", "NetVladBiLstmModel", "NetVladModel",
          "GatedNetVladModel")
TOL = {"float32": 1e-5, "bfloat16": 3e-3}


def _hparams(cls, **kw):
    base = dict(vocab_size=C, feature_dim=D, max_frames=F,
                netvlad_cluster_size=K, netvlad_hidden_size=HV,
                lstm_cells=HL, lstm_layers=2)
    base.update(kw)
    return cls(**base)


def _features():
    rng = np.random.default_rng(0)
    return rng.integers(0, 256, size=(B, F, D), dtype=np.uint8)


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
            elif name.endswith("var"):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            elif name.endswith(("mean", "bias", "biases")):
                out[key] = (0.3 * rng.normal(size=val.shape)).astype(
                    np.float32)
            elif name.endswith("scale"):
                out[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
            else:
                out[key] = val
        return out

    return {k: perturb(v) for k, v in variables.items()}


def _jax_predict(model, variables, feats, monkeypatch, interpret,
                 num_frames=NUM_FRAMES):
    if interpret:
        monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    out = model.apply(variables, jnp.asarray(feats), jnp.asarray(num_frames),
                      train=False, rngs={"sample": jax.random.PRNGKey(3)})
    return np.asarray(out["predictions"])


def _port_model(name, cfg, variables):
    model = get_model(name, _hparams(ModelHParams, **cfg))
    model.load_state_dict(state_dict_from_jax(variables))
    return model.eval()


def _compare(name, cfg, monkeypatch, feats=None, num_frames=NUM_FRAMES):
    feats = _features() if feats is None else feats
    jmodel = jax_get_model(name, _hparams(JaxHParams, **cfg))
    variables = _jax_variables(jmodel, feats)
    interpret = cfg["compute_dtype"] == "bfloat16"
    want = _jax_predict(jmodel, variables, feats, monkeypatch, interpret,
                        num_frames)
    with torch.no_grad():
        got = _port_model(name, cfg, variables)(
            torch.from_numpy(feats), torch.from_numpy(num_frames))
    got = got["predictions"].numpy()
    assert got.shape == (B, C) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[cfg["compute_dtype"]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_model_matches_jax(name, dtype, monkeypatch):
    _compare(name, dict(compute_dtype=dtype), monkeypatch)


VARIANTS = {
    "no_bn": dict(netvlad_add_batch_norm=False),
    "no_gating": dict(netvlad_gating=False),
    "residual_max": dict(rnn_residual=True, lstm_pooling="max"),
    "mean_3_layers": dict(lstm_pooling="mean", lstm_layers=3),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flagship_variants_match_jax(variant, dtype, monkeypatch):
    cfg = dict(compute_dtype=dtype, **VARIANTS[variant])
    nf = NUM_FRAMES
    if cfg.get("lstm_pooling") == "max" and dtype == "float32":
        nf = np.maximum(nf, 3)  # no empty video: see the module docstring
    _compare("NetVladLstmModel", cfg, monkeypatch, num_frames=nf)


def test_gated_netvlad_no_bn_float_frames_match_jax(monkeypatch):
    feats = np.random.default_rng(2).normal(size=(B, F, D)).astype(
        np.float32)
    _compare("GatedNetVladModel",
             dict(compute_dtype="float32", netvlad_add_batch_norm=False),
             monkeypatch, feats)


@pytest.mark.parametrize("name", ["NetVladModel", "GatedNetVladModel"])
def test_netvlad_sampled_frames_match_jax(name, monkeypatch):
    """--netvlad_sample_frames: the port is fed the uniforms JAX drew."""
    s = 6
    cfg = dict(compute_dtype="float32", netvlad_sample_frames=s)
    feats = _features()
    jmodel = jax_get_model(name, _hparams(JaxHParams, **cfg))
    variables = _jax_variables(jmodel, feats)
    drawn = []
    sampler = jax_netvlad_models.sample_random_frames

    def spy(rng, x, nf, n):
        drawn.append(np.array(jax.random.uniform(rng, (x.shape[0], n))))
        return sampler(rng, x, nf, n)

    monkeypatch.setattr(jax_netvlad_models, "sample_random_frames", spy)
    want = _jax_predict(jmodel, variables, feats, monkeypatch, False)
    (u,) = drawn
    with torch.no_grad():
        got = _port_model(name, cfg, variables)(
            torch.from_numpy(feats), torch.from_numpy(NUM_FRAMES),
            u=torch.from_numpy(u))["predictions"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_flagship_state_dict_keeps_jax_names_and_shapes():
    feats = _features()
    for name, bn in (("NetVladBiLstmModel", True),
                     ("NetVladLstmModel", False)):
        hp = dict(netvlad_add_batch_norm=bn)
        variables = _jax_variables(
            jax_get_model(name, _hparams(JaxHParams, **hp)), feats)
        sd = state_dict_from_jax(variables)
        model = get_model(name, _hparams(ModelHParams, **hp))
        assert set(sd) == set(model.state_dict())
        for key, value in model.state_dict().items():
            assert tuple(sd[key].shape) == tuple(value.shape), key
    assert tuple(sd["vlad.cluster_weights2"].shape) == (1, D, K)
    assert tuple(sd["vlad_hidden_weights"].shape) == (K * D, HV)
    assert tuple(sd["fw_layer0.kernel"].shape) == (D + HL, 4 * HL)
    assert tuple(sd["fw_layer1.kernel"].shape) == (2 * HL, 4 * HL)
    assert "context_gate.gating_bias" in sd and "vlad.cluster_biases" in sd
    np.testing.assert_array_equal(
        sd["fw_layer1.bias"].numpy(), variables["params"]["fw_layer1"]["bias"])


def test_flagship_topk_step_matches_jax_order(monkeypatch):
    """The serving step (forward + exact top-k) on the f32 config."""
    cfg = dict(compute_dtype="float32")
    feats = _features()
    jmodel = jax_get_model("NetVladLstmModel", _hparams(JaxHParams, **cfg))
    variables = _jax_variables(jmodel, feats)
    want = _jax_predict(jmodel, variables, feats, monkeypatch, False)
    step = make_topk_predict_step(
        _port_model("NetVladLstmModel", cfg, variables), 10)
    values, indices = step(torch.from_numpy(feats),
                           torch.from_numpy(NUM_FRAMES))
    np.testing.assert_allclose(
        values.numpy(), np.take_along_axis(want, indices.numpy(), 1),
        rtol=0, atol=1e-5)
    np.testing.assert_allclose(values.numpy(), -np.sort(-want, 1)[:, :10],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_flagship_training_mode_and_layer_norm_raise(name):
    """Training mode is ported (tests/test_torch_train.py holds it against
    the JAX model): a finite forward with a regularization loss whose
    backward reaches every parameter. --lstm_layer_norm no longer raises:
    the LSTM branch gets the layer-norm cells (tests/test_torch_zoo.py
    holds them against JAX), with the same check."""
    variants = [{}]
    if "Lstm" in name:
        variants.append(dict(lstm_layer_norm=True))
    for kw in variants:
        model = get_model(name, _hparams(ModelHParams, **kw)).train()
        out = model(torch.from_numpy(_features()),
                    torch.from_numpy(NUM_FRAMES))
        assert torch.isfinite(out["predictions"]).all()
        (out["predictions"].sum() + out["regularization_loss"]).backward()
        assert all(p.grad is not None for p in model.parameters())
        if kw:
            assert "fw_layer0.ln_scale" in model.state_dict()
            assert "fw_layer0.bias" not in model.state_dict()


def test_cli_serves_a_jax_recorded_flagship_run(tmp_path, monkeypatch):
    """A run directory as the JAX trainer records it (its
    model_flags.json) with the converted weights: the port's inference
    CLI on the CPU writes the top-k of the JAX model's probabilities."""
    import dataclasses
    import json

    from yt8m_tpu_torch.cli import inference as cli
    from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
    from yt8m_tpu_torch.data.synthetic import write_dataset

    data = str(tmp_path / "data")
    write_dataset(data, "test", num_shards=2, videos_per_shard=4,
                  frame_level=True, num_classes=C, seed=2, rgb_dim=64,
                  audio_dim=32, max_frames=20)
    recorded = dict(frame_features=True, feature_names="rgb,audio",
                    feature_sizes="64,32", num_classes=C, max_frames=20)
    jhp = _hparams(JaxHParams, compute_dtype="float32", feature_dim=96,
                   max_frames=20)
    jmodel = jax_get_model("NetVladLstmModel", jhp)
    rc = ReaderConfig("rgb,audio", "64,32", frame_features=True,
                      num_classes=C, max_frames=20)
    (batch,) = list(BatchIterator(f"{data}/test-*.tfrecord", rc,
                                  batch_size=8))
    variables = _jax_variables(jmodel, batch["features"][:B])
    want = _jax_predict(jmodel, variables, batch["features"], monkeypatch,
                        False, batch["num_frames"])
    run = tmp_path / "run"
    run.mkdir()
    (run / "model_flags.json").write_text(json.dumps(
        {"model": "NetVladLstmModel", **recorded,
         "hparams": dataclasses.asdict(jhp)}))
    torch.save(state_dict_from_jax(variables), run / "model.pt")
    out = tmp_path / "out.csv"
    stats = cli.main([f"--input_data_pattern={data}/test-*.tfrecord",
                      f"--train_dir={run}", f"--output_file={out}",
                      "--batch_size=3", "--top_k=5", "--device=cpu",
                      "--compute_dtype=float32"])
    assert stats["num_videos"] == 8 and stats["nonfinite_predictions"] == 0
    rows = [line.split(",") for line in out.read_text().splitlines()[1:]]
    ids = [v.decode() for v in batch["id"]]
    for vid, pairs in rows:
        p = want[ids.index(vid)]
        toks = pairs.split()
        classes = [int(t) for t in toks[0::2]]
        values = np.array([float(t) for t in toks[1::2]])
        np.testing.assert_allclose(values, -np.sort(-p)[:5], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(p[classes], values, rtol=1e-5, atol=1e-6)
