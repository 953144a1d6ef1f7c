"""The port's training slice (yt8m_tpu_torch/train, the models' training
forwards) against the JAX package's train/ and models/.

Same inputs, weights and batches, made with numpy from a seed, go to both
sides. Tolerances:
  * losses, the learning-rate schedule, the per-variable clip, Adam and
    training-mode BatchNorm: 1e-6 * max(1, max|ref|) (float32
    elementwise arithmetic in another order).
  * 5-step float32 trajectories (DbofModel fed the same frame uniforms,
    the flagship at small widths), under SGD: the loss of every step
    within 1e-5 relative, parameters and BatchNorm statistics after 5
    steps within 1e-5 * max(1, max|ref|) of each variable.
  * the same under Adam (the reference's optimizer): the loss within
    1e-3 relative, and parameters within 1e-3 * max(1, max|ref|) (a
    tenth of one lr step) except where the gradient is float32 noise.
    Some gradients are 0 in exact arithmetic: a shift that a
    batch-moment BatchNorm downstream removes (DBoF's input_bn_bias,
    read 1e-8 here against 1e-1 for the other variables), or a cluster
    whose ReLU passes nothing on to the pooled max. Adam's update
    m / (sqrt(v) + eps) is close to lr * sign(g) in the first steps, so
    such an element moves lr a step in the direction of its noise, each
    side its own: up to 2 * lr * steps = 0.1 apart. Those elements
    (|g| < 1e-6 at some step on the port's side) get that bound. Where
    such a bias moves a ReLU's cut, the loss feels it (2.5e-4 relative
    by step 5, read here) and so does every gradient; Adam divides each
    element's update by its own gradient scale, so an element whose
    gradient is a near-cancelling sum moves by more than that fraction
    of lr (4e-4 read on DBoF's cluster_kernel).
  * EMA of the parameters (ema_decay 0.9, 2 SGD steps): 1e-5.
  * two bf16 SGD steps of the flagship, one- and bidirectional, JAX's
    LSTM through its trainable Pallas kernel in interpret mode
    (YT8M_PALLAS_INTERPRET=1) and the port's through the plain version
    of its trainable recurrence: both steps' losses and step 2's
    predictions within 3e-3 (docs/KERNELS.md, "bf16 divergence vs XLA":
    a last-bit difference before a bf16 rounding moves an operand one
    bf16 step); each variable's first move (lr times its clipped
    gradient), the LSTM kernel's input and recurrent rows each on their
    own, within 2e-2 of its largest move (the LSTM bound: the recurrence
    and the backward carry such one-step differences through every step;
    1.2e-2 read, on the VLAD assignment BN's bias, a sum over frames of
    softmax gradients that nearly cancel). After step 2 the moves differ
    more: step 1's last-bit differences in the f32 weights flip some of
    their bf16 roundings, one bf16 step each, so only the loss is held
    there.
  * LstmModel and BiLstmModel forward: 1e-5 at float32, 3e-3 at bf16.
"""

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import yt8m_tpu.models.frame as jax_frame
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.models.frame import _inline_bn as jax_inline_bn
from yt8m_tpu.models.norm import batch_norm as jax_batch_norm
from yt8m_tpu.train import losses as jax_losses
from yt8m_tpu.train.state import TrainState as JaxTrainState
from yt8m_tpu.train.state import make_lr_schedule as jax_schedule
from yt8m_tpu.train.state import make_optimizer as jax_make_optimizer
from yt8m_tpu.train.step import make_train_step as jax_make_train_step
from yt8m_tpu_torch.convert import state_dict_from_jax, variables_from_model
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.models.norm import BatchNorm, inline_bn
from yt8m_tpu_torch.train import losses as tlosses
from yt8m_tpu_torch.train.state import (
    TrainState,
    clip_gradient_norms,
    make_lr_schedule,
)
from yt8m_tpu_torch.train.step import make_train_step

C = 20


def _rel_close(got, want, rel, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want)) if got.size else 0.0
    assert err <= rel * max(1.0, np.max(np.abs(want))), (name, err)


# ---------------------------------------------------------------------------
# losses, schedule, clip, Adam, BatchNorm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["CrossEntropyLoss", "HingeLoss",
                                  "SoftmaxLoss",
                                  "MixedCrossEntropyDistillLoss"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    p = rng.uniform(0, 1, size=(6, C)).astype(np.float32)
    p[0, :3] = [0.0, 1.0, 1e-9]  # the clip points
    y = (rng.uniform(size=(6, C)) < 0.2).astype(np.float32)
    y[1] = 0.0  # an example with no label (SoftmaxLoss's floored row sum)
    teacher = rng.uniform(0, 1, size=(6, C)).astype(np.float32)
    for kw in ({}, {"teacher": teacher}):
        want = jax_losses.get_loss(name).calculate_loss(
            jnp.asarray(p), jnp.asarray(y),
            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tlosses.get_loss(name).calculate_loss(
            torch.from_numpy(p), torch.from_numpy(y),
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        _rel_close(got.numpy(), np.asarray(want), 1e-6, name)


def test_schedule_matches_optax_staircase():
    want = jax_schedule(0.01, 0.95, 1000, 64)
    got = make_lr_schedule(0.01, 0.95, 1000, 64)
    for step in (0, 1, 14, 15, 16, 31, 32, 200):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)


def _grads(seed, shapes, steps):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * rng.choice([1e-3, 1.0, 30.0])).astype(
        np.float32) for s in shapes] for _ in range(steps)]


def test_clip_adam_and_schedule_match_optax_on_the_same_gradients():
    """Per-variable clip (each gradient by its own norm: one small, one
    large), then Adam with eps 1e-8 under the staircase decay."""
    shapes = [(7, 5), (5,), (3, 4)]
    rng = np.random.default_rng(1)
    init = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = _grads(2, shapes, 5)
    tx = jax_make_optimizer(base_learning_rate=0.01, learning_rate_decay=0.9,
                            learning_rate_decay_examples=16,
                            global_batch_size=8, clip_gradient_norm=1.0)
    params = [jnp.asarray(p) for p in init]
    opt_state = tx.init(params)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g],
                                       opt_state, params)
        params = optax.apply_updates(params, updates)

    module = torch.nn.Module()
    for i, p in enumerate(init):
        module.register_parameter(f"p{i}", torch.nn.Parameter(
            torch.from_numpy(p.copy())))
    module.invalidate_serving = lambda: None
    state = TrainState(module, base_learning_rate=0.01,
                       learning_rate_decay=0.9,
                       learning_rate_decay_examples=16, global_batch_size=8,
                       clip_gradient_norm=1.0)
    for g in grads:
        for p, x in zip(module.parameters(), g):
            p.grad = torch.from_numpy(x.copy())
        state.apply_gradients()
    assert state.step == 5
    for got, want in zip(module.parameters(), params):
        _rel_close(got.detach().numpy(), np.asarray(want), 1e-6, "adam")


def test_clip_is_per_variable():
    a = torch.nn.Parameter(torch.zeros(4))
    b = torch.nn.Parameter(torch.zeros(2))
    a.grad = torch.tensor([3.0, 4.0, 0.0, 0.0])  # norm 5 -> 1
    b.grad = torch.tensor([0.3, 0.4])  # norm 0.5, unchanged
    clip_gradient_norms([a, b], 1.0)
    np.testing.assert_allclose(a.grad.numpy(), [0.6, 0.8, 0.0, 0.0], 1e-6)
    np.testing.assert_allclose(b.grad.numpy(), [0.3, 0.4], 1e-6)


def test_training_batchnorm_matches_flax_and_the_inline_bn():
    rng = np.random.default_rng(3)
    x = (3.0 + rng.normal(size=(9, 6)) * 2.0).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    ra_mean = rng.normal(size=6).astype(np.float32)
    ra_var = rng.uniform(0.5, 1.5, 6).astype(np.float32)

    class _Bn(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jax_batch_norm(True, "bn")(x)

    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": ra_mean, "var": ra_var}}}
    want, new = _Bn().apply(variables, jnp.asarray(x),
                            mutable=["batch_stats"])
    bn = BatchNorm(6).train()
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in (
        ("scale", scale), ("bias", bias), ("mean", ra_mean),
        ("var", ra_var))})
    got = bn(torch.from_numpy(x))
    _rel_close(got.detach().numpy(), np.asarray(want), 1e-6, "flax bn")
    _rel_close(bn.mean.numpy(), np.asarray(new["batch_stats"]["bn"]["mean"]),
               1e-6, "mean")
    _rel_close(bn.var.numpy(), np.asarray(new["batch_stats"]["bn"]["var"]),
               1e-6, "var")

    class _Var:
        def __init__(self, v):
            self.value = jnp.asarray(v)

    jm, jv = _Var(ra_mean), _Var(ra_var)
    want = jax_inline_bn(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), jm, jv, True)
    tm, tv = torch.from_numpy(ra_mean.copy()), torch.from_numpy(ra_var.copy())
    got = inline_bn(torch.from_numpy(x), torch.from_numpy(scale),
                    torch.from_numpy(bias), tm, tv, True)
    _rel_close(got.numpy(), np.asarray(want), 1e-6, "inline bn")
    _rel_close(tm.numpy(), np.asarray(jm.value), 1e-6, "inline mean")
    _rel_close(tv.numpy(), np.asarray(jv.value), 1e-6, "inline var")


# ---------------------------------------------------------------------------
# trajectories
# ---------------------------------------------------------------------------

B, F, D, STEPS = 6, 12, 32, 5
DBOF = dict(dbof_cluster_size=16, dbof_hidden_size=8, iterations=5,
            sample_random_frames=True)
FLAGSHIP = dict(netvlad_cluster_size=8, netvlad_hidden_size=16,
                lstm_cells=16, lstm_layers=2)
OPT = dict(base_learning_rate=0.01, learning_rate_decay=0.95,
           learning_rate_decay_examples=2 * B, global_batch_size=B,
           clip_gradient_norm=1.0)


def _hparams(cls, cfg, dtype):
    return cls(vocab_size=C, feature_dim=D, max_frames=F,
               compute_dtype=dtype, **cfg)


def _batches(seed, steps):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        nf = rng.integers(1, F + 1, size=B).astype(np.int32)
        nf[0] = F
        mask = np.ones(B, np.float32)
        mask[-1] = 0.0  # a padded example
        out.append({
            "features": rng.integers(0, 256, size=(B, F, D), dtype=np.uint8),
            "labels": (rng.uniform(size=(B, C)) < 0.2).astype(np.float32),
            "num_frames": nf,
            "batch_mask": mask,
            "example_weights": rng.uniform(0.5, 1.5, B).astype(np.float32),
        })
    return out


def _jax_state(model, batch, optimizer="AdamOptimizer"):
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(batch["features"]), jnp.asarray(batch["num_frames"]),
        train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    state = JaxTrainState.create(
        apply_fn=model.apply, params=variables["params"],
        batch_stats=variables.get("batch_stats", flax.core.FrozenDict()),
        tx=jax_make_optimizer(optimizer=optimizer, **OPT))
    return variables, state


def _port_state(name, cfg, dtype, variables, optimizer="AdamOptimizer"):
    model = get_model(name, _hparams(ModelHParams, cfg, dtype))
    model.load_state_dict(state_dict_from_jax(variables))
    return TrainState(model, optimizer=optimizer, **OPT)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _fixed_sampler(u):
    """The JAX sampler with the uniforms `u` in place of its draw (the
    index rule of yt8m_tpu/models/frame_utils.py)."""
    def sample(rng, model_input, num_frames, num_samples):
        nf = jnp.maximum(num_frames, 1).astype(jnp.float32)
        idx = jnp.floor(jnp.asarray(u) * nf[:, None]).astype(jnp.int32)
        return jnp.take_along_axis(model_input, idx[:, :, None], axis=1)
    return sample


def _run_both(name, cfg, dtype, monkeypatch, steps=STEPS, seed=0,
              optimizer="AdamOptimizer", record=None):
    """Train both sides `steps` steps on the same batches; the losses, the
    final states and metrics, and for each port variable the elements
    whose gradient was below 1e-6 at some step. A list `record` gets
    both sides' flat params after each step."""
    batches = _batches(seed, steps)
    jmodel = jax_get_model(name, _hparams(JaxHParams, cfg, dtype))
    variables, jstate = _jax_state(jmodel, batches[0], optimizer)
    state = _port_state(name, cfg, dtype, variables, optimizer)
    step = make_train_step(tlosses.get_loss("CrossEntropyLoss"))
    rng = np.random.default_rng(seed + 100)
    jloss, ploss = [], []
    noise = {n: np.zeros(p.shape, bool)
             for n, p in state.model.named_parameters()}
    for i, batch in enumerate(batches):
        u = None
        if name == "DbofModel":
            u = rng.uniform(size=(B, cfg["iterations"])).astype(np.float32)
            monkeypatch.setattr(jax_frame, "sample_random_frames",
                                _fixed_sampler(u))
        # a new jit each step: the patched sampler's uniforms are traced in
        jstep = jax_make_train_step(jmodel, jax_losses.get_loss(
            "CrossEntropyLoss"), donate=False)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                    batch.items()}, jax.random.PRNGKey(i))
        state, pm = step(state, _torch_batch(batch),
                         u=None if u is None else torch.from_numpy(u))
        jloss.append(float(jm["loss"]))
        ploss.append(float(pm["loss"]))
        assert np.isfinite(ploss[-1])
        for n, p in state.model.named_parameters():
            noise[n] |= p.grad.abs().numpy() < 1e-6
        if record is not None:
            record.append((_flat_params(variables_from_model(
                state.model)["params"]), _flat_params(jstate.params)))
    return jloss, ploss, jstate, state, jm, pm, noise


def _compare_variables(state, jstate, rel, noise):
    got = variables_from_model(state.model)
    flat_got = flax.traverse_util.flatten_dict(got["params"], sep=".")
    flat_got.update({"stats." + k: v for k, v in
                     flax.traverse_util.flatten_dict(
                         got["batch_stats"], sep=".").items()})
    host = lambda t: jax.tree_util.tree_map(np.asarray, dict(t))  # noqa: E731
    flat_want = flax.traverse_util.flatten_dict(host(jstate.params), sep=".")
    flat_want.update({"stats." + k: v for k, v in
                      flax.traverse_util.flatten_dict(
                          host(jstate.batch_stats), sep=".").items()})
    assert set(flat_got) == set(flat_want)
    for key, want in flat_want.items():
        err = np.abs(np.asarray(flat_got[key], np.float64) - want)
        bound = np.full(err.shape, rel * max(1.0, np.max(np.abs(want))))
        if key in noise:
            bound[noise[key]] = 2 * STEPS * OPT["base_learning_rate"]
        assert np.all(err <= bound), (key, float(np.max(err - bound)))


@pytest.mark.parametrize("name,cfg", [("DbofModel", DBOF),
                                      ("NetVladLstmModel", FLAGSHIP)])
@pytest.mark.parametrize("optimizer", ["SgdOptimizer", "AdamOptimizer"])
def test_float32_trajectory_matches_jax(name, cfg, optimizer, monkeypatch):
    jloss, ploss, jstate, state, _, _, noise = _run_both(
        name, cfg, "float32", monkeypatch, optimizer=optimizer)
    sgd = optimizer == "SgdOptimizer"
    np.testing.assert_allclose(ploss, jloss, rtol=1e-5 if sgd else 1e-3)
    assert state.step == int(jstate.step) == STEPS
    _compare_variables(state, jstate, 1e-5 if sgd else 1e-3,
                       {} if sgd else noise)


def _flat_params(tree):
    """Flat copies (the port's variables share the parameters' memory)."""
    return flax.traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.array, dict(tree)), sep=".")


def _bf16_sgd_steps_match_jax(name, monkeypatch):
    """Two bf16 SGD steps of `name` against JAX. Under SGD the first step
    moves each variable by lr times its clipped gradient, so those moves
    hold the backward against JAX: JAX's through its trainable Pallas
    kernel, the port's through its Function (dW_h into the LSTM kernel's
    recurrent rows kernel[D:], the bf16 projection's gradient into
    kernel[:D], the bias, the reversed direction). Step 2's loss reads
    the moved weights."""
    monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    jmodel = jax_get_model(name, _hparams(JaxHParams, FLAGSHIP, "bfloat16"))
    start = _flat_params(_jax_state(jmodel, _batches(0, 1)[0])[0]["params"])
    record = []
    jloss, ploss, _, _, jm, pm, _ = _run_both(
        name, FLAGSHIP, "bfloat16", monkeypatch, steps=2,
        optimizer="SgdOptimizer", record=record)
    np.testing.assert_allclose(ploss, jloss, rtol=3e-3)
    np.testing.assert_allclose(pm["predictions"].numpy(),
                               np.asarray(jm["predictions"]), atol=3e-3)
    got, want = record[0]
    assert set(got) == set(want) == set(start)
    h = FLAGSHIP["lstm_cells"]
    for key in want:
        parts = [slice(None)]
        if key.endswith("_layer0.kernel") or key.endswith("_layer1.kernel"):
            parts = [slice(None, -h), slice(-h, None)]  # input, recurrent
        for rows in parts:
            moved = want[key][rows].astype(np.float64) - start[key][rows]
            err = np.max(np.abs(got[key][rows] - want[key][rows]))
            assert err <= 2e-2 * np.max(np.abs(moved)), (key, rows, err)


def test_bf16_flagship_step_matches_jax_trainable_kernel(monkeypatch):
    _bf16_sgd_steps_match_jax("NetVladLstmModel", monkeypatch)


def test_bf16_bidirectional_flagship_steps_match_jax(monkeypatch):
    _bf16_sgd_steps_match_jax("NetVladBiLstmModel", monkeypatch)


def test_training_mode_drops_the_serving_constants():
    hp = _hparams(ModelHParams, FLAGSHIP, "float32")
    model = get_model("NetVladLstmModel", hp).eval()
    feats = torch.randint(0, 256, (3, F, D), dtype=torch.uint8)
    nf = torch.tensor([F, 4, 1], dtype=torch.int32)
    with torch.no_grad():
        before = model(feats, nf)["predictions"]
    assert model._serving is not None
    state = TrainState(model, **OPT)
    batch = {"features": feats, "num_frames": nf,
             "labels": torch.zeros(3, C), "batch_mask": torch.ones(3)}
    make_train_step(tlosses.get_loss("CrossEntropyLoss"))(state, batch)
    assert model._serving is None
    with torch.no_grad():
        after = model.eval()(feats, nf)["predictions"]
    assert not torch.equal(before, after)  # the new weights are served


# ---------------------------------------------------------------------------
# LstmModel, BiLstmModel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["LstmModel", "BiLstmModel"])
def test_lstm_models_forward_match_jax(name, dtype, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    cfg = dict(lstm_cells=16, lstm_layers=2)
    batch = _batches(5, 1)[0]
    jmodel = jax_get_model(name, _hparams(JaxHParams, cfg, dtype))
    variables, _ = _jax_state(jmodel, batch)
    want = jmodel.apply(variables, jnp.asarray(batch["features"]),
                        jnp.asarray(batch["num_frames"]), train=False)
    model = get_model(name, _hparams(ModelHParams, cfg, dtype))
    model.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(batch["features"]),
                           torch.from_numpy(batch["num_frames"]))
    np.testing.assert_allclose(got["predictions"].numpy(),
                               np.asarray(want["predictions"]),
                               atol=1e-5 if dtype == "float32" else 3e-3)


def test_ema_matches_jax():
    """--ema_decay: the Polyak average after each step, as the JAX step
    keeps it (ema = d * ema + (1 - d) * params)."""
    batches = _batches(7, 2)
    name, cfg = "NetVladLstmModel", FLAGSHIP
    jmodel = jax_get_model(name, _hparams(JaxHParams, cfg, "float32"))
    variables, jstate = _jax_state(jmodel, batches[0], "SgdOptimizer")
    jstate = jstate.replace(ema_params=jax.tree_util.tree_map(
        jnp.array, jstate.params))
    state = _port_state(name, cfg, "float32", variables, "SgdOptimizer")
    state.ema = {n: p.detach().clone()
                 for n, p in state.model.named_parameters()}
    jstep = jax_make_train_step(jmodel, jax_losses.get_loss(
        "CrossEntropyLoss"), donate=False, ema_decay=0.9)
    step = make_train_step(tlosses.get_loss("CrossEntropyLoss"),
                           ema_decay=0.9)
    for i, batch in enumerate(batches):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in
                                   batch.items()}, jax.random.PRNGKey(i))
        state, _ = step(state, _torch_batch(batch))
    want = flax.traverse_util.flatten_dict(
        jax.tree_util.tree_map(np.asarray, dict(jstate.ema_params)), sep=".")
    assert set(want) == set(state.ema)
    for n, w in want.items():
        _rel_close(state.ema[n].numpy(), w, 1e-5, n)
