"""The port's optimizer zoo (yt8m_tpu_torch/train/state.py ::
make_optimizer, train/optimizers.py) against the JAX package's
make_optimizer (optax) on the same parameters and gradients.

Parameters: a [200, 130] and a [128, 300] matrix (both dimensions reach
128, so Adafactor factors them, over either orientation), a 1-D vector
and a small [9, 5] matrix that it does not factor. Five steps under the
staircase decay with the per-variable clip; gradients of three scales
(1e-3, 1, 30: the clip acts on some). Tolerance: each parameter within
1e-6 * max|ref| of optax's after five steps (f32 elementwise arithmetic;
only the order of the mean and RMS sums and the last bit of pow and
rsqrt differ), with the clip and without it. The port's clip sums each
norm in float64 (train/state.py), JAX's in f32: the clipped gradients
differ in their last bit, and under --adam_mu_dtype=bfloat16 such a bit
can carry the f32 moment across a bf16 rounding boundary, one bf16 step
(2^-8) of an element's moment, which Adam's normalised update moves by
up to that share of lr. So that case is held to 1e-6 on optax's own
clipped gradients (the witness that the clip's rounding is the whole
difference), where its bf16 moment after five steps equals optax's bit
for bit. A state_dict saved after two steps and
loaded into a fresh optimizer continues to the same five-step result,
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yt8m_tpu.train.state import clip_gradient_norms as jax_clip
from yt8m_tpu.train.state import make_optimizer as jax_make_optimizer
from yt8m_tpu_torch.train.optimizers import factored_dims
from yt8m_tpu_torch.train.state import OPTIMIZERS, TrainState

SHAPES = [(200, 130), (128, 300), (7,), (9, 5)]
SCHEDULE = dict(base_learning_rate=0.01, learning_rate_decay=0.9,
                learning_rate_decay_examples=16, global_batch_size=8,
                clip_gradient_norm=1.0)
CASES = {
    "adafactor": dict(optimizer="AdafactorOptimizer"),
    "rmsprop": dict(optimizer="RMSPropOptimizer"),
    "adagrad": dict(optimizer="AdagradOptimizer"),
    "adam_bf16_mu": dict(optimizer="AdamOptimizer",
                         adam_mu_dtype="bfloat16"),
    "adam": dict(optimizer="AdamOptimizer"),
    "sgd": dict(optimizer="SgdOptimizer"),
}


def _init(seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in SHAPES]


def _grads(seed=2, steps=5):
    rng = np.random.default_rng(seed)
    return [[(rng.normal(size=s) * rng.choice([1e-3, 1.0, 30.0])).astype(
        np.float32) for s in SHAPES] for _ in range(steps)]


def _optax(case, init, grads, **kw):
    tx = jax_make_optimizer(**CASES[case], **{**SCHEDULE, **kw})
    params = [jnp.asarray(p) for p in init]
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state,
                                   params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(p) for p in params], state


def _module(init):
    module = torch.nn.Module()
    for i, p in enumerate(init):
        module.register_parameter(f"p{i}", torch.nn.Parameter(
            torch.from_numpy(p.copy())))
    module.invalidate_serving = lambda: None
    return module


def _port_state(case, module, **kw):
    return TrainState(module, **CASES[case], **{**SCHEDULE, **kw})


def _optax_clipped(grads):
    """The gradients after the JAX package's per-variable clip."""
    clip = jax_clip(SCHEDULE["clip_gradient_norm"])
    return [[np.asarray(x) for x in clip.update(
        [jnp.asarray(x) for x in g], clip.init(None))[0]] for g in grads]


def _steps(state, module, grads):
    for g in grads:
        for p, x in zip(module.parameters(), g):
            p.grad = torch.from_numpy(x.copy())
        state.apply_gradients()


@pytest.mark.parametrize("clip", [True, False], ids=["clip", "no_clip"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax_over_five_steps(case, clip):
    init, grads = _init(), _grads()
    want, _ = _optax(case, init, grads,
                     **({} if clip else dict(clip_gradient_norm=0.0)))
    module = _module(init)
    if clip and case == "adam_bf16_mu":  # optax's clipped gradients
        state = _port_state(case, module, clip_gradient_norm=0.0)
        _steps(state, module, _optax_clipped(grads))
    else:
        state = _port_state(case, module,
                            **({} if clip else dict(clip_gradient_norm=0.0)))
        _steps(state, module, grads)
    assert state.step == 5
    for i, (got, ref) in enumerate(zip(module.parameters(), want)):
        got = got.detach().numpy().astype(np.float64)
        err = np.max(np.abs(got - ref))
        assert err <= 1e-6 * np.max(np.abs(ref)), (case, i, err)
        # Every parameter moved (the updates are not lost below 1e-6).
        assert np.max(np.abs(got - init[i])) > 1e-4, (case, i)


def test_adam_bf16_first_moment_matches_optax():
    """On optax's clipped gradients the stored bf16 moment after five steps
    equals optax's bit for bit: the same f32 sums rounded at the same
    point, b1 * mu taken in bf16."""
    init, grads = _init(), _grads()
    _, jstate = _optax("adam_bf16_mu", init, grads)
    adam = jstate[1][0]  # chain(clip, adam): adam's (ScaleByAdamState, ...)
    module = _module(init)
    state = _port_state("adam_bf16_mu", module, clip_gradient_norm=0.0)
    _steps(state, module, _optax_clipped(grads))
    for p, want in zip(module.parameters(), adam.mu):
        mu = state.optimizer.state[p]["mu"]
        assert mu.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        np.testing.assert_array_equal(mu.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_state_dict_resumes_bit_for_bit(case):
    init, grads = _init(), _grads()
    module = _module(init)
    state = _port_state(case, module)
    _steps(state, module, grads)
    resumed = _module(init)
    first = _port_state(case, resumed)
    _steps(first, resumed, grads[:2])
    saved = first.optimizer.state_dict()
    second = _port_state(case, resumed)
    second.optimizer.load_state_dict(saved)
    second.step = first.step
    for st in second.optimizer.state.values():  # the moment stays bf16
        if "mu" in st:
            assert st["mu"].dtype == torch.bfloat16
    _steps(second, resumed, grads[2:])
    for a, b in zip(module.parameters(), resumed.parameters()):
        assert torch.equal(a, b), case


def test_adafactor_factors_as_optax():
    """optax's _factored_dims: the second largest dimension must reach
    128; (d1, d0) are the second largest and the largest."""
    assert factored_dims((200, 130)) == (1, 0)
    assert factored_dims((128, 300)) == (0, 1)
    assert factored_dims((128, 128)) == (0, 1)
    assert factored_dims((127, 300)) is None
    assert factored_dims((300,)) is None
    module = _module(_init())
    state = _port_state("adafactor", module)
    _steps(state, module, _grads(steps=1))
    shapes = [{k: tuple(v.shape) for k, v in state.optimizer.state[p].items()
               if k != "step"} for p in module.parameters()]
    assert shapes == [{"v_row": (130,), "v_col": (200,)},
                      {"v_row": (128,), "v_col": (300,)},
                      {"v": (7,)}, {"v": (9, 5)}]


def test_every_jax_optimizer_name_is_ported():
    assert set(OPTIMIZERS) == {"AdamOptimizer", "AdafactorOptimizer",
                               "SgdOptimizer", "GradientDescentOptimizer",
                               "RMSPropOptimizer", "AdagradOptimizer"}
    with pytest.raises(ValueError, match="unknown optimizer"):
        _port_state("adam", _module(_init())).__class__(
            _module(_init()), optimizer="LambOptimizer")
    with pytest.raises(ValueError, match="adam_mu_dtype"):
        TrainState(_module(_init()), adam_mu_dtype="float16")
