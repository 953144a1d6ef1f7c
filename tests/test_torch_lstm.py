"""The port's LSTM recurrence (yt8m_tpu_torch/kernels/lstm.py) and its
stacked LSTM (models/rnn.py) against the JAX package.

On the CPU the recurrence wrapper runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, or its lax.scan oracle.
The same inputs, made with numpy from a seed, go to both. Tolerances:
  * recurrence: max|diff| <= 1e-5 * max|ref| + 1e-6. Both sides round h,
    W_h and x_proj to bf16 at the same points; only the f32 summation
    order and the transcendental functions' last bits differ.
  * stacked LSTM at float32 (the scan graph on both sides): 1e-5.
  * stacked LSTM at bf16 (the recurrence on both sides, JAX through its
    kernel with YT8M_PALLAS_INTERPRET=1): 3e-3. The input projection is a
    bf16 product on both sides, summed in another order; a last-bit
    difference before a bf16 rounding moves that operand by one bf16 step
    (docs/KERNELS.md, "bf16 divergence vs XLA").
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.lstm import (
    lstm_recurrence as jax_lstm,
    lstm_recurrence_reference,
)
from yt8m_tpu.models import rnn as jrnn
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.kernels import lstm as tlstm
from yt8m_tpu_torch.kernels._schedule import live_schedule
from yt8m_tpu_torch.models import rnn as trnn

F, B, H, D = 13, 5, 16, 32
NUM_FRAMES = np.array([13, 1, 0, 7, 12], np.int32)


def _close(got, want, rel=1e-5, abs_=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)) + abs_, err


def _recurrence_inputs(seed):
    rng = np.random.default_rng(seed)
    xp = rng.normal(0, 0.5, size=(F, B, 4 * H)).astype(np.float32)
    wh = rng.normal(0, 0.3, size=(H, 4 * H)).astype(np.float32)
    bias = rng.normal(0, 0.1, size=(4 * H,)).astype(np.float32)
    return xp, NUM_FRAMES, wh, bias


def _port_recurrence(args, reverse):
    xp, nf, wh, bias = map(torch.from_numpy, args)
    outs, (c, h) = tlstm.lstm_recurrence(xp, nf, wh, bias, reverse=reverse)
    return outs.numpy(), c.numpy(), h.numpy()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "lax_scan"])
def test_lstm_plain_matches_jax(oracle, reverse):
    args = _recurrence_inputs(1 + reverse)
    jargs = tuple(map(jnp.asarray, args))
    if oracle == "pallas_interpret":
        w_outs, (w_c, w_h) = jax_lstm(*jargs, reverse=reverse, interpret=True)
    else:
        w_outs, (w_c, w_h) = lstm_recurrence_reference(*jargs,
                                                       reverse=reverse)
    outs, c, h = _port_recurrence(args, reverse)
    assert outs.shape == (F, B, H) and outs.dtype == np.float32
    _close(outs, np.asarray(w_outs))
    _close(c, np.asarray(w_c))
    _close(h, np.asarray(w_h))
    # num_frames 0: the carry never moves.
    assert np.all(outs[:, 2] == 0) and np.all(c[2] == 0) and np.all(h[2] == 0)
    # outputs are bf16 values widened to f32
    assert np.array_equal(outs, torch.from_numpy(outs).bfloat16().float()
                          .numpy())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_lstm_frozen_carry_ignores_steps_past_num_frames(reverse):
    xp, nf, wh, bias = _recurrence_inputs(3)
    clean = xp.copy()
    loud = xp.copy()
    for i, n in enumerate(nf):
        t = slice(0, F - n) if reverse else slice(n, F)  # x_proj is flipped
        clean[t, i] = 0.0
        loud[t, i] = np.where(np.arange(4 * H) % 2 == 0, 1e4, -1e4)
    a = _port_recurrence((clean, nf, wh, bias), reverse)
    b = _port_recurrence((loud, nf, wh, bias), reverse)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


SCHEDULE_FRAMES = {
    "none": [0, 0, 0, 0, 0],
    "one": [1, 1, 1, 1, 1],
    "all": [F, F, F, F, F],
    "ragged": list(NUM_FRAMES),
    "ties": [7, 3, 7, 0, 3],
    "out_of_range": [-2, F + 4, 0, -7, 5],
}

# num_frames past either end: a row at or below 0 is dead at every step,
# one past F live at every step.
OUT_OF_RANGE = np.array(SCHEDULE_FRAMES["out_of_range"], np.int32)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("frames", sorted(SCHEDULE_FRAMES))
def test_live_schedule_matches_a_numpy_count(frames, reverse):
    nf = np.array(SCHEDULE_FRAMES[frames], np.int32)
    order, live = live_schedule(torch.from_numpy(nf), F, reverse)
    assert order.dtype == torch.int32 and live.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(-nf, kind="stable"))
    orig = F - 1 - np.arange(F) if reverse else np.arange(F)
    want = (nf[None, :] > orig[:, None]).sum(1)
    np.testing.assert_array_equal(live.numpy(), want)
    # The live rows of each step are a prefix of the order.
    for t in range(F):
        prefix = set(order.numpy()[:live[t]].tolist())
        assert prefix == set(np.nonzero(nf > orig[t])[0].tolist())


def _lstm_live_prefix(xp, nf, wh, bias, reverse):
    """The plain cell as the kernel runs it on rows in schedule order:
    step t updates the first live[t] rows only (the others keep their
    carry). Inputs and outputs in schedule order."""
    f, b, g = xp.shape
    hd = g // 4
    _, live = live_schedule(nf, f, reverse)
    w = wh.to(torch.bfloat16).to(torch.float32)
    xs = xp.to(torch.bfloat16).to(torch.float32)
    h = torch.zeros((b, hd))
    c = torch.zeros((b, hd))
    outs = []
    for t in range(f):
        n = int(live[t])
        z = torch.matmul(h[:n].to(torch.bfloat16).to(torch.float32), w) + xs[t, :n]
        _, c[:n], h[:n] = tlstm.lstm_cell(z + bias, c[:n], hd)
        outs.append(h.to(torch.bfloat16))
    return torch.stack(outs).to(torch.float32), (c, h)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("run", ["plain", "live_prefix"])
def test_lstm_in_schedule_order_matches_jax(run, reverse):
    args = _recurrence_inputs(5 + reverse)
    xp, nf, wh, bias = map(torch.from_numpy, args)
    order, _ = live_schedule(nf, F, reverse)
    o = order.long()
    fn = tlstm.lstm_recurrence_plain if run == "plain" else _lstm_live_prefix
    s_outs, (s_c, s_h) = fn(xp[:, o], nf[o], wh, bias, reverse)
    outs, c, h = (torch.empty_like(s_outs), torch.empty_like(s_c),
                  torch.empty_like(s_h))
    outs[:, o], c[o], h[o] = s_outs, s_c, s_h  # back to the caller's order
    w_outs, (w_c, w_h) = lstm_recurrence_reference(
        *map(jnp.asarray, args), reverse=reverse)
    _close(outs.numpy(), np.asarray(w_outs))
    _close(c.numpy(), np.asarray(w_c))
    _close(h.numpy(), np.asarray(w_h))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_lstm_live_prefix_out_of_range_num_frames_matches_jax(reverse):
    xp, _, wh, bias = _recurrence_inputs(9 + reverse)
    args = (xp, OUT_OF_RANGE, wh, bias)
    t = list(map(torch.from_numpy, args))
    order, _ = live_schedule(t[1], F, reverse)
    o = order.long()
    s_outs, (s_c, s_h) = _lstm_live_prefix(t[0][:, o], t[1][o], t[2], t[3],
                                           reverse)
    outs, c, h = (torch.empty_like(s_outs), torch.empty_like(s_c),
                  torch.empty_like(s_h))
    outs[:, o], c[o], h[o] = s_outs, s_c, s_h
    w_outs, (w_c, w_h) = lstm_recurrence_reference(
        *map(jnp.asarray, args), reverse=reverse)
    _close(outs.numpy(), np.asarray(w_outs))
    _close(c.numpy(), np.asarray(w_c))
    _close(h.numpy(), np.asarray(w_h))
    dead = OUT_OF_RANGE <= 0
    assert np.all(outs.numpy()[:, dead] == 0) and np.all(h.numpy()[dead] == 0)


class _JaxStack(fnn.Module):
    """The JAX package's _run_rnn over its _LstmLayer, as a module."""

    layers: int
    dtype: object
    bidirectional: bool
    pooling: str
    residual: bool

    @fnn.compact
    def __call__(self, features, num_frames):
        return jrnn._run_rnn(
            functools.partial(jrnn._LstmLayer, layer_norm=False), features,
            num_frames, layers=self.layers, hidden=H, dtype=self.dtype,
            bidirectional=self.bidirectional, pooling=self.pooling,
            residual=self.residual)


class _PortStack(torch.nn.Module):
    def __init__(self, layers, dtype, bidirectional):
        super().__init__()
        self.width = trnn.add_lstm_stack(self, D, H, layers, dtype,
                                         bidirectional)


STACKS = {
    "last": (2, False, "last", False),
    "last_residual": (2, False, "last", True),
    "bi_last_residual": (2, True, "last", True),
    "bi_max": (2, True, "max", False),
    "mean_residual": (3, False, "mean", True),
    "bi_mean": (1, True, "mean", False),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_run_rnn_matches_jax(stack, dtype, monkeypatch):
    layers, bi, pooling, residual = STACKS[stack]
    if dtype == "bfloat16":
        monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(B, F, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jmod = _JaxStack(layers, jdt, bi, pooling, residual)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                          jnp.asarray(NUM_FRAMES))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32)
        if a.ndim == 1 else a, variables)  # non-zero biases
    want = np.asarray(jmod.apply(params, jnp.asarray(feats),
                                 jnp.asarray(NUM_FRAMES)))
    port = _PortStack(layers, getattr(torch, dtype), bi)
    port.load_state_dict(state_dict_from_jax(params))
    with torch.no_grad():
        got = trnn.run_rnn(port, torch.from_numpy(feats),
                           torch.from_numpy(NUM_FRAMES), layers, bi,
                           pooling, residual).numpy()
    assert got.shape == (B, port.width)
    tol = 3e-3 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_lstm_layer_norm_is_not_ported():
    """--lstm_layer_norm is ported: the layer builds with TF1's
    LayerNormBasicLSTMCell parameters (no `bias`) and runs its scan graph,
    never the recurrence kernel (tests/test_torch_zoo.py holds it against
    the JAX layer)."""
    layer = trnn.LstmLayer(D, H, layer_norm=True)
    assert {n: tuple(t.shape) for n, t in layer.state_dict().items()} == {
        "kernel": (D + H, 4 * H), "ln_scale": (5, H), "ln_bias": (5, H)}
    launches = tlstm.lstm_recurrence.launches
    xs = torch.randn(F, B, D, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out, (c, h) = layer.eval()(xs, torch.from_numpy(NUM_FRAMES))
    assert out.shape == (F, B, H) and torch.isfinite(out).all()
    assert tlstm.lstm_recurrence.launches == launches
