"""The port's trainable LSTM recurrence (yt8m_tpu_torch/kernels/
lstm_train.py) against the JAX package's lstm_recurrence_trainable.

On the CPU the port runs its plain forward and backward; the JAX side
runs its two Pallas kernels in interpret mode (as tests/test_kernels.py
runs them). The same inputs and cotangents, made with numpy from a seed,
go to both. Tolerances:
  * final state, loss and gradients against the JAX kernel: max|diff|
    <= 1e-5 * max|ref| + 1e-6. Both sides round the same values to bf16
    at the same points (h, the residuals, dout, dZ); only the f32
    summation order and the transcendentals' last bits differ.
  * the bf16 values themselves (outputs, gates, c_t, dZ): 2^-8 * max|ref|
    + 1e-6. Where an f32 value lies within that last-bit difference of a
    bf16 rounding boundary the two sides round it one bf16 step apart
    (read here: c_t one step apart at 0.06, 2.4e-4).
  * against autograd of the scan-free plain recurrence
    (kernels/lstm.py :: lstm_recurrence_plain, differentiable): the JAX
    package's own normalised 3e-2 for its kernel against its scan: the
    trainable version rounds the residuals and dZ to bf16, autograd does
    not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.lstm_train import (
    _run_bwd,
    _run_fwd,
    lstm_recurrence_trainable as jax_trainable,
)
from yt8m_tpu_torch.kernels import lstm_train as tl
from yt8m_tpu_torch.kernels._schedule import live_schedule, product_rows
from yt8m_tpu_torch.kernels.lstm import lstm_recurrence_plain, pad_units

F, B, H = 6, 8, 128
G = 4 * H
NUM_FRAMES = np.array([6, 2, 1, 6, 4, 3, 5, 2], np.int32)
BF16_REL = 2.0 ** -8
# num_frames for the CUDA backward's schedule: 0, 1, F and out of range
# (below 0: never live; past F: live at every step), every row dead,
# every row live.
SCHEDULE_FRAMES = {
    "ragged": NUM_FRAMES,
    "edges": np.array([6, 0, 1, -3, 9, 3, 12, 2], np.int32),
    "dead": np.zeros(8, np.int32),
    "live": np.full(8, 6, np.int32),
}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    xp = rng.normal(0, 0.5, size=(F, B, G)).astype(np.float32)
    wh = rng.normal(0, 0.1, size=(H, G)).astype(np.float32)
    bias = rng.normal(0, 0.05, size=(G,)).astype(np.float32)
    wo = rng.normal(size=(F, B, H)).astype(np.float32)
    wf = rng.normal(size=(B, H)).astype(np.float32)
    return xp, wh, bias, wo, wf


def _close(got, want, rel=1e-5, abs_=1e-6, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)) + abs_, (name, err)


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_plain_forward_and_residuals_match_jax_kernel(reverse):
    xp, wh, bias, _, _ = _inputs(1 + reverse)
    nf = jnp.asarray(NUM_FRAMES)
    outs, gates, cs, fh, fc, _, _ = _run_fwd(
        jnp.asarray(xp), nf, jnp.asarray(wh), jnp.asarray(bias), reverse,
        128, True)
    p_outs, p_gates, p_cs, p_c, p_h = tl.lstm_train_forward(
        torch.from_numpy(xp), torch.from_numpy(NUM_FRAMES),
        torch.from_numpy(wh), torch.from_numpy(bias), reverse)
    for name, got, want in (("outs", p_outs, outs), ("gates", p_gates, gates),
                            ("cs", p_cs, cs), ("c", p_c, fc), ("h", p_h, fh)):
        want = np.asarray(jnp.asarray(want, jnp.float32))[:, :B] \
            if want.ndim == 3 else np.asarray(want)[:B]
        _close(_f32(got), want, name=name,
               rel=BF16_REL if got.dtype == torch.bfloat16 else 1e-5)
    # bf16 outputs, residuals, exactly the values JAX keeps
    assert p_outs.dtype == p_gates.dtype == p_cs.dtype == torch.bfloat16


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_plain_backward_matches_jax_kernel_on_the_same_residuals(reverse):
    """The backward alone, fed JAX's own residuals and cotangents."""
    xp, wh, bias, wo, wf = _inputs(3 + reverse)
    nf = jnp.asarray(NUM_FRAMES)
    outs, gates, cs, _, _, _, _ = _run_fwd(
        jnp.asarray(xp), nf, jnp.asarray(wh), jnp.asarray(bias), reverse,
        128, True)
    want = _run_bwd(jnp.asarray(wo), jnp.asarray(2.0 * wf),
                    jnp.asarray(wf), gates, cs, nf, jnp.asarray(wh),
                    reverse, 128, True)
    to_t = lambda a: torch.from_numpy(np.array(a, np.float32))  # noqa: E731
    got = tl.lstm_train_backward(
        torch.from_numpy(wo), torch.from_numpy(wf),
        torch.from_numpy(2.0 * wf),
        to_t(jnp.asarray(gates, jnp.float32)).to(torch.bfloat16),
        to_t(jnp.asarray(cs, jnp.float32)).to(torch.bfloat16),
        torch.from_numpy(NUM_FRAMES), torch.from_numpy(wh), reverse)
    assert got.dtype == torch.bfloat16 and got.shape == (F, B, G)
    _close(_f32(got), np.asarray(jnp.asarray(want, jnp.float32)), name="dZ",
           rel=BF16_REL)


def _port_grads(xp, wh, bias, wo, wf, reverse):
    x = torch.from_numpy(xp).requires_grad_()
    w = torch.from_numpy(wh).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    outs, (fc, fh) = tl.lstm_recurrence_trainable(
        x, torch.from_numpy(NUM_FRAMES), w, b, reverse)
    loss = (torch.sum(outs * torch.from_numpy(wo))
            + torch.sum(fc * torch.from_numpy(wf))
            + 2.0 * torch.sum(fh * torch.from_numpy(wf)))
    loss.backward()
    return loss.item(), x.grad.numpy(), w.grad.numpy(), b.grad.numpy()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_trainable_gradients_match_jax_kernel(reverse):
    xp, wh, bias, wo, wf = _inputs(5 + reverse)
    nf = jnp.asarray(NUM_FRAMES)

    def loss(xp, wh, bias):
        outs, (fc, fh) = jax_trainable(xp, nf, wh, bias, reverse, 128, True)
        return (jnp.sum(outs * wo) + jnp.sum(fc * wf)
                + 2.0 * jnp.sum(fh * wf))

    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bias))
    p_val, *p_grads = _port_grads(xp, wh, bias, wo, wf, reverse)
    _close(p_val, float(val), rel=1e-5, abs_=1e-4, name="loss")
    for name, got, want in zip(("dx", "dwh", "db"), p_grads, grads):
        assert got.dtype == np.float32
        _close(got, np.asarray(want), name=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_trainable_gradients_match_autograd_of_the_plain_recurrence(reverse):
    xp, wh, bias, wo, wf = _inputs(7 + reverse)
    nf = torch.from_numpy(NUM_FRAMES)
    x = torch.from_numpy(xp).requires_grad_()
    w = torch.from_numpy(wh).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    outs, (fc, fh) = lstm_recurrence_plain(x, nf, w, b, reverse)
    loss = (torch.sum(outs * torch.from_numpy(wo))
            + torch.sum(fc * torch.from_numpy(wf))
            + 2.0 * torch.sum(fh * torch.from_numpy(wf)))
    loss.backward()
    p_val, *p_grads = _port_grads(xp, wh, bias, wo, wf, reverse)
    assert np.allclose(p_val, loss.item(), rtol=2e-2, atol=1e-2)
    for name, got, want in zip(("dx", "dwh", "db"), p_grads,
                               (x.grad, w.grad, b.grad)):
        want = want.numpy()
        scale = np.abs(want).max() or 1.0
        np.testing.assert_allclose(got / scale, want / scale, atol=3e-2,
                                   err_msg=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_frozen_steps_pass_gradients_through_and_emit_zero_dz(reverse):
    """±1e4 in x_proj past num_frames: outputs and every gradient equal
    to those with zeros there, and dZ exactly 0 on frozen steps."""
    xp, wh, bias, wo, wf = _inputs(9)
    clean, loud = xp.copy(), xp.copy()
    for i, n in enumerate(NUM_FRAMES):
        t = slice(0, F - n) if reverse else slice(n, F)  # flipped when reversed
        clean[t, i] = 0.0
        loud[t, i] = np.where(np.arange(G) % 2 == 0, 1e4, -1e4)
    a = _port_grads(clean, wh, bias, wo, wf, reverse)
    b = _port_grads(loud, wh, bias, wo, wf, reverse)
    assert a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        np.testing.assert_array_equal(x, y)
    frozen = np.zeros((F, B), bool)
    for i, n in enumerate(NUM_FRAMES):
        frozen[slice(0, F - n) if reverse else slice(n, F), i] = True
    assert np.all(b[1][frozen] == 0)


def test_padded_units_give_the_same_gradients():
    """The card pads H to a multiple of 64 with units whose weights are
    zero; on the plain version those units change nothing and get dZ 0."""
    rng = np.random.default_rng(11)
    f, b, h, hp = 5, 4, 24, 64
    xp = torch.from_numpy(rng.normal(0, .5, (f, b, 4 * h)).astype(np.float32))
    wh = torch.from_numpy(rng.normal(0, .2, (h, 4 * h)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, .1, (4 * h,)).astype(np.float32))
    nf = torch.tensor([5, 3, 0, 1], dtype=torch.int32)
    dout = torch.from_numpy(rng.normal(size=(f, b, h)).astype(np.float32))
    dfh = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32))
    outs, gates, cs, c, hh = tl.lstm_train_forward(xp, nf, wh, bias)
    dz = tl.lstm_train_backward(dout, 0 * dfh, dfh, gates, cs, nf, wh)
    xq, wq, bq = pad_units(hp, xp, wh, bias)
    pad = torch.nn.functional.pad
    o2, g2, c2, _, _ = tl.lstm_train_forward(xq, nf, wq, bq)
    dz2 = tl.lstm_train_backward(pad(dout, (0, hp - h)), 0 * pad(dfh, (0, hp - h)),
                                 pad(dfh, (0, hp - h)), g2, c2, nf, wq)
    assert torch.equal(o2[..., :h], outs) and torch.equal(c2[..., :h], cs)
    assert torch.equal(tl._unpad(g2, h), gates)
    assert torch.equal(tl._unpad(dz2, h), dz)
    assert torch.all(o2[..., h:] == 0)
    assert torch.all(tl._unpad(dz2[..., :], hp).reshape(f, b, 4, hp)[..., h:] == 0)


def test_rounding_report_counts_what_the_witness_reads():
    """The card witness's reader on planted values: one value a bf16 step
    off at a rounding midpoint, one small value with its sign flipped
    (many steps apart), one a whole 1e-2 off."""
    plain = torch.linspace(0.5, 1.0, 1000)
    mid = 0.75 + 2.0 ** -9  # halfway between two bf16 values
    plain[100] = mid
    plain[200] = 1e-5
    kernel = plain.to(torch.bfloat16)
    kernel[100] = torch.tensor(0.75 + 2.0 ** -8, dtype=torch.bfloat16)
    kernel[200] = torch.tensor(-1e-5, dtype=torch.bfloat16)
    r = tl.rounding_report(kernel, plain)
    assert (r.n, r.n_far, r.median) == (2, 1, 0.0)
    assert r.far_value == pytest.approx(1e-5) and r.far_steps > 1000
    assert r.excess == pytest.approx(2e-5 - 2.0 ** -8 * 1e-5, rel=1e-2)
    kernel[300] = kernel[300] + 1e-2
    assert tl.rounding_report(kernel, plain).excess > 5e-3


@pytest.mark.parametrize("frames", sorted(SCHEDULE_FRAMES))
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_backward_by_schedule_matches_plain_and_jax(frames, reverse):
    """The CUDA backward's decomposition in plain PyTorch (the live prefix
    of each step multiplied, the frozen steps' dout summed into the dh
    carry in bulk) equals lstm_train_backward_plain within 1e-6 *
    max(1, max|ref|), and JAX's backward kernel (interpret mode) on the
    same residuals within the file's bf16 bound."""
    nf_np = SCHEDULE_FRAMES[frames]
    xp, wh, bias, wo, wf = _inputs(13 + reverse)
    nf = jnp.asarray(nf_np)
    outs, gates, cs, _, _, _, _ = _run_fwd(
        jnp.asarray(xp), nf, jnp.asarray(wh), jnp.asarray(bias), reverse,
        128, True)
    want = _run_bwd(jnp.asarray(wo), jnp.asarray(2.0 * wf),
                    jnp.asarray(wf), gates, cs, nf, jnp.asarray(wh),
                    reverse, 128, True)
    to_bf = lambda a: torch.from_numpy(  # noqa: E731
        np.array(jnp.asarray(a, jnp.float32))).to(torch.bfloat16)
    args = (torch.from_numpy(wo), torch.from_numpy(wf),
            torch.from_numpy(2.0 * wf), to_bf(gates), to_bf(cs),
            torch.from_numpy(nf_np), torch.from_numpy(wh), reverse)
    got = tl.lstm_train_backward_by_schedule(*args)
    plain = _f32(tl.lstm_train_backward_plain(*args))
    assert got.dtype == torch.bfloat16 and got.shape == (F, B, G)
    _close(_f32(got), plain, rel=1e-6, abs_=1e-6, name="dZ vs plain")
    _close(_f32(got), np.asarray(jnp.asarray(want, jnp.float32)),
           rel=BF16_REL, name="dZ vs JAX")


@pytest.mark.parametrize("frames", sorted(SCHEDULE_FRAMES))
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_schedule_counts_the_live_and_product_rows(frames, reverse):
    """live[t] counts num_frames > orig_t; the order lists those rows
    first; the backward multiplies at step t the rows live at both t and
    t+1 (n > orig_t and n > orig_next), none at t = F-1."""
    nf = SCHEDULE_FRAMES[frames]
    order, live = live_schedule(torch.from_numpy(nf), F, reverse)
    orig = [(F - 1 - t) if reverse else t for t in range(F + 1)]
    want_live = [int(np.sum(nf > orig[t])) for t in range(F)]
    want_prod = [int(np.sum((nf > orig[t]) & (nf > orig[t + 1])))
                 if t + 1 < F else 0 for t in range(F)]
    assert live.tolist() == want_live
    assert product_rows(live).tolist() == want_prod
    for t in range(F):
        assert np.all(nf[order[:live[t]].numpy()] > orig[t])
