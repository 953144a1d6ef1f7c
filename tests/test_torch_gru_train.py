"""The port's trainable GRU recurrence (yt8m_tpu_torch/kernels/
gru_train.py) against the JAX package's gru_recurrence_trainable, and
two bf16 SGD steps of GruModel and BiGruModel against JAX.

On the CPU the port runs its plain forward and backward; the JAX side
runs its two Pallas kernels in interpret mode (as tests/test_kernels.py
runs them). The same inputs and cotangents, made with numpy from a seed,
go to both. Tolerances:
  * final state and loss against the JAX kernel: max|diff| <= 1e-5 *
    max|ref| + 1e-6. Both sides round the same values to bf16 at the
    same points (h, r * h, the residuals, dout, dA); only the f32
    summation order and the transcendentals' last bits differ.
  * the bf16 values themselves (outputs, gates, candidate, dA) and the
    gradients: 2^-8 * max|ref| + 1e-6: where an f32 value lies within
    that last-bit difference of a bf16 rounding boundary the two sides
    round it one bf16 step apart (read here: a dA_g value one bf16 step,
    4.9e-4, apart, which moves dW_hg by 2.0e-4 through hprev).
  * against autograd of the scan-free plain recurrence
    (kernels/gru.py :: gru_recurrence_plain, differentiable): the JAX
    package's own normalised 3e-2 for its kernel against its scan
    (tests/test_kernels.py): the trainable version rounds the residuals
    and dA to bf16, autograd does not.
  * two bf16 SGD steps of GruModel and BiGruModel (JAX's GRU through its
    trainable Pallas kernel in interpret mode, the port's through the
    plain version of its Function): the bounds tests/test_torch_train.py
    holds the LSTM family to: both losses and step 2's predictions
    within 3e-3, each variable's first move within 2e-2 of its largest
    move (the recurrent rows of each GRU kernel on their own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as train_tests
from yt8m_tpu.kernels.gru_train import (
    _run_bwd,
    _run_fwd,
    gru_recurrence_trainable as jax_trainable,
)
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.kernels import gru_train as tg
from yt8m_tpu_torch.kernels.gru import gru_recurrence_plain, pad_units
from yt8m_tpu_torch.kernels.lstm_train import rounding_report

F, B, H = 6, 8, 128
NUM_FRAMES = np.array([6, 2, 1, 6, 4, 3, 5, 2], np.int32)
BF16_REL = 2.0 ** -8
# num_frames for the CUDA backward's schedule: 0, 1, F and out of range,
# every row dead, every row live.
SCHEDULE_FRAMES = {
    "ragged": NUM_FRAMES,
    "edges": np.array([6, 0, 1, -3, 9, 3, 12, 2], np.int32),
    "dead": np.zeros(8, np.int32),
    "live": np.full(8, 6, np.int32),
}


def _inputs(seed, h=H, f=F, b=B):
    rng = np.random.default_rng(seed)
    xg = rng.normal(0, 0.5, size=(f, b, 2 * h)).astype(np.float32)
    xc = rng.normal(0, 0.5, size=(f, b, h)).astype(np.float32)
    whg = rng.normal(0, 0.1, size=(h, 2 * h)).astype(np.float32)
    whc = rng.normal(0, 0.1, size=(h, h)).astype(np.float32)
    bg = rng.normal(1.0, 0.05, size=(2 * h,)).astype(np.float32)
    bc = rng.normal(0, 0.05, size=(h,)).astype(np.float32)
    wo = rng.normal(size=(f, b, h)).astype(np.float32)
    wf = rng.normal(size=(b, h)).astype(np.float32)
    return (xg, xc, whg, whc, bg, bc), wo, wf


def _close(got, want, rel=1e-5, abs_=1e-6, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)) + abs_, (name, err)


def _f32(t):
    return np.asarray(t.to(torch.float32) if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _jax_fwd(w, reverse):
    xg, xc, whg, whc, bg, bc = map(jnp.asarray, w)
    return _run_fwd(xg, xc, jnp.asarray(NUM_FRAMES), whg, whc, bg, bc,
                    reverse, 128, True)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_plain_forward_and_residuals_match_jax_kernel(reverse):
    w, _, _ = _inputs(1 + reverse)
    outs, gates, cand, fh, _, _ = _jax_fwd(w, reverse)
    xg, xc, whg, whc, bg, bc = map(torch.from_numpy, w)
    p_outs, p_gates, p_cand, p_h = tg.gru_train_forward(
        xg, xc, torch.from_numpy(NUM_FRAMES), whg, whc, bg, bc, reverse)
    assert p_outs.dtype == p_gates.dtype == p_cand.dtype == torch.bfloat16
    for name, got, want in (("outs", p_outs, outs), ("gates", p_gates, gates),
                            ("cand", p_cand, cand)):
        _close(_f32(got), _f32(want)[:, :B], rel=BF16_REL, name=name)
    _close(p_h.numpy(), np.asarray(fh)[:B], name="h")


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_plain_backward_matches_jax_kernel_on_the_same_residuals(reverse):
    """The backward alone, fed JAX's own residuals and cotangents."""
    w, wo, wf = _inputs(3 + reverse)
    outs, gates, cand, _, _, _ = _jax_fwd(w, reverse)
    hprev = jnp.concatenate([jnp.zeros_like(outs[:1]), outs[:-1]], axis=0)
    dag, dac = _run_bwd(jnp.asarray(wo), jnp.asarray(wf), gates, cand, hprev,
                        jnp.asarray(NUM_FRAMES), jnp.asarray(w[2]),
                        jnp.asarray(w[3]), reverse, 128, True)
    bf = lambda a: _t(jnp.asarray(a, jnp.float32)).to(torch.bfloat16)  # noqa: E731
    got_g, got_c = tg.gru_train_backward(
        torch.from_numpy(wo), torch.from_numpy(wf), bf(gates), bf(cand),
        bf(outs), torch.from_numpy(NUM_FRAMES), torch.from_numpy(w[2]),
        torch.from_numpy(w[3]), reverse)
    assert got_g.dtype == got_c.dtype == torch.bfloat16
    assert got_g.shape == (F, B, 2 * H) and got_c.shape == (F, B, H)
    _close(_f32(got_g), _f32(dag), rel=BF16_REL, name="dA_g")
    _close(_f32(got_c), _f32(dac), rel=BF16_REL, name="dA_c")


@pytest.mark.parametrize("frames", sorted(SCHEDULE_FRAMES))
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_backward_by_schedule_matches_plain_and_jax(frames, reverse):
    """The CUDA backward's decomposition in plain PyTorch (the live prefix
    of each step multiplied, the frozen steps' dout summed into the dh
    carry in bulk) equals gru_train_backward_plain within 1e-6 *
    max(1, max|ref|), and JAX's backward kernel (interpret mode) on the
    same residuals within the file's bf16 bound."""
    nf_np = SCHEDULE_FRAMES[frames]
    w, wo, wf = _inputs(13 + reverse)
    xg, xc, whg, whc, bg, bc = map(jnp.asarray, w)
    nf = jnp.asarray(nf_np)
    outs, gates, cand, _, _, _ = _run_fwd(xg, xc, nf, whg, whc, bg, bc,
                                          reverse, 128, True)
    hprev = jnp.concatenate([jnp.zeros_like(outs[:1]), outs[:-1]], axis=0)
    dag, dac = _run_bwd(jnp.asarray(wo), jnp.asarray(wf), gates, cand, hprev,
                        nf, whg, whc, reverse, 128, True)
    def bf(a):
        return _t(jnp.asarray(a, jnp.float32)).to(torch.bfloat16)

    args = (torch.from_numpy(wo), torch.from_numpy(wf), bf(gates), bf(cand),
            bf(outs), torch.from_numpy(nf_np), torch.from_numpy(w[2]),
            torch.from_numpy(w[3]), reverse)
    got = tg.gru_train_backward_by_schedule(*args)
    plain = tg.gru_train_backward_plain(*args)
    for name, g, p, j in (("dA_g", got[0], plain[0], dag),
                          ("dA_c", got[1], plain[1], dac)):
        assert g.dtype == torch.bfloat16
        _close(_f32(g), _f32(p), rel=1e-6, abs_=1e-6, name=f"{name} vs plain")
        _close(_f32(g), _f32(j), rel=BF16_REL, name=f"{name} vs JAX")


NAMES = ("dxg", "dxc", "dwhg", "dwhc", "dbg", "dbc")


def _port_grads(w, wo, wf, reverse, fn=tg.gru_recurrence_trainable):
    params = [torch.from_numpy(a).requires_grad_() for a in w]
    xg, xc, whg, whc, bg, bc = params
    outs, fh = fn(xg, xc, torch.from_numpy(NUM_FRAMES), whg, whc, bg, bc,
                  reverse)
    loss = (torch.sum(outs * torch.from_numpy(wo))
            + 2.0 * torch.sum(fh * torch.from_numpy(wf)))
    loss.backward()
    return loss.item(), [p.grad.numpy() for p in params]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_trainable_gradients_match_jax_kernel(reverse):
    w, wo, wf = _inputs(5 + reverse)
    nf = jnp.asarray(NUM_FRAMES)

    def loss(xg, xc, whg, whc, bg, bc):
        outs, fh = jax_trainable(xg, xc, nf, whg, whc, bg, bc, reverse, 128,
                                 True)
        return jnp.sum(outs * wo) + 2.0 * jnp.sum(fh * wf)

    val, grads = jax.value_and_grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, w))
    p_val, p_grads = _port_grads(w, wo, wf, reverse)
    _close(p_val, float(val), rel=1e-5, abs_=1e-4, name="loss")
    for name, got, want in zip(NAMES, p_grads, grads):
        assert got.dtype == np.float32
        _close(got, np.asarray(want), name=name, rel=BF16_REL)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_trainable_gradients_match_autograd_of_the_plain_recurrence(reverse):
    w, wo, wf = _inputs(7 + reverse)
    p_val, p_grads = _port_grads(w, wo, wf, reverse)
    a_val, a_grads = _port_grads(w, wo, wf, reverse, gru_recurrence_plain)
    assert np.allclose(p_val, a_val, rtol=2e-2, atol=1e-2)
    for name, got, want in zip(NAMES, p_grads, a_grads):
        scale = np.abs(want).max() or 1.0
        np.testing.assert_allclose(got / scale, want / scale, atol=3e-2,
                                   err_msg=name)


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_frozen_steps_pass_gradients_through_and_emit_zero_da(reverse):
    """±1e4 in xg and xc past num_frames: outputs and every gradient
    equal to those with zeros there, and dA exactly 0 on frozen steps."""
    w, wo, wf = _inputs(9)
    frozen = np.zeros((F, B), bool)
    for i, n in enumerate(NUM_FRAMES):
        frozen[slice(0, F - n) if reverse else slice(n, F), i] = True
    clean = [a.copy() for a in w]
    loud = [a.copy() for a in w]
    for k in (0, 1):  # xg, xc (flipped in time when reversed)
        clean[k][frozen] = 0.0
        loud[k][frozen] = np.where(np.arange(w[k].shape[-1]) % 2 == 0, 1e4,
                                   -1e4)
    a = _port_grads(clean, wo, wf, reverse)
    b = _port_grads(loud, wo, wf, reverse)
    assert a[0] == b[0]
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    assert np.all(b[1][0][frozen] == 0) and np.all(b[1][1][frozen] == 0)


def test_padded_units_give_the_same_gradients():
    """The card pads H to a multiple of 64 with units whose weights are
    zero; on the plain version those units change nothing and get dA 0."""
    f, b, h, hp = 5, 4, 24, 64
    w, wo, wf = _inputs(11, h=h, f=f, b=b)
    xg, xc, whg, whc, bg, bc = map(torch.from_numpy, w)
    nf = torch.tensor([5, 3, 0, 1], dtype=torch.int32)
    dout, dfh = torch.from_numpy(wo), torch.from_numpy(wf)
    outs, gates, cand, _ = tg.gru_train_forward(xg, xc, nf, whg, whc, bg, bc)
    dag, dac = tg.gru_train_backward(dout, dfh, gates, cand, outs, nf, whg,
                                     whc)
    q = pad_units(hp, xg, xc, whg, whc, bg, bc)
    o2, g2, c2, _ = tg.gru_train_forward(*q[:2], nf, *q[2:])
    pad = torch.nn.functional.pad
    dag2, dac2 = tg.gru_train_backward(pad(dout, (0, hp - h)),
                                       pad(dfh, (0, hp - h)), g2, c2, o2, nf,
                                       q[2], q[3])
    for name, got, want in (("outs", o2[..., :h], outs),
                            ("gates", tg._unpad_gates(g2, h), gates),
                            ("cand", c2[..., :h], cand),
                            ("dA_g", tg._unpad_gates(dag2, h), dag),
                            ("dA_c", dac2[..., :h], dac)):
        _close(_f32(got), _f32(want), rel=BF16_REL, name=name)
    assert torch.all(o2[..., h:] == 0) and torch.all(c2[..., h:] == 0)
    assert torch.all(dac2[..., h:] == 0)
    assert torch.all(dag2.reshape(f, b, 2, hp)[..., h:] == 0)


def test_backward_on_stream_reproduces_the_plain_backward():
    """The card witness's backward fed the plain backward's own dA
    streams rounds to those streams, but for values at bf16 rounding
    boundaries (the plain backward's products take dA_c unmasked and in
    another grouping)."""
    w, wo, wf = _inputs(13)
    xg, xc, whg, whc, bg, bc = map(torch.from_numpy, w)
    nf = torch.from_numpy(NUM_FRAMES)
    outs, gates, cand, _ = tg.gru_train_forward(xg, xc, nf, whg, whc, bg, bc)
    dout, dfh = torch.from_numpy(wo), torch.from_numpy(wf)
    dag, dac = tg.gru_train_backward(dout, dfh, gates, cand, outs, nf, whg,
                                     whc)
    sg, sc = tg.backward_on_stream(dag, dac, dout, dfh, gates, cand, outs, nf,
                                   whg, whc)
    for got, want in ((dag, sg), (dac, sc)):
        r = rounding_report(got, want)
        assert r.excess <= 1e-5 and r.n_far == 0, r
        assert r.n <= 1e-3 * got.numel(), r


# ---------------------------------------------------------------------------
# two bf16 SGD steps of the GRU models against JAX
# ---------------------------------------------------------------------------

GRU = dict(gru_cells=16, gru_layers=2)


@pytest.mark.parametrize("name", ["GruModel", "BiGruModel"])
def test_bf16_gru_sgd_steps_match_jax(name, monkeypatch):
    """Under SGD the first step moves each variable by lr times its
    clipped gradient, so those moves hold the backward against JAX:
    JAX's through its trainable Pallas kernel, the port's through its
    Function (dW_hg and dW_hc into the kernels' recurrent rows, the bf16
    projections' gradients into their rows :D, the biases, the reversed
    direction). Step 2's loss reads the moved weights."""
    monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    jmodel = jax_get_model(name, train_tests._hparams(JaxHParams, GRU,
                                                      "bfloat16"))
    start = train_tests._flat_params(train_tests._jax_state(
        jmodel, train_tests._batches(0, 1)[0])[0]["params"])
    record = []
    jloss, ploss, _, _, jm, pm, _ = train_tests._run_both(
        name, GRU, "bfloat16", monkeypatch, steps=2,
        optimizer="SgdOptimizer", record=record)
    np.testing.assert_allclose(ploss, jloss, rtol=3e-3)
    np.testing.assert_allclose(pm["predictions"].numpy(),
                               np.asarray(jm["predictions"]), atol=3e-3)
    got, want = record[0]
    assert set(got) == set(want) == set(start)
    h = GRU["gru_cells"]
    for key in want:
        parts = [slice(None)]
        if key.endswith(("gate_kernel", "candidate_kernel")):
            parts = [slice(None, -h), slice(-h, None)]  # input, recurrent
        for rows in parts:
            moved = want[key][rows].astype(np.float64) - start[key][rows]
            err = np.max(np.abs(got[key][rows] - want[key][rows]))
            assert err <= 2e-2 * np.max(np.abs(moved)), (key, rows, err)
