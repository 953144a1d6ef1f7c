"""The port's trainable NetVLAD core (yt8m_tpu_torch/kernels/netvlad_train.py,
--netvlad_fused_train) against the JAX package's netvlad_core.

On the CPU the port runs the plain versions of its kernels; the JAX side
runs its Pallas kernels in interpret mode (YT8M_PALLAS_INTERPRET=1, or
`interpret=True`): without that variable the JAX model takes its plain
graph on the CPU and the comparison would be of two different graphs.
Tolerances:
  * the core's forward (vlad, a_sum) and its VJP (dact, dx, dcenters) at
    B=4, F=11, D=16, K=8, num_frames [11, 4, 1, 0]: 3e-3 * max(1,
    max|ref|), the bf16 level (docs/KERNELS.md, "bf16 divergence vs
    XLA"): both sides round the products' operands to bf16 at the same
    points, so a last-bit difference of an f32 softmax or sum before a
    rounding can move one operand by one bf16 step (1e-6 is read here).
  * one SGD step of NetVladModel and of a small NetVladLstmModel with
    the fused core (float32 compute; the core still rounds to bf16), from
    the same weights and batch: the loss within 3e-3 relative, the
    predictions within 3e-3, and each variable's move (lr times its
    clipped gradient) within 2e-2 of its largest move, the bound the
    bf16 flagship step of tests/test_torch_train.py holds: a gradient
    through bf16-rounded products meets JAX's at the bf16 level of its
    largest element (1.1e-2 read, on the assignment BatchNorm's bias, a
    sum over frames of softmax gradients that nearly cancel; the losses
    within 4e-5).
  * the fused and the plain training graphs of the port agree at the
    bf16 level (3e-3) in float32 compute: the plain graph rounds the same
    operands only at bfloat16 compute, so they differ by that rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.netvlad_train import netvlad_core as jax_core
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.train import losses as jax_losses
from yt8m_tpu.train.state import TrainState as JaxTrainState
from yt8m_tpu.train.state import make_optimizer as jax_make_optimizer
from yt8m_tpu.train.step import make_train_step as jax_make_train_step
from yt8m_tpu_torch.convert import state_dict_from_jax, variables_from_model
from yt8m_tpu_torch.kernels import netvlad_train as tnt
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train import losses as tlosses
from yt8m_tpu_torch.train.state import TrainState
from yt8m_tpu_torch.train.step import make_train_step

B, F, D, K = 4, 11, 16, 8
BF16 = 3e-3


def _close(got, want, rel=BF16, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), (name, err)


def _core_inputs(seed):
    rng = np.random.default_rng(seed)
    act = rng.normal(size=(B, F, K)).astype(np.float32)
    x = rng.normal(size=(B, F, D)).astype(np.float32)
    nf = np.array([F, 4, 1, 0], dtype=np.int32)
    centers = rng.normal(size=(K, D)).astype(np.float32)
    dvlad = rng.normal(size=(B, K, D)).astype(np.float32)
    return act, x, nf, centers, dvlad


def test_plain_forward_matches_jax_kernel():
    act, x, nf, centers, _ = _core_inputs(0)
    from yt8m_tpu.kernels.netvlad_train import _run_fwd

    jv, ja = _run_fwd(jnp.asarray(act), jnp.asarray(x), jnp.asarray(nf),
                      jnp.asarray(centers), True)
    vlad, a_sum = tnt.netvlad_core_plain_forward(
        torch.from_numpy(act), torch.from_numpy(x), torch.from_numpy(nf),
        torch.from_numpy(centers))
    _close(vlad.numpy(), np.asarray(jv), name="vlad")
    _close(a_sum.numpy(), np.asarray(ja)[:, 0], name="a_sum")
    assert np.all(vlad.numpy()[3] == 0) and np.all(a_sum.numpy()[3] == 0)


def test_plain_backward_and_function_match_jax_vjp():
    act, x, nf, centers, dvlad = _core_inputs(1)
    _, vjp = jax.vjp(
        lambda a, xx, c: jax_core(a, xx, jnp.asarray(nf), c, True),
        jnp.asarray(act), jnp.asarray(x), jnp.asarray(centers))
    want = vjp(jnp.asarray(dvlad))
    t = [torch.from_numpy(v) for v in (act, x, nf, centers, dvlad)]
    dact, dx = tnt.netvlad_core_plain_backward(*t)
    _close(dact.numpy(), np.asarray(want[0]), name="plain dact")
    _close(dx.numpy(), np.asarray(want[1]), name="plain dx")
    ta = t[0].clone().requires_grad_()
    tx = t[1].clone().requires_grad_()
    tc = t[3].clone().requires_grad_()
    (tnt.netvlad_core(ta, tx, t[2], tc) * t[4]).sum().backward()
    for name, got, w in zip(("dact", "dx", "dcenters"),
                            (ta.grad, tx.grad, tc.grad), want):
        _close(got.numpy(), np.asarray(w), name=name)
    # Past num_frames: exact zeros, whatever act and x hold there.
    past = np.arange(F)[None, :] >= nf[:, None]
    assert np.all(ta.grad.numpy()[past] == 0)
    assert np.all(tx.grad.numpy()[past] == 0)


def test_function_skips_dx_when_x_needs_no_gradient():
    act, x, nf, centers, dvlad = _core_inputs(2)
    ta = torch.from_numpy(act).requires_grad_()
    tc = torch.from_numpy(centers).requires_grad_()
    before = tnt.netvlad_core_backward.launches
    vlad = tnt.netvlad_core(ta, torch.from_numpy(x), torch.from_numpy(nf), tc)
    (vlad * torch.from_numpy(dvlad)).sum().backward()
    want_dact, _ = tnt.netvlad_core_plain_backward(
        *(torch.from_numpy(v) for v in (act, x, nf, centers, dvlad)))
    torch.testing.assert_close(ta.grad, want_dact, rtol=0, atol=0)
    assert tc.grad is not None
    # CPU tensors take the plain versions: no kernel was launched.
    assert tnt.netvlad_core_backward.launches == before


# ---------------------------------------------------------------------------
# The fused training path of the models
# ---------------------------------------------------------------------------

C, MB, MF, MD = 12, 5, 9, 16
NETVLAD = dict(netvlad_cluster_size=8, netvlad_hidden_size=16,
               netvlad_fused_train=True)
FLAGSHIP = dict(NETVLAD, lstm_cells=16, lstm_layers=2)
OPT = dict(base_learning_rate=0.01, learning_rate_decay=0.95,
           learning_rate_decay_examples=2 * MB, global_batch_size=MB,
           clip_gradient_norm=1.0)


def _batch(seed):
    rng = np.random.default_rng(seed)
    nf = rng.integers(1, MF + 1, size=MB).astype(np.int32)
    nf[:2] = [MF, 1]
    return {
        "features": rng.integers(0, 256, size=(MB, MF, MD), dtype=np.uint8),
        "labels": (rng.uniform(size=(MB, C)) < 0.25).astype(np.float32),
        "num_frames": nf,
        "batch_mask": np.array([1, 1, 1, 1, 0], np.float32),
    }


def _hp(cls, cfg):
    return cls(vocab_size=C, feature_dim=MD, max_frames=MF,
               compute_dtype="float32", **cfg)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.array(v, np.float64)
    return out


def _one_sgd_step(name, cfg, monkeypatch):
    monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    batch = _batch(3)
    jmodel = jax_get_model(name, _hp(JaxHParams, cfg))
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(batch["features"]), jnp.asarray(batch["num_frames"]),
        train=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_make_optimizer(optimizer="SgdOptimizer", **OPT))
    jstep = jax_make_train_step(jmodel, jax_losses.get_loss(
        "CrossEntropyLoss"), donate=False)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(2))
    model = get_model(name, _hp(ModelHParams, cfg))
    model.load_state_dict(state_dict_from_jax(variables))
    state = TrainState(model, optimizer="SgdOptimizer", **OPT)
    step = make_train_step(tlosses.get_loss("CrossEntropyLoss"))
    before = tnt.netvlad_core_forward.launches
    state, pm = step(state, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert tnt.netvlad_core_forward.launches == before  # CPU: plain
    start = _flat(variables["params"])
    got = _flat(variables_from_model(state.model)["params"])
    want = _flat(jax.tree_util.tree_map(np.asarray, dict(jstate.params)))
    return float(jm["loss"]), float(pm["loss"]), jm, pm, start, got, want


@pytest.mark.parametrize("name,cfg", [("NetVladModel", NETVLAD),
                                      ("NetVladLstmModel", FLAGSHIP)])
def test_fused_sgd_step_matches_jax(name, cfg, monkeypatch):
    jloss, ploss, jm, pm, start, got, want = _one_sgd_step(name, cfg,
                                                           monkeypatch)
    np.testing.assert_allclose(ploss, jloss, rtol=BF16)
    np.testing.assert_allclose(pm["predictions"].numpy(),
                               np.asarray(jm["predictions"]), atol=BF16)
    assert set(got) == set(want) == set(start)
    for key in want:
        moved = want[key] - start[key]
        err = np.max(np.abs(got[key] - want[key]))
        assert err <= 2e-2 * np.max(np.abs(moved)) + 1e-12, (key, err)


def test_fused_and_plain_training_forwards_agree():
    batch = _batch(4)
    hp = _hp(ModelHParams, FLAGSHIP)
    fused = get_model("NetVladLstmModel", hp).train()
    plain = get_model("NetVladLstmModel", hp.replace(
        netvlad_fused_train=False)).train()
    plain.load_state_dict(fused.state_dict())
    assert fused.vlad.fused_train and not plain.vlad.fused_train
    args = (torch.from_numpy(batch["features"]),
            torch.from_numpy(batch["num_frames"]))
    a = fused(*args)["predictions"]
    b = plain(*args)["predictions"]
    _close(a.detach().numpy(), b.detach().numpy(), name="predictions")
    # --netvlad_use_pallas=false turns the fused core off, as in JAX.
    off = get_model("NetVladModel", _hp(ModelHParams, dict(
        NETVLAD, netvlad_use_pallas=False)))
    assert not off.vlad.fused_train
