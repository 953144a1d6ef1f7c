"""The port's trainable NeXtVLAD aggregation
(yt8m_tpu_torch/kernels/nextvlad_train.py, --nextvlad_train_fused) and
NeXtVladModel training against the JAX package.

On the CPU the Function runs its plain forward and backward; the JAX
side runs nextvlad_aggregate_train's Pallas kernels in interpret mode
(`interpret=True`, or YT8M_PALLAS_INTERPRET=1 for the model, without
which the JAX model trains through its plain graph on the CPU).
Tolerances:
  * the five weight gradients against jax.vjp of the JAX kernel, at the
    shapes of tests/test_torch_nextvlad.py with uint8 and f32 frames and
    num_frames [10, 4, 1, 0]: 3e-3 * max(1, max|ref|), the bf16 level.
    Both round the same operands to bf16 at the same points (5e-4 read
    here). The interpret kernel contracts the uint8 dequantization into
    one fused multiply-add, which moves a frame by one bf16 step now and
    then (1.3e-2 on the gradients, read here), so for uint8 frames it is
    given the frames the port dequantized, and the port's uint8 path is
    held to its path on those frames bit for bit. The
    num_frames = 0 video takes the clamp branch (dv = dy * 1e6) and must
    add nothing: a batch of it alone gives zero gradients.
  * one SGD step of a small NeXtVladModel from the JAX model's weights
    and one batch: fused training (bf16 and f32 compute) against JAX in
    interpret mode, and the plain graph (--nextvlad_train_fused=false)
    against JAX's plain graph: the loss within 3e-3 relative, the
    predictions within 3e-3, each variable's move (lr times its clipped
    gradient) within 2e-2 of its largest move, as the other model
    families' step tests (tests/test_torch_netvlad_train.py). The one
    exception is vlad_bn's bias, whose gradient vanishes in exact
    arithmetic (hidden1_bn removes what it adds): its move on each side
    is held under 1e-3 of the largest move of any variable.
  * the port's fused and plain training graphs, from the same weights:
    predictions and loss within 3e-3, each weight gradient within 2e-2
    of its largest element (autograd of the plain graph rounds the
    cotangents at its casts, the fused VJP at the JAX kernel's points).
The reference workflow (cli.train -> cli.eval -> cli.inference) runs
NeXtVladModel on the CPU at the end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_nextvlad as serving_tests
from yt8m_tpu.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu.kernels.nextvlad_train import (
    nextvlad_aggregate_train as jax_train_core,
)
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.train import losses as jax_losses
from yt8m_tpu.train.state import TrainState as JaxTrainState
from yt8m_tpu.train.state import make_optimizer as jax_make_optimizer
from yt8m_tpu.train.step import make_train_step as jax_make_train_step
from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as inference_cli
from yt8m_tpu_torch.cli import train as train_cli
from yt8m_tpu_torch.convert import state_dict_from_jax, variables_from_model
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.kernels import nextvlad_train as tnt
from yt8m_tpu_torch.kernels.nextvlad import dequantized
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train import losses as tlosses
from yt8m_tpu_torch.train.state import TrainState
from yt8m_tpu_torch.train.step import compute_loss, make_train_step

BF16 = 3e-3
NAMES = ("dWe", "dWa", "dab", "dWc", "dcenters")


def _close(got, want, rel=BF16, name=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * max(1.0, np.max(np.abs(want))), (name, err)


def _jax_grads(x, nf, w, g, dy, dtype=jnp.bfloat16):
    _, vjp = jax.vjp(
        lambda *ws: jax_train_core(jnp.asarray(x), jnp.asarray(nf), *ws, g,
                                   DEQUANT_SCALE, DEQUANT_BIAS, True, dtype),
        *map(jnp.asarray, w))
    return [np.asarray(v) for v in vjp(jnp.asarray(dy))]


def _port_plain_grads(x, nf, w, g, dy, dtype=torch.bfloat16):
    t = [torch.from_numpy(v) for v in (x, nf, *w, dy)]
    return [v.numpy() for v in tnt.nextvlad_aggregate_train_plain_backward(
        *t[:7], t[7], g, dtype)]


def _cotangent(seed, k, p):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(serving_tests.B, k, p)).astype(np.float32)


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("d,lam,g,k", serving_tests.SHAPES)
def test_plain_backward_matches_jax_vjp(x_dtype, d, lam, g, k):
    x, nf, w = serving_tests._inputs(d + g + k + 1, x_dtype, d, lam, g, k)
    dy = _cotangent(d + k, k, lam * d // g)
    got = _port_plain_grads(x, nf, w, g, dy)
    if x_dtype == "uint8":
        # The interpret kernel gets the frames the port dequantized; the
        # port's uint8 path is its path on those frames, bit for bit.
        x = dequantized(torch.from_numpy(x)).numpy()
        for name, a, b in zip(NAMES, got, _port_plain_grads(x, nf, w, g, dy)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    want = _jax_grads(x, nf, w, g, dy)
    for name, a, b, v in zip(NAMES, got, want, w):
        assert a.shape == b.shape == v.shape, name
        _close(a, b, name=name)


def test_plain_backward_float32_matches_jax_vjp():
    d, lam, g, k = serving_tests.SHAPES[3]
    x, nf, w = serving_tests._inputs(11, "uint8", d, lam, g, k)
    dy = _cotangent(12, k, lam * d // g)
    want = _jax_grads(x, nf, w, g, dy, jnp.float32)
    got = _port_plain_grads(x, nf, w, g, dy, torch.float32)
    for name, a, b in zip(NAMES, got, want):
        _close(a, b, rel=1e-5, name=name)


def test_function_gradients_and_the_empty_video():
    """The Function's gradients are the plain backward's; frames and
    num_frames get none; a video with num_frames = 0 (the clamp branch,
    dv = dy * 1e6) adds nothing; CPU tensors launch no kernel."""
    d, lam, g, k = serving_tests.SHAPES[0]
    x, nf, w = serving_tests._inputs(13, "uint8", d, lam, g, k)
    dy = _cotangent(14, k, lam * d // g)
    ws = [torch.from_numpy(v).requires_grad_() for v in w]
    frames = torch.from_numpy(x)
    before = (tnt.nextvlad_train_forward.launches,
              tnt.nextvlad_train_backward.launches)
    out = tnt.nextvlad_aggregate_train(frames, torch.from_numpy(nf), *ws, g)
    (out * torch.from_numpy(dy)).sum().backward()
    assert (tnt.nextvlad_train_forward.launches,
            tnt.nextvlad_train_backward.launches) == before
    want = _port_plain_grads(x, nf, w, g, dy)
    for name, v, b in zip(NAMES, ws, want):
        np.testing.assert_array_equal(v.grad.numpy(), b, err_msg=name)
    empty = _port_plain_grads(x[3:], nf[3:], w, g, dy[3:])
    for name, v in zip(NAMES, empty):
        assert np.all(v == 0), name
    jax_empty = _jax_grads(x[3:], nf[3:], w, g, dy[3:])
    for name, v in zip(NAMES, jax_empty):
        assert np.all(v == 0), name


# ---------------------------------------------------------------------------
# NeXtVladModel training
# ---------------------------------------------------------------------------

C, MB = serving_tests.VOCAB, 5
OPT = dict(base_learning_rate=0.01, learning_rate_decay=0.95,
           learning_rate_decay_examples=2 * MB, global_batch_size=MB,
           clip_gradient_norm=1.0)


def _train_batch(seed):
    feats, nf = serving_tests._batch(seed, MB)
    rng = np.random.default_rng(seed + 100)
    return {"features": feats, "num_frames": nf,
            "labels": (rng.uniform(size=(MB, C)) < 0.25).astype(np.float32),
            "batch_mask": np.array([1, 1, 1, 1, 0], np.float32)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if hasattr(v, "items"):
            out.update(_flat(v, name))
        else:
            out[name] = np.array(v, np.float64)
    return out


# hidden1_bn subtracts the batch mean of vlad_bn(v) @ W, to which
# vlad_bn's bias adds the same row for every video: its gradient is 0 in
# exact arithmetic, and both sides' moves are round-off.
VANISHING = "vlad_bn.bias"


@pytest.mark.parametrize("fused,compute_dtype", [
    (True, "bfloat16"), (True, "float32"), (False, "float32")])
def test_sgd_step_matches_jax(fused, compute_dtype, monkeypatch):
    monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    batch = _train_batch(21)
    kw = dict(compute_dtype=compute_dtype, nextvlad_train_fused=fused)
    variables = serving_tests._jax_variables(22)
    jmodel = jax_get_model("NeXtVladModel", serving_tests._hp(JaxHParams,
                                                              **kw))
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables["batch_stats"],
        tx=jax_make_optimizer(optimizer="SgdOptimizer", **OPT))
    jstep = jax_make_train_step(jmodel, jax_losses.get_loss(
        "CrossEntropyLoss"), donate=False)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jax.random.PRNGKey(2))
    model = get_model("NeXtVladModel", serving_tests._hp(ModelHParams, **kw))
    model.load_state_dict(state_dict_from_jax(variables))
    state = TrainState(model, optimizer="SgdOptimizer", **OPT)
    step = make_train_step(tlosses.get_loss("CrossEntropyLoss"))
    state, pm = step(state, {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=BF16)
    np.testing.assert_allclose(pm["predictions"].numpy(),
                               np.asarray(jm["predictions"]), atol=BF16)
    start = _flat(variables["params"])
    got = _flat(variables_from_model(state.model)["params"])
    want = _flat(jax.tree_util.tree_map(np.asarray, dict(jstate.params)))
    assert set(got) == set(want) == set(start)
    largest = max(np.max(np.abs(want[key] - start[key])) for key in want)
    for key in want:
        moved = want[key] - start[key]
        if key == VANISHING:
            for side in (got, want):
                assert np.max(np.abs(side[key] - start[key])) <= (
                    1e-3 * largest), key
            continue
        err = np.max(np.abs(got[key] - want[key]))
        assert err <= 2e-2 * np.max(np.abs(moved)) + 1e-12, (key, err)
    stats = _flat(variables_from_model(state.model)["batch_stats"])
    jstats = _flat(jax.tree_util.tree_map(np.asarray,
                                          dict(jstate.batch_stats)))
    for key in jstats:
        _close(stats[key], jstats[key], name=key)


def test_fused_and_plain_training_graphs_agree():
    batch = {k: torch.from_numpy(v) for k, v in _train_batch(23).items()}
    variables = serving_tests._jax_variables(24)
    out = {}
    for fused in (True, False):
        model = get_model("NeXtVladModel", serving_tests._hp(
            ModelHParams, nextvlad_train_fused=fused)).train()
        model.load_state_dict(state_dict_from_jax(variables))
        total, _, _, outputs = compute_loss(model, batch, tlosses.get_loss(
            "CrossEntropyLoss"))
        total.backward()
        out[fused] = (total.item(), outputs["predictions"].detach().numpy(), {
            n: p.grad.numpy() for n, p in model.named_parameters()})
    (fl, fp, fg), (pl, pp, pg) = out[True], out[False]
    np.testing.assert_allclose(fl, pl, rtol=BF16)
    np.testing.assert_allclose(fp, pp, atol=BF16)
    for name in ("expand_weights", "group_attention_weights",
                 "group_attention_bias", "cluster_weights",
                 "cluster_weights2"):
        err = np.max(np.abs(fg[name] - pg[name]))
        assert err <= 2e-2 * np.max(np.abs(pg[name])), (name, err)


def test_cli_train_eval_inference_on_the_cpu(tmp_path):
    """NeXtVladModel through cli.train (fused by default) -> cli.eval ->
    cli.inference with --device=cpu."""
    data = str(tmp_path / "data")
    for split, n, seed in (("train", 8, 1), ("validate", 6, 2)):
        write_dataset(data, split, num_shards=2, videos_per_shard=n,
                      frame_level=True, num_classes=C, seed=seed,
                      rgb_dim=12, audio_dim=4)
    run = str(tmp_path / "run")
    common = ["--frame_features", "--feature_names=rgb,audio",
              "--feature_sizes=12,4", f"--num_classes={C}",
              "--max_frames=20", "--device=cpu"]
    before = tnt.nextvlad_train_forward.launches
    assert train_cli.main([
        f"--train_data_pattern={data}/train-*.tfrecord",
        f"--train_dir={run}", "--batch_size=8", "--model=NeXtVladModel",
        "--nextvlad_groups=4", "--nextvlad_cluster_size=12",
        "--nextvlad_hidden_size=16", "--save_checkpoint_every_n_steps=2",
        "--max_steps=2", "--log_every_n_steps=1"] + common) == 2
    assert tnt.nextvlad_train_forward.launches == before  # CPU: plain
    out = eval_cli.main([f"--eval_data_pattern={data}/validate-*.tfrecord",
                         f"--train_dir={run}", "--batch_size=8",
                         "--device=cpu"])
    assert out["step"] == 2 and 0 <= out["gap"] <= 1
    assert out["nonfinite_predictions"] == 0
    csv = str(tmp_path / "out.csv")
    stats = inference_cli.main([
        f"--input_data_pattern={data}/validate-*.tfrecord",
        f"--train_dir={run}", f"--output_file={csv}", "--batch_size=8",
        "--top_k=5", "--device=cpu"])
    assert stats["num_videos"] == 12 and stats["nonfinite_predictions"] == 0
    with open(csv) as f:
        lines = f.read().splitlines()
    assert lines[0] == "VideoId,LabelConfidencePairs" and len(lines) == 13
