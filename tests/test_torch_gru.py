"""The port's GRU recurrence (yt8m_tpu_torch/kernels/gru.py), its stacked
GRU (models/rnn.py) and GruModel / BiGruModel against the JAX package.

On the CPU the recurrence wrapper runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, or its lax.scan oracle.
The same inputs, made with numpy from a seed, go to both. Tolerances:
  * recurrence: max|diff| <= 1e-5 * max|ref| + 1e-6 (the JAX package's
    own bound for its kernel is 2e-2). Both sides round h, r * h, W_hg,
    W_hc, xg and xc to bf16 at the same points; only the f32 summation
    order and the transcendental functions' last bits differ.
  * the live-row schedule of the persistent CUDA kernel: the plain
    version run on the rows sorted by num_frames (whole, or one step's
    live prefix at a time, as the kernel runs it) and put back in the
    caller's order meets the recurrence's 1e-5 bound against the JAX
    reference on the original rows (the schedule itself is held to a
    numpy count in tests/test_torch_lstm.py).
  * stacked GRU and the models at float32 (the scan graph on both
    sides): 1e-5.
  * stacked GRU and the models at bf16 (the recurrence on both sides,
    JAX through its kernel with YT8M_PALLAS_INTERPRET=1): 3e-3. The input
    projections are bf16 products on both sides, summed in another
    order; a last-bit difference before a bf16 rounding moves that
    operand by one bf16 step (docs/KERNELS.md, "bf16 divergence vs
    XLA").
  * a JAX-recorded GruModel run served through the port's inference CLI
    (float32): the CSV's values within 1e-5 relative of the JAX model's
    probabilities.
"""

import dataclasses
import json

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.gru import (
    gru_recurrence as jax_gru,
    gru_recurrence_reference,
)
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.models import rnn as jrnn
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.kernels import gru as tgru
from yt8m_tpu_torch.kernels._schedule import live_schedule
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.models import rnn as trnn

F, B, H, D, C = 13, 5, 16, 32, 20
NUM_FRAMES = np.array([13, 1, 0, 7, 12], np.int32)


def _close(got, want, rel=1e-5, abs_=1e-6):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want))
    assert err <= rel * np.max(np.abs(want)) + abs_, err


def _recurrence_inputs(seed, h=H):
    rng = np.random.default_rng(seed)
    xg = rng.normal(0, 0.5, size=(F, B, 2 * h)).astype(np.float32)
    xc = rng.normal(0, 0.5, size=(F, B, h)).astype(np.float32)
    whg = rng.normal(0, 0.3, size=(h, 2 * h)).astype(np.float32)
    whc = rng.normal(0, 0.3, size=(h, h)).astype(np.float32)
    bg = rng.normal(1.0, 0.1, size=(2 * h,)).astype(np.float32)
    bc = rng.normal(0, 0.1, size=(h,)).astype(np.float32)
    return xg, xc, NUM_FRAMES, whg, whc, bg, bc


def _port_recurrence(args, reverse):
    outs, h = tgru.gru_recurrence(*map(torch.from_numpy, args),
                                  reverse=reverse)
    return outs.numpy(), h.numpy()


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "lax_scan"])
def test_gru_plain_matches_jax(oracle, reverse):
    args = _recurrence_inputs(1 + reverse)
    jargs = tuple(map(jnp.asarray, args))
    if oracle == "pallas_interpret":
        w_outs, w_h = jax_gru(*jargs, reverse=reverse, interpret=True)
    else:
        w_outs, w_h = gru_recurrence_reference(*jargs, reverse=reverse)
    outs, h = _port_recurrence(args, reverse)
    assert outs.shape == (F, B, H) and outs.dtype == np.float32
    _close(outs, np.asarray(w_outs))
    _close(h, np.asarray(w_h))
    # num_frames 0: the carry never moves; F: every step moves it.
    assert np.all(outs[:, 2] == 0) and np.all(h[2] == 0)
    assert np.all(outs[:, 0] != 0)
    # outputs are bf16 values widened to f32
    assert np.array_equal(outs, torch.from_numpy(outs).bfloat16().float()
                          .numpy())


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_gru_frozen_carry_ignores_steps_past_num_frames(reverse):
    xg, xc, nf, whg, whc, bg, bc = _recurrence_inputs(3)
    clean_g, loud_g, clean_c, loud_c = xg.copy(), xg.copy(), xc.copy(), xc.copy()
    for i, n in enumerate(nf):
        t = slice(0, F - n) if reverse else slice(n, F)  # flipped when reversed
        clean_g[t, i], clean_c[t, i] = 0.0, 0.0
        loud_g[t, i] = np.where(np.arange(2 * H) % 2 == 0, 1e4, -1e4)
        loud_c[t, i] = np.where(np.arange(H) % 2 == 0, -1e4, 1e4)
    a = _port_recurrence((clean_g, clean_c, nf, whg, whc, bg, bc), reverse)
    b = _port_recurrence((loud_g, loud_c, nf, whg, whc, bg, bc), reverse)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_gru_padded_units_stay_zero_and_change_nothing():
    """The card pads H to a multiple of 64 with units whose weights, xg,
    xc and biases are zero: u = 0.5, r * h = 0 and c = 0 keep such a
    unit's h exactly at 0, and the real units' outputs are those
    unpadded (to the f32 summation order: the products' depth differs)."""
    h, hp = 24, 64
    args = tuple(map(torch.from_numpy, _recurrence_inputs(5, h)))
    xg, xc, nf, whg, whc, bg, bc = args
    outs, fh = tgru.gru_recurrence(*args)
    padded = tgru.pad_units(hp, xg, xc, whg, whc, bg, bc)
    outs2, fh2 = tgru.gru_recurrence(*padded[:2], nf, *padded[2:])
    assert padded[0].shape == (F, B, 2 * hp) and padded[3].shape == (hp, hp)
    _close(outs2[..., :h], outs)
    _close(fh2[:, :h], fh)
    assert torch.all(outs2[..., h:] == 0) and torch.all(fh2[:, h:] == 0)


def _gru_live_prefix(xg, xc, nf, whg, whc, bg, bc, reverse):
    """The plain cell as the kernel runs it on rows in schedule order:
    both products of step t for the first live[t] rows only (the others
    keep their carry). Inputs and outputs in schedule order."""
    f, b, g2 = xg.shape
    hd = g2 // 2
    _, live = live_schedule(nf, f, reverse)
    bf = tgru._bf
    wg, wc, xgs, xcs = bf(whg), bf(whc), bf(xg), bf(xc)
    h = torch.zeros((b, hd))
    outs = []
    for t in range(f):
        n = int(live[t])
        hn = h[:n]
        r, u = tgru.gru_gates(torch.matmul(bf(hn), wg) + xgs[t, :n] + bg, hd)
        c = torch.tanh(torch.matmul(bf(r * hn), wc) + xcs[t, :n] + bc)
        h[:n] = u * hn + (1.0 - u) * c
        outs.append(h.to(torch.bfloat16))
    return torch.stack(outs).to(torch.float32), h


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("run", ["plain", "live_prefix"])
def test_gru_in_schedule_order_matches_jax(run, reverse):
    args = _recurrence_inputs(7 + reverse)
    xg, xc, nf, *weights = map(torch.from_numpy, args)
    order, _ = live_schedule(nf, F, reverse)
    o = order.long()
    fn = tgru.gru_recurrence_plain if run == "plain" else _gru_live_prefix
    s_outs, s_h = fn(xg[:, o], xc[:, o], nf[o], *weights, reverse)
    outs, h = torch.empty_like(s_outs), torch.empty_like(s_h)
    outs[:, o], h[o] = s_outs, s_h  # back to the caller's order
    w_outs, w_h = gru_recurrence_reference(*map(jnp.asarray, args),
                                           reverse=reverse)
    _close(outs.numpy(), np.asarray(w_outs))
    _close(h.numpy(), np.asarray(w_h))


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_gru_live_prefix_out_of_range_num_frames_matches_jax(reverse):
    """num_frames past either end (a row at or below 0 dead at every step,
    one past F live at every step) in the schedule's order."""
    nf = np.array([-2, F + 4, 0, -7, 5], np.int32)
    xg, xc, _, *weights = _recurrence_inputs(11 + reverse)
    args = (xg, xc, nf, *weights)
    t = list(map(torch.from_numpy, args))
    order, _ = live_schedule(t[2], F, reverse)
    o = order.long()
    s_outs, s_h = _gru_live_prefix(t[0][:, o], t[1][:, o], t[2][o], *t[3:],
                                   reverse)
    outs, h = torch.empty_like(s_outs), torch.empty_like(s_h)
    outs[:, o], h[o] = s_outs, s_h
    w_outs, w_h = gru_recurrence_reference(*map(jnp.asarray, args),
                                           reverse=reverse)
    _close(outs.numpy(), np.asarray(w_outs))
    _close(h.numpy(), np.asarray(w_h))
    dead = nf <= 0
    assert np.all(outs.numpy()[:, dead] == 0) and np.all(h.numpy()[dead] == 0)


class _JaxStack(fnn.Module):
    """The JAX package's _run_rnn over its _GruLayer, as a module."""

    layers: int
    dtype: object
    bidirectional: bool
    pooling: str
    residual: bool

    @fnn.compact
    def __call__(self, features, num_frames):
        return jrnn._run_rnn(
            jrnn._GruLayer, features, num_frames, layers=self.layers,
            hidden=H, dtype=self.dtype, bidirectional=self.bidirectional,
            pooling=self.pooling, residual=self.residual)


class _PortStack(torch.nn.Module):
    def __init__(self, layers, dtype, bidirectional):
        super().__init__()
        self.width = trnn.add_gru_stack(self, D, H, layers, dtype,
                                        bidirectional)


STACKS = {
    "last": (2, False, "last", False),
    "bi_last_residual": (2, True, "last", True),
    "bi_max": (2, True, "max", False),
    "mean_residual": (3, False, "mean", True),
}


def _set_interpret(dtype, monkeypatch):
    if dtype == "bfloat16":
        monkeypatch.setenv("YT8M_PALLAS_INTERPRET", "1")
    else:
        monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stack", sorted(STACKS))
def test_run_rnn_gru_matches_jax(stack, dtype, monkeypatch):
    layers, bi, pooling, residual = STACKS[stack]
    _set_interpret(dtype, monkeypatch)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(B, F, D)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jmod = _JaxStack(layers, jdt, bi, pooling, residual)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                          jnp.asarray(NUM_FRAMES))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.05, a.shape).astype(np.float32)
        if a.ndim == 1 else a, variables)  # perturbed biases
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


def _hparams(cls, **kw):
    base = dict(vocab_size=C, feature_dim=D, max_frames=F, gru_cells=H,
                gru_layers=2)
    base.update(kw)
    return cls(**base)


def _jax_variables(jmodel, feats, num_frames):
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(feats), jnp.asarray(num_frames), train=False)
    rng = np.random.default_rng(2)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.1, a.shape)).astype(
            np.float32) if a.ndim == 1 else np.asarray(a), variables)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["GruModel", "BiGruModel"])
def test_gru_models_forward_match_jax(name, dtype, monkeypatch):
    _set_interpret(dtype, monkeypatch)
    rng = np.random.default_rng(6)
    feats = rng.integers(0, 256, size=(B, F, D), dtype=np.uint8)
    jmodel = jax_get_model(name, _hparams(JaxHParams, compute_dtype=dtype))
    variables = _jax_variables(jmodel, feats, NUM_FRAMES)
    want = jmodel.apply(variables, jnp.asarray(feats),
                        jnp.asarray(NUM_FRAMES), train=False)
    model = get_model(name, _hparams(ModelHParams, compute_dtype=dtype))
    model.load_state_dict(state_dict_from_jax(variables))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(feats),
                           torch.from_numpy(NUM_FRAMES))["predictions"]
    assert got.shape == (B, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want["predictions"]),
                               rtol=0,
                               atol=1e-5 if dtype == "float32" else 3e-3)


def test_gru_state_dict_keeps_jax_names_and_shapes():
    feats = np.zeros((2, F, D), np.uint8)
    jmodel = jax_get_model("BiGruModel", _hparams(JaxHParams))
    variables = _jax_variables(jmodel, feats, NUM_FRAMES[:2])
    want = {k: v.shape for k, v in state_dict_from_jax(variables).items()}
    model = get_model("BiGruModel", _hparams(ModelHParams))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    assert torch.all(model.fw_layer0.gate_bias == 1.0)
    assert torch.all(model.bw_layer1.candidate_bias == 0.0)


def test_cli_serves_a_jax_recorded_gru_run(tmp_path, monkeypatch):
    """A run directory as the JAX trainer records it (its
    model_flags.json) with the converted weights: the port's inference
    CLI on the CPU writes the top-k of the JAX GruModel's probabilities."""
    from yt8m_tpu_torch.cli import inference as cli
    from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
    from yt8m_tpu_torch.data.synthetic import write_dataset

    monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    data = str(tmp_path / "data")
    write_dataset(data, "test", num_shards=2, videos_per_shard=4,
                  frame_level=True, num_classes=C, seed=2, rgb_dim=24,
                  audio_dim=8, max_frames=20)
    recorded = dict(frame_features=True, feature_names="rgb,audio",
                    feature_sizes="24,8", num_classes=C, max_frames=20)
    jhp = _hparams(JaxHParams, compute_dtype="float32", max_frames=20)
    jmodel = jax_get_model("GruModel", jhp)
    rc = ReaderConfig("rgb,audio", "24,8", frame_features=True,
                      num_classes=C, max_frames=20)
    (batch,) = list(BatchIterator(f"{data}/test-*.tfrecord", rc,
                                  batch_size=8))
    variables = _jax_variables(jmodel, batch["features"],
                               batch["num_frames"])
    want = np.asarray(jmodel.apply(
        variables, jnp.asarray(batch["features"]),
        jnp.asarray(batch["num_frames"]), train=False)["predictions"])
    run = tmp_path / "run"
    run.mkdir()
    (run / "model_flags.json").write_text(json.dumps(
        {"model": "GruModel", **recorded,
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
    assert sorted(vid for vid, _ in rows) == sorted(ids)
    for vid, pairs in rows:
        p = want[ids.index(vid)]
        toks = pairs.split()
        classes = [int(t) for t in toks[0::2]]
        values = np.array([float(t) for t in toks[1::2]])
        np.testing.assert_allclose(values, -np.sort(-p)[:5], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(p[classes], values, rtol=1e-5, atol=1e-6)
