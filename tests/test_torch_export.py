"""The port's serving export (yt8m_tpu_torch/infer/export.py) against the
JAX package's (yt8m_tpu/infer/export.py), mirroring
tests/test_export_and_aux.py, and the custom operators' fake
implementations (yt8m_tpu_torch/kernels/ops.py).

The JAX model's initial variables go to the port through
`state_dict_from_jax`; both export and both serve the same inputs, made
from a seed with numpy. On the CPU the port's program runs its operators'
plain versions. Tolerances: the top-k values against JAX's program within
1e-5 (rtol 1e-5, atol 1e-6 for the dynamic batch, as the JAX test holds
its program to its model) at float32 compute, the indices equal; the
exported program against the eager port model exactly (the same
operators on the same inputs, with the frame draw of a generator seeded
0); the fakes' shapes and dtypes exactly.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.infer.export import export_model as jax_export_model
from yt8m_tpu.infer.export import load_serving as jax_load_serving
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.config import TrainConfig
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.infer.export import export_model, load_serving
from yt8m_tpu_torch.kernels import ops
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train.loop import Trainer

C, D = 18, 24
HP = dict(vocab_size=C, feature_dim=D, compute_dtype="float32")
FLAGSHIP = dict(vocab_size=C, feature_dim=D, max_frames=8,
                compute_dtype="float32", netvlad_cluster_size=4,
                netvlad_hidden_size=8, lstm_cells=6, lstm_layers=1,
                moe_num_mixtures=2)


def _jax_init(name, hp, feats, nf):
    model = jax_get_model(name, JaxHParams(**hp))
    variables = model.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(feats), jnp.asarray(nf), train=False)
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port_model(name, hp, variables):
    model = get_model(name, ModelHParams(**hp))
    model.load_state_dict(state_dict_from_jax(variables))
    return model.eval()


def _both(tmp_path, name, hp, feats, nf, batch_size, top_k):
    """Export the JAX model's variables from both packages: (port serve,
    port meta, JAX serve, the port model, the JAX variables)."""
    _, variables = _jax_init(name, hp, feats, nf)
    jdir = str(tmp_path / "jax")
    jax_export_model(jdir, name, JaxHParams(**hp), variables["params"],
                     batch_stats=variables.get("batch_stats"),
                     batch_size=batch_size, top_k=top_k)
    model = _port_model(name, hp, variables)
    pdir = export_model(str(tmp_path / "port"), name, ModelHParams(**hp),
                        model, batch_size=batch_size, top_k=top_k)
    serve, meta = load_serving(pdir, device="cpu")
    jserve, jmeta = jax_load_serving(jdir)
    for key in jmeta:
        if key != "hparams":
            assert meta[key] == jmeta[key], key
    assert meta["device"] == "cpu"
    return serve, meta, jserve, model


def _hold(got, want, rtol=0.0, atol=1e-5):
    values, indices = got
    np.testing.assert_allclose(values.numpy(), np.asarray(want[0]),
                               rtol=rtol, atol=atol)
    np.testing.assert_array_equal(indices.numpy(), np.asarray(want[1]))


def test_export_and_reload_serving(tmp_path):
    """test_export_and_aux.py:29: MoeModel locked at batch 4, top 5."""
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, D)).astype(np.float32)
    serve, meta, jserve, _ = _both(tmp_path, "MoeModel", HP, feats,
                                   np.ones(2, np.int32), 4, 5)
    assert meta["model"] == "MoeModel" and meta["top_k"] == 5
    x = np.random.default_rng(1).normal(size=(4, D)).astype(np.float32)
    nf = np.ones((4,), np.int32)
    values, indices = serve(x, nf)
    assert values.shape == indices.shape == (4, 5)
    assert indices.dtype == torch.int32
    assert torch.all(values[:, 1:] <= values[:, :-1])
    _hold((values, indices), jserve(x, nf))


def test_polymorphic_batch_export_serves_two_batch_sizes(tmp_path):
    """test_export_and_aux.py:228: MoeModel at a dynamic batch, served at
    B = 3 and 16 from one program."""
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(2, D)).astype(np.float32)
    serve, meta, jserve, model = _both(tmp_path, "MoeModel", HP, feats,
                                       np.ones(2, np.int32), 0, 5)
    assert meta["batch_size"] == 0
    for b in (3, 16):
        x = rng.normal(size=(b, D)).astype(np.float32)
        nf = np.ones((b,), np.int32)
        got = serve(x, nf)
        assert got[0].shape == (b, 5)
        _hold(got, jserve(x, nf), rtol=1e-5, atol=1e-6)
        with torch.no_grad():
            eager = model(torch.from_numpy(x), torch.from_numpy(nf))
        want = torch.topk(eager["predictions"], 5)
        assert torch.equal(got[0], want.values)


def test_flagship_netvlad_lstm_export_roundtrip(tmp_path):
    """test_export_and_aux.py:327: the flagship locked at batch 3, its
    batch statistics, NetVLAD and the recurrence in one program."""
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 256, size=(3, 8, D), dtype=np.uint8)
    nf = np.array([8, 3, 5], np.int32)
    serve, meta, jserve, _ = _both(tmp_path, "NetVladLstmModel", FLAGSHIP,
                                   feats.astype(np.float32), nf, 3, 4)
    assert meta["frame_level"] and meta["model"] == "NetVladLstmModel"
    got = serve(feats, nf)
    assert got[0].shape == (3, 4)
    _hold(got, jserve(feats, nf))


@pytest.mark.parametrize("name", ["FrameLevelLogisticModel",
                                  "GatedDbofModel"])
def test_polymorphic_frame_level_export(tmp_path, name):
    """test_export_and_aux.py:259 and :286: frame-level models (uint8
    features, frame sampling) at a dynamic batch on two batch sizes;
    JAX's program beside the port's for FrameLevelLogisticModel, which
    samples no frames (GatedDbofModel's draw is JAX's PRNGKey(0) there
    and a torch generator here). Two calls give the same output, that of
    the eager model with a generator seeded 0."""
    hp = {**HP, "max_frames": 8, "dbof_cluster_size": 16,
          "dbof_hidden_size": 8, "iterations": 5, "moe_num_mixtures": 2}
    rng = np.random.default_rng(3)
    feats = rng.integers(0, 256, size=(2, 8, D), dtype=np.uint8)
    serve, meta, jserve, model = _both(
        tmp_path, name, hp, feats.astype(np.float32),
        np.full((2,), 8, np.int32), 0, 4)
    assert meta["batch_size"] == 0 and meta["frame_level"]
    for b in (2, 7):
        x = rng.integers(0, 256, size=(b, 8, D), dtype=np.uint8)
        nf = rng.integers(1, 9, size=(b,)).astype(np.int32)
        got = serve(x, nf)
        assert got[0].shape == (b, 4)
        again = serve(x, nf)
        assert torch.equal(got[0], again[0])
        assert torch.equal(got[1], again[1])
        with torch.no_grad():
            eager = model(torch.from_numpy(x), torch.from_numpy(nf),
                          generator=torch.Generator().manual_seed(0))
        want = torch.topk(eager["predictions"], 4)
        assert torch.equal(got[0], want.values)
        assert torch.equal(got[1], want.indices.to(torch.int32))
        if name == "FrameLevelLogisticModel":
            _hold(got, jserve(x, nf), rtol=1e-5, atol=1e-6)


def test_export_refuses_an_unseeded_frame_draw(tmp_path):
    """Under torch.export a sampler without a seed raises, so no program
    bakes a draw that changes from call to call."""
    from yt8m_tpu_torch.models import frame_utils

    x = torch.zeros(2, 8, D, dtype=torch.uint8)

    class Unseeded(torch.nn.Module):
        def forward(self, features, num_frames):
            return frame_utils.sample_random_frames(features, num_frames, 3)

    with pytest.raises(ValueError, match="needs a seed"):
        torch.export.export(Unseeded(), (x, torch.ones(2,
                                                       dtype=torch.int32)))
    seeded = frame_utils.sample_random_frames(
        x, torch.full((2,), 8), 3, generator=0)
    want = frame_utils.sample_random_frames(
        x, torch.full((2,), 8), 3, generator=torch.Generator().manual_seed(0))
    assert torch.equal(seeded, want)


def test_export_carries_the_weights_it_was_given(tmp_path):
    """Serving constants are made from the weights at each export: after
    the weights change (and the serving constants are dropped, as the
    optimizer step does), a second export serves the new weights."""
    rng = np.random.default_rng(4)
    hp = {**HP, "compute_dtype": "bfloat16"}
    model = get_model("MoeModel", ModelHParams(**hp))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    x = torch.from_numpy(rng.normal(size=(3, D)).astype(np.float32))
    nf = torch.ones(3, dtype=torch.int32)
    with torch.no_grad():
        before = model(x, nf)["predictions"]
    first = export_model(str(tmp_path / "a"), "MoeModel", ModelHParams(**hp),
                         model, top_k=5)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(0.5)
    model.invalidate_serving()
    second = export_model(str(tmp_path / "b"), "MoeModel",
                          ModelHParams(**hp), model, top_k=5)
    with torch.no_grad():
        after = model(x, nf)["predictions"]
    assert not torch.equal(before, after)
    for path, want in ((first, before), (second, after)):
        serve, _ = load_serving(path, device="cpu")
        assert torch.equal(serve(x, nf)[0], torch.topk(want, 5).values)


def _train(tmp_path, data, run, **kw):
    cfg = dict(train_data_pattern=os.path.join(data, "train-*.tfrecord"),
               feature_names="mean_rgb,mean_audio",
               feature_sizes=f"{D - 4},4", num_classes=C, batch_size=8,
               num_epochs=20, max_steps=10, model="MoeModel",
               train_dir=str(tmp_path / run),
               save_checkpoint_every_n_steps=10, log_every_n_steps=100,
               hparams=ModelHParams(**HP), device="cpu")
    cfg.update(kw)
    Trainer(TrainConfig(**cfg)).run()
    return str(tmp_path / run)


@pytest.fixture(scope="module")
def video_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("export_data")
    write_dataset(str(root), "train", num_shards=1, videos_per_shard=16,
                  frame_level=False, num_classes=C, seed=5, rgb_dim=D - 4,
                  audio_dim=4)
    return str(root)


def test_trainer_periodic_export(tmp_path, video_data):
    """test_export_and_aux.py:95: --export_model_steps writes serving
    programs during training; the one of the last step serves what the
    last checkpoint serves."""
    from yt8m_tpu_torch.convert import load_model

    run = _train(tmp_path, video_data, "run", export_model_steps=5)
    for step in (5, 10):
        assert os.path.isdir(os.path.join(run, "export", f"step_{step}"))
    serve, meta = load_serving(os.path.join(run, "export", "step_10"),
                               device="cpu")
    assert meta["model"] == "MoeModel" and meta["ema"] is False
    x = np.random.default_rng(0).normal(size=(8, D)).astype(np.float32)
    nf = np.ones((8,), np.int32)
    values, _ = serve(x, nf)
    assert values.shape == (8, min(20, C))
    model = load_model(run, "MoeModel", ModelHParams(**HP), "cpu")
    with torch.no_grad():
        want = model(torch.from_numpy(x), torch.from_numpy(nf))
    assert torch.equal(values, torch.topk(want["predictions"], C).values)


def test_ema_export_roundtrip(tmp_path, video_data, caplog):
    """test_export_and_aux.py:138: --use_ema_weights exports the Polyak
    average (meta ema true, the full hparams); the raw run's program
    serves other outputs, and that run warns once that it exports raw
    weights."""
    runs = {}
    for use_ema in (True, False):
        with caplog.at_level("WARNING"):
            run = _train(tmp_path, video_data, f"run_{use_ema}",
                         export_model_steps=5, ema_decay=0.9,
                         use_ema_weights=use_ema)
        runs[use_ema] = load_serving(os.path.join(run, "export", "step_10"),
                                     device="cpu")
    assert sum("exports RAW weights" in r.getMessage()
               for r in caplog.records) == 1
    (serve_ema, meta_ema), (serve_raw, meta_raw) = runs[True], runs[False]
    assert meta_ema["ema"] is True and meta_raw["ema"] is False
    assert meta_ema["hparams"]["vocab_size"] == C
    x = np.random.default_rng(0).normal(size=(8, D)).astype(np.float32)
    nf = np.ones((8,), np.int32)
    assert not np.allclose(serve_ema(x, nf)[0].numpy(),
                           serve_raw(x, nf)[0].numpy(), atol=1e-6)


def test_trainer_export_failure_does_not_stop_training(tmp_path, video_data,
                                                       monkeypatch, caplog):
    import yt8m_tpu_torch.infer.export as export_lib

    def broken(*args, **kwargs):
        raise RuntimeError("no room")

    monkeypatch.setattr(export_lib, "export_model", broken)
    with caplog.at_level("ERROR"):
        run = _train(tmp_path, video_data, "run", export_model_steps=5)
    assert "serving export failed at step 5" in caplog.text
    assert os.path.exists(os.path.join(run, "10", "step.json"))


# ---------------------------------------------------------------------------
# The operators' fake implementations under a symbolic batch.
# ---------------------------------------------------------------------------


def _op_cases():
    """(name, call(b) -> the op's arguments at batch b) for every serving
    operator, small shapes, CPU tensors."""
    from yt8m_tpu_torch.kernels.dbof import int8_serving_constants
    from yt8m_tpu_torch.kernels.nextvlad import kernel_layout
    from yt8m_tpu_torch.kernels.tf32 import split_weights

    gen = torch.Generator().manual_seed(0)

    def rn(*shape):
        return torch.randn(*shape, generator=gen)

    def frames(b, f=6, d=16):
        return torch.randint(0, 256, (b, f, d), generator=gen,
                             dtype=torch.uint8)

    def nf(b, f=6):
        return torch.randint(0, f + 1, (b,), generator=gen,
                             dtype=torch.int32)

    w8 = int8_serving_constants(rn(16, 12), rn(16).abs(), rn(16),
                                rn(12).abs(), rn(12))
    nxw = [rn(16, 32) * 0.2, rn(32, 4) * 0.2, rn(4), rn(32, 4 * 12) * 0.2,
           rn(12, 8)]
    lay = kernel_layout(*nxw, 4)
    # The f32 routes' split copies (kernels/tf32.py), serving constants.
    w, wg, we = rn(16, 12), rn(10, 7 * 3), rn(10, 7 * 2)
    w_split = [split_weights(w)]
    moe_split = [split_weights(wg), split_weights(we)]
    wc = rn(16, 5)
    wc_split = [split_weights(wc)]
    return [
        ("dbof_maxpool", lambda b: (frames(b), rn(16, 12), rn(16), rn(16),
                                    rn(12), rn(12), [])),
        ("dbof_maxpool:f32", lambda b: (frames(b), w, rn(16), rn(16),
                                        rn(12), rn(12), w_split)),
        ("dbof_maxpool_int8", lambda b: (frames(b), *w8)),
        ("moe_head", lambda b: (rn(b, 10), rn(10, 7 * 3), rn(10, 7 * 2),
                                rn(14), 2, [])),
        ("moe_head:f32", lambda b: (rn(b, 10), wg, we, rn(14), 2,
                                    moe_split)),
        ("topk", lambda b: (rn(b, 30), 5)),
        ("netvlad", lambda b: (frames(b), nf(b), rn(16, 5), rn(5), rn(5),
                               rn(5, 16), [])),
        ("netvlad:f32", lambda b: (frames(b), nf(b), wc, rn(5), rn(5),
                                   rn(5, 16), wc_split)),
        ("lstm", lambda b: (rn(6, b, 4 * 8), nf(b), rn(8, 32), rn(32),
                            True)),
        ("gru", lambda b: (rn(6, b, 16), rn(6, b, 8), nf(b), rn(8, 16),
                           rn(8, 8), rn(16), rn(8), False)),
        ("attention_pool", lambda b: (frames(b), nf(b), rn(16, 2))),
        ("nextvlad", lambda b: (frames(b), nf(b), *nxw, 4, torch.bfloat16,
                                [lay["we"], lay["wc"], lay["wa"]])),
        ("frame_uniform", lambda b: (frames(b), 7, 0)),
    ]


@pytest.mark.parametrize("name,make", _op_cases(),
                         ids=[c[0] for c in _op_cases()])
def test_op_fake_gives_the_plain_shapes_under_a_symbolic_batch(name, make):
    """Each operator exported alone with a dynamic batch: the fake's
    outputs carry the symbolic batch and the shapes and dtypes of the real
    (plain) outputs; the program then serves batch 5 as the operator
    does, bit for bit."""
    op = ops.SERVING_OPS[name.split(":")[0]]
    args3 = make(3)
    batch_axes = [next((i for i, n in enumerate(a.shape) if n == 3), None)
                  if isinstance(a, torch.Tensor) else None for a in args3]
    tensor_at = [i for i, a in enumerate(args3)
                 if isinstance(a, torch.Tensor) and batch_axes[i] is not None]

    class One(torch.nn.Module):
        def forward(self, *xs):
            full = list(args3)
            for i, x in zip(tensor_at, xs):
                full[i] = x
            return op(*full)

    batch = torch.export.Dim("batch", min=2)
    dyn = tuple({batch_axes[i]: batch} for i in tensor_at)
    args5 = make(5)
    prog = torch.export.export(One(), tuple(args3[i] for i in tensor_at),
                               dynamic_shapes=(dyn,))
    outs = [n for n in prog.graph.nodes if n.op == "output"][0].args[0]
    fakes = [o.meta["val"] for o in outs]
    real = op(*args5)
    real = real if isinstance(real, tuple) else (real,)
    assert len(fakes) == len(real)
    for fake, got in zip(fakes, real):
        assert fake.dtype == got.dtype
        assert len(fake.shape) == got.dim()
        sym = [isinstance(s, torch.SymInt) for s in fake.shape]
        assert any(sym), (name, fake.shape)
        for s, n, is_sym in zip(fake.shape, got.shape, sym):
            if not is_sym:
                assert s == n
    # The constants other than the batched tensors are those of args3;
    # rebuild the call at batch 5 with them.
    full5 = list(args3)
    for i in tensor_at:
        full5[i] = args5[i]
    want = op(*full5)
    got = prog.module()(*(args5[i] for i in tensor_at))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for a, c in zip(got, want):
        assert torch.equal(a, c)
