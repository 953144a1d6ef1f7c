"""The port's tensor-parallel training (--model_parallel: parallel/mesh.py's
policy, parallel/tensor.py's column products, train/state.py ::
ParallelTrainState on a (data, model) grid) against the JAX package's
GSPMD step (train/step.py :: make_train_step on a mesh of
make_mesh(n, model_parallel=mp), the parameters placed by
tree_param_shardings as tests/test_sharding.py :: _run_steps places
them), which is the one-device step at the global batch.

  (a) The port's specs are yt8m_tpu/parallel/mesh.py :: param_spec's, for
      every model of the zoo (each has a shardable head), at mp = 2 and
      4, with and without --fsdp_min_size, at 24 classes and at 6 (with
      M = 2 and mp = 4 the experts split into blocks of 3 columns, a
      class's two experts across a block edge, and the gates, 18 columns,
      stay whole). No spawn.
  (b) The TP step on gloo ranks at (data, model) = (1, 2), (2, 2) and
      (1, 4) (the misaligned split at 6 classes), one spawn a grid with
      every case inside, from the JAX model's initial variables on the
      same global batches: MoeModel, LogisticModel, ChainMoeModel,
      DbofModel and SoftDbofModel (frame sampling fed the same global
      uniforms on both sides), NetVladLstmModel (the port's trainable
      LSTM, which runs its plain version here; the JAX package's scan
      graph, as its Trainer runs TP), three SGD steps and a case each of
      Adam and Adafactor (factored on the whole variable's shape), the
      gradient clip on, EMA on some. Losses, parameters, BatchNorm
      statistics and the EMA within rtol 2e-4, atol 1e-5
      (tests/test_manual_train.py's trajectory tolerance: float32 sums in
      another order, and at two data blocks the cross-replica moments).
      Each rank holds only its blocks of the sharded variables: the
      parameter, its gradient, its optimizer state and its EMA.
  (c) Checkpoints: a TP run writes the one-card format; a one-card state
      restores it and writes it again bit for bit, and a TP state
      restores a one-card checkpoint and writes it again bit for bit.
  (d) cli.train --device=cpu --num_devices=2 --model_parallel=2 (the
      first rank of the model group reads and broadcasts the batches, the
      frame sampling draws the global batch's uniforms) logs the
      one-rank run's losses and ends at its checkpoint; its
      --export_model_steps program serves; cli.eval and cli.inference
      serve its directory.

Every spawned group has a hard deadline that fails the test.
"""

import functools
import json
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yt8m_tpu.models.frame as jax_frame
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.parallel import mesh as jax_mesh
from yt8m_tpu.train import losses as jax_losses
from yt8m_tpu.train.state import init_train_state, make_optimizer
from yt8m_tpu.train.step import make_train_step as jax_make_train_step
from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as inference_cli
from yt8m_tpu_torch.cli import train as train_cli
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.infer.export import load_serving
from yt8m_tpu_torch.models import (
    ModelHParams,
    get_model,
    is_frame_level_model,
    list_models,
)
from yt8m_tpu_torch.parallel.distributed import launch
from yt8m_tpu_torch.parallel.mesh import TP_SHARDABLE, param_specs
from yt8m_tpu_torch.parallel.replay import replay_all
from yt8m_tpu_torch.train import losses as tlosses
from yt8m_tpu_torch.train.checkpoint import CheckpointManager
from yt8m_tpu_torch.train.state import TrainState
from yt8m_tpu_torch.train.step import make_train_step

C, D, F, B = 24, 16, 10, 16
N_STEPS = 3
LR = 0.05
RTOL, ATOL = 2e-4, 1e-5
DEADLINE_S = 240.0

MOE = dict(moe_num_mixtures=2)
DBOF = dict(dbof_cluster_size=16, dbof_hidden_size=8, iterations=4,
            sample_random_frames=True, moe_num_mixtures=2)
# name -> (model, shared hparams, the port's kernel flags, the JAX
# package's, options: video, c and d (widths), optimizer, ema_decay)
CASES = {
    "moe": ("MoeModel", MOE, {}, {}, dict(video=True, ema_decay=0.9)),
    "logistic": ("LogisticModel", {}, {}, {}, dict(video=True)),
    "chain": ("ChainMoeModel", dict(MOE, chain_stages=2,
                                    chain_hidden_size=8), {}, {},
              dict(video=True)),
    "dbof": ("DbofModel", DBOF, {}, {}, dict(ema_decay=0.9)),
    "soft_dbof": ("SoftDbofModel", DBOF, {}, {}, {}),
    "flagship": ("NetVladLstmModel", dict(MOE, netvlad_cluster_size=8,
                                          netvlad_hidden_size=16,
                                          lstm_cells=16, lstm_layers=2),
                 dict(lstm_use_pallas=True), dict(lstm_use_pallas=False),
                 {}),
    "adam": ("MoeModel", MOE, {}, {},
             dict(video=True, optimizer="AdamOptimizer", ema_decay=0.9)),
    # gates [128, 256] and experts [128, 128] factor whole; their blocks
    # at mp = 2 and 4 would not all factor on their own shapes.
    "adafactor": ("MoeModel", dict(moe_num_mixtures=1), {}, {},
                  dict(video=True, optimizer="AdafactorOptimizer", c=128,
                       d=128)),
    "moe_misaligned": ("MoeModel", MOE, {}, {}, dict(video=True, c=6)),
    "chain_misaligned": ("ChainMoeModel", dict(MOE, chain_stages=2,
                                               chain_hidden_size=8), {}, {},
                         dict(video=True, c=6, ema_decay=0.9)),
    "dbof_misaligned": ("DbofModel", DBOF, {}, {}, dict(c=6)),
}
GRIDS = {
    (1, 2): ["moe", "logistic", "chain", "dbof", "soft_dbof", "flagship",
             "adam", "adafactor"],
    (2, 2): ["moe", "chain", "dbof", "flagship", "adafactor"],
    (1, 4): ["moe_misaligned", "chain_misaligned", "dbof_misaligned"],
}


def _batches(video, c, d):
    out = []
    for i in range(N_STEPS):
        rng = np.random.default_rng(100 + i)
        mask = np.ones((B,), np.float32)
        mask[-3:] = 0.0
        out.append({
            "features": (rng.normal(size=(B, d)).astype(np.float32) if video
                         else rng.integers(0, 256, size=(B, F, d),
                                           dtype=np.uint8)),
            "labels": (rng.random((B, c)) < 0.15).astype(np.float32),
            "num_frames": (np.ones((B,), np.int32) if video else
                           rng.integers(1, F + 1, size=(B,)).astype(np.int32)),
            "batch_mask": mask,
        })
    return out


@functools.lru_cache(maxsize=None)
def _case(name):
    model, shared, port_kw, jax_kw, opts = CASES[name]
    c, d = opts.get("c", C), opts.get("d", D)
    base = dict(vocab_size=c, feature_dim=d, max_frames=F,
                compute_dtype="float32", **shared)
    video = opts.get("video", False)
    uniforms = None
    if "iterations" in shared:
        rng = np.random.default_rng(7)
        uniforms = [rng.uniform(size=(B, shared["iterations"])).astype(
            np.float32) for _ in range(N_STEPS)]
    return model, base, port_kw, jax_kw, opts, _batches(video, c, d), uniforms


def _jax_optimizer(opts):
    return make_optimizer(optimizer=opts.get("optimizer", "SgdOptimizer"),
                          global_batch_size=B, base_learning_rate=LR,
                          clip_gradient_norm=1.0)


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX package's initial state of a case on the host."""
    model, base, _, jax_kw, opts, batches, _ = _case(name)
    hp = JaxHParams(**base, **jax_kw)
    return jax.device_get(init_train_state(
        jax_get_model(model, hp), jax.random.PRNGKey(0), batches[0],
        _jax_optimizer(opts), frame_level=not opts.get("video", False),
        ema=opts.get("ema_decay", 0.0) > 0)), hp


def _weights(name):
    state, _ = _jax_init(name)
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    return {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}


def _spec(name, mp, **extra):
    model, base, port_kw, _, opts, batches, uniforms = _case(name)
    spec = dict(model=model, hparams=dict(base, **port_kw),
                weights=_weights(name), batches=batches, uniforms=uniforms,
                optimizer=opts.get("optimizer", "SgdOptimizer"),
                model_parallel=mp, ema_decay=opts.get("ema_decay", 0.0),
                device="cpu",
                train=dict(base_learning_rate=LR, global_batch_size=B,
                           clip_gradient_norm=1.0))
    spec.update(extra)
    return spec


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


def _fixed_sampler(u):
    """The JAX sampler with the uniforms `u` in place of its draw (the
    index rule of yt8m_tpu/models/frame_utils.py)."""
    def sample(rng, model_input, num_frames, num_samples):
        nf = jnp.maximum(num_frames, 1).astype(jnp.float32)
        idx = jnp.floor(jnp.asarray(u) * nf[:, None]).astype(jnp.int32)
        return jnp.take_along_axis(model_input, idx[:, :, None], axis=1)
    return sample


def _jax_run(name, data, model_parallel):
    """The GSPMD step's trajectory on make_mesh(data * model_parallel,
    model_parallel): losses, the final variables and EMA (flat, the port's
    names), and the names the policy shards over "model"."""
    model, _, _, _, opts, batches, uniforms = _case(name)
    state, hp = _jax_init(name)
    mesh = jax_mesh.make_mesh(data * model_parallel, model_parallel)
    param_sh = jax_mesh.tree_param_shardings(state.params, mesh)
    shardings = jax.tree_util.tree_map(lambda _: jax_mesh.replicated(mesh),
                                       state).replace(params=param_sh)
    if state.ema_params is not None:
        shardings = shardings.replace(ema_params=param_sh)
    state = jax.device_put(state, shardings)
    jmodel = jax_get_model(model, hp)
    loss = jax_losses.get_loss("CrossEntropyLoss")
    losses = []
    with pytest.MonkeyPatch.context() as patch:
        for i, b in enumerate(batches):
            if uniforms is not None:
                patch.setattr(jax_frame, "sample_random_frames",
                              _fixed_sampler(uniforms[i]))
            # a new jit a step: the patched sampler's uniforms are traced in
            step = jax_make_train_step(jmodel, loss, donate=False,
                                       ema_decay=opts.get("ema_decay", 0.0))
            state, metrics = step(state, jax_mesh.shard_batch(b, mesh),
                                  jax.random.PRNGKey(7 + i))
            losses.append(float(jax.device_get(metrics["loss"])))
    sharded = sorted(k for k, s in _flat(jax.tree_util.tree_map(
        lambda s: jax_mesh.MODEL_AXIS in tuple(s.spec), param_sh)).items()
        if s)
    state = jax.device_get(state)
    variables = {**_flat(state.params), **_flat(state.batch_stats)}
    ema = None if state.ema_params is None else _flat(state.ema_params)
    return losses, variables, ema, sharded


# ---------------------------------------------------------------------------
# the ranks: one spawn a grid, in a thread beside the JAX runs
# ---------------------------------------------------------------------------


# (c): the checkpoints that cross grids: DBoF's cluster layer and BN
# statistics with Adam; Adafactor's factored statistics (a block's and a
# whole one). name -> (case, optimizer)
CHECKPOINTS = {"adam_dbof": ("dbof", "AdamOptimizer"),
               "adafactor": ("adafactor", "AdafactorOptimizer")}


def _one_card_state(case, optimizer):
    model, base, port_kw, _, _, _, _ = _case(case)
    net = get_model(model, ModelHParams(**base, **port_kw))
    net.load_state_dict({k: torch.from_numpy(v)
                         for k, v in _weights(case).items()})
    return TrainState(net, optimizer=optimizer, ema=True,
                      base_learning_rate=LR, global_batch_size=B,
                      clip_gradient_norm=1.0)


def _one_card_checkpoint(path, case, optimizer):
    """Two one-card steps of the case from the JAX model's variables,
    saved at step 2 under `path`."""
    _, _, _, _, _, batches, uniforms = _case(case)
    state = _one_card_state(case, optimizer)
    step = make_train_step(tlosses.get_loss("CrossEntropyLoss"),
                           ema_decay=0.9)
    for i, b in enumerate(batches[:2]):
        u = None if uniforms is None else torch.from_numpy(uniforms[i])
        state, _ = step(state, {k: torch.from_numpy(v) for k, v in b.items()},
                        u=u)
    CheckpointManager(path).force_save(2, state)


def _grid_specs(grid, root):
    data, mp = grid
    specs = [_spec(name, mp) for name in GRIDS[grid]]
    if grid == (1, 2):
        for name, (case, optimizer) in CHECKPOINTS.items():
            specs.append(_spec(
                case, mp, optimizer=optimizer, ema_decay=0.9,
                checkpoint_dir=os.path.join(root, f"tp-{name}")))
            specs.append(_spec(case, mp, optimizer=optimizer, ema_decay=0.9,
                               src=os.path.join(root, f"one-{name}"),
                               dst=os.path.join(root, f"tp-from-one-{name}")))
    return specs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{grid: a Future of {case index: rank 0's result, "ranks": every
    rank's results, "root": the checkpoints' directory}}; the grids run
    one after another in a thread while the tests run the JAX steps."""
    root = str(tmp_path_factory.mktemp("tensor_parallel"))
    for name, (case, optimizer) in CHECKPOINTS.items():
        _one_card_checkpoint(os.path.join(root, f"one-{name}"), case,
                             optimizer)
    pool = ThreadPoolExecutor(max_workers=1)

    def run(grid):
        specs = _grid_specs(grid, root)
        out = launch(replay_all, (specs,), nprocs=grid[0] * grid[1],
                     device="cpu", timeout_s=DEADLINE_S)
        return dict(enumerate(out[0]), ranks=out, root=root)

    futures = {grid: pool.submit(run, grid) for grid in GRIDS}
    yield futures
    pool.shutdown(wait=True)


def _assert_close(got, want_losses, want, want_ema):
    np.testing.assert_allclose(got["losses"], want_losses, rtol=RTOL)
    assert set(got["state"]) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got["state"][key], value, rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    if want_ema is not None:
        assert set(got["ema"]) == set(want_ema)
        for key, value in want_ema.items():
            np.testing.assert_allclose(got["ema"][key], value, rtol=RTOL,
                                       atol=ATOL, err_msg=key)


def _grid_cases():
    return [pytest.param(grid, name, id=f"{grid[0]}x{grid[1]}-{name}")
            for grid, names in GRIDS.items() for name in names]


@pytest.mark.parametrize("grid,name", _grid_cases())
def test_tp_step_matches_the_jax_gspmd_step(grid, name, ranks):
    want_losses, want, want_ema, sharded = _jax_run(name, *grid)
    result = ranks[grid].result()
    got = result[GRIDS[grid].index(name)]
    _assert_close(got, want_losses, want, want_ema)
    assert got["blocks"] == sharded and sharded
    assert got["sharded"] == []
    # Each rank holds only its blocks: the parameter, its gradient, its
    # optimizer state and its EMA (an Adafactor statistic that averages
    # over the columns holds the whole rows).
    for rank in result["ranks"]:
        held = rank[GRIDS[grid].index(name)]["held"]
        for key in sharded:
            block = want[key].shape[:-1] + (want[key].shape[-1] // grid[1],)
            h = held[key]
            assert h["param"] == h["grad"] == block, key
            if want_ema is not None:
                assert h["ema"] == block, key
            factored = {block[-1:], block[:1]} if len(block) == 2 else set()
            assert all(shape == block or shape in factored
                       for shape in h["optimizer"]), (key, h)


def test_misaligned_split_cuts_through_a_class(ranks):
    """6 classes, M = 2, mp = 4: the experts' 12 columns in blocks of 3 (a
    class's two experts across a block edge), the gates' 18 whole."""
    got = ranks[(1, 4)].result()[GRIDS[(1, 4)].index("moe_misaligned")]
    assert got["blocks"] == ["tower.experts_bias", "tower.experts_kernel"]
    assert got["held"]["tower.experts_kernel"]["param"] == (D, 3)
    assert got["held"]["tower.gates_kernel"]["param"] == (D, 18)


def test_ranks_of_a_model_group_end_alike(ranks):
    """The replicated state and the gathered blocks are the same bits on
    every rank of the grid."""
    for grid in GRIDS:
        result = ranks[grid].result()
        for cases in zip(*result["ranks"]):
            if isinstance(cases[0], dict):  # a replay, not a resave
                assert len({c["digest"] for c in cases}) == 1


# ---------------------------------------------------------------------------
# (c) checkpoints across grids
# ---------------------------------------------------------------------------


def _load_files(path):
    step = max(int(n) for n in os.listdir(path) if n.isdigit())
    return {name: torch.load(os.path.join(path, str(step), name),
                             weights_only=True)
            for name in ("model.pt", "optimizer.pt", "ema.pt")}


def _assert_same(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.shape == b.shape, where
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_tp_checkpoint_is_the_one_card_format(name, ranks, tmp_path):
    """A one-card state restores the TP run's step and writes it again bit
    for bit (the model, the optimizer state, the EMA): its shapes are the
    one-card run's."""
    result = ranks[(1, 2)].result()
    tp = os.path.join(result["root"], f"tp-{name}")
    case, optimizer = CHECKPOINTS[name]
    written = _load_files(tp)
    one = _load_files(os.path.join(result["root"], f"one-{name}"))
    for key in ("model.pt", "ema.pt"):
        assert {k: v.shape for k, v in written[key].items()} == {
            k: v.shape for k, v in one[key].items()}
    shapes = lambda opt: {i: {k: getattr(v, "shape", v)  # noqa: E731
                              for k, v in s.items() if k != "step"}
                          for i, s in opt["state"].items()}
    assert shapes(written["optimizer.pt"]) == shapes(one["optimizer.pt"])
    state = _one_card_state(case, optimizer)
    CheckpointManager(tp).restore(state)
    again = str(tmp_path / "again")
    CheckpointManager(again).force_save(state.step, state)
    _assert_same(_load_files(again), written)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_tp_state_resumes_a_one_card_checkpoint(name, ranks):
    """Two TP ranks restore a one-card step and write it again bit for
    bit."""
    result = ranks[(1, 2)].result()
    root = result["root"]
    _assert_same(_load_files(os.path.join(root, f"tp-from-one-{name}")),
                 _load_files(os.path.join(root, f"one-{name}")))


# ---------------------------------------------------------------------------
# (a) the policy, every model (no spawn)
# ---------------------------------------------------------------------------


def _zoo_hparams(vocab):
    return dict(vocab_size=vocab, feature_dim=D, max_frames=F,
                dbof_cluster_size=16, dbof_hidden_size=8,
                netvlad_cluster_size=4, netvlad_hidden_size=8, lstm_cells=8,
                gru_cells=8, attention_hidden_size=8, nextvlad_cluster_size=4,
                nextvlad_hidden_size=8, nextvlad_groups=2,
                chain_hidden_size=8, cnn_filters=8, moe_num_mixtures=2)


@functools.lru_cache(maxsize=None)
def _jax_shapes(name, vocab):
    """{path with ".": shape} of the JAX model's parameters."""
    model = jax_get_model(name, JaxHParams(**_zoo_hparams(vocab)))
    x = (jnp.zeros((2, F, D), jnp.uint8) if is_frame_level_model(name)
         else jnp.zeros((2, D), jnp.float32))
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(lambda: model.init(
        {"params": key, "sample": key}, x, jnp.full((2,), F, jnp.int32),
        train=False))
    return {".".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                variables["params"])}


@pytest.mark.parametrize("vocab", [C, 6])
@pytest.mark.parametrize("name", list_models())
def test_specs_are_the_jax_policy(name, vocab):
    shapes = _jax_shapes(name, vocab)
    assert any(k.split(".")[-1] in TP_SHARDABLE for k in shapes)
    model = get_model(name, ModelHParams(**_zoo_hparams(vocab)))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == shapes
    for mp in (2, 4):
        mesh = jax_mesh.make_mesh(8, model_parallel=mp)
        for fsdp in (0, 64):
            want = {k: tuple(jax_mesh.param_spec(
                k.replace(".", "/"), np.zeros(s, np.float32), mesh, fsdp))
                for k, s in shapes.items()}
            assert param_specs(model, 8, fsdp, mp) == want, (mp, fsdp)


# ---------------------------------------------------------------------------
# (d) the CLIs
# ---------------------------------------------------------------------------


def test_train_cli_at_two_model_ranks_then_eval_and_inference(tmp_path):
    data = str(tmp_path / "data")
    write_dataset(data, "train", num_shards=2, videos_per_shard=12,
                  frame_level=True, num_classes=C, seed=1, rgb_dim=12,
                  audio_dim=4)
    write_dataset(data, "validate", num_shards=1, videos_per_shard=10,
                  frame_level=True, num_classes=C, seed=2, rgb_dim=12,
                  audio_dim=4)
    reader = ["--frame_features", "--feature_names=rgb,audio",
              "--feature_sizes=12,4", f"--num_classes={C}",
              f"--max_frames={F}", "--device=cpu"]
    flags = [f"--train_data_pattern={data}/train-*.tfrecord", *reader,
             "--model=DbofModel", "--batch_size=8", "--dbof_cluster_size=16",
             "--dbof_hidden_size=8", "--iterations=4",
             "--compute_dtype=float32", "--optimizer=SgdOptimizer",
             "--ema_decay=0.9", "--log_every_n_steps=1", "--max_steps=3"]
    tp, one = str(tmp_path / "tp"), str(tmp_path / "one")
    assert train_cli.main(
        [*flags, f"--train_dir={tp}", "--num_devices=2",
         "--model_parallel=2", "--export_model_steps=3"],
        init_method="file://" + str(tmp_path / "store"),
        timeout_s=DEADLINE_S) == 3
    assert train_cli.main([*flags, f"--train_dir={one}",
                           "--num_devices=1"]) == 3

    def losses(run):
        with open(os.path.join(run, "events.jsonl")) as f:
            return [json.loads(line)["GlobalStep/Loss"] for line in f
                    if "GlobalStep/Loss" in line]

    np.testing.assert_allclose(losses(tp), losses(one), rtol=RTOL)
    assert len(losses(tp)) == 3
    got, want = _load_files(tp), _load_files(one)
    for name in ("model.pt", "ema.pt"):
        for key, value in want[name].items():
            np.testing.assert_allclose(got[name][key].numpy(),
                                       value.numpy(), rtol=RTOL, atol=ATOL,
                                       err_msg=key)
    # --export_model_steps exports the gathered model.
    serve, meta = load_serving(os.path.join(tp, "export", "step_3"),
                               device="cpu")
    values, _ = serve(np.zeros((4, F, 16), np.uint8), np.full((4,), F))
    assert meta["model"] == "DbofModel" and values.shape == (4, 20)
    assert torch.all(torch.isfinite(values))
    metrics = eval_cli.main([f"--eval_data_pattern={data}/validate-*",
                             f"--train_dir={tp}", "--run_once",
                             "--batch_size=5", "--device=cpu"])
    assert metrics["step"] == 3 and 0 <= metrics["gap"] <= 1
    out = str(tmp_path / "out.csv")
    stats = inference_cli.main([f"--input_data_pattern={data}/validate-*",
                                f"--train_dir={tp}", f"--output_file={out}",
                                "--batch_size=5", "--device=cpu"])
    assert stats["num_videos"] == 10 and os.path.getsize(out) > 0
