"""The port's trainer (yt8m_tpu_torch/train/loop.py, checkpoint.py, the
shuffled reader, the train CLI's config) against the JAX package's.

Inputs are the same synthetic shards on both sides. Tolerances:
  * the shuffled reader: batches equal, element for element, in the same
    order (the same numpy generators drive both).
  * the port's Trainer against JAX's for 6 steps of NetVladModel at small
    widths (float32, no frame sampling), the port resumed from a step-0
    checkpoint that holds JAX's initial weights: each step's logged loss
    within 1e-5 relative under SGD and 1e-3 under Adam, the trajectory
    tolerances of tests/test_torch_train.py (float32 sums in another
    order; Adam divides each update by the gradient's own scale, so
    gradient noise moves an element by a tenth of lr at most).
  * checkpoints restore bit for bit.
"""

import json
import logging
import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from yt8m_tpu.config import TrainConfig as JaxTrainConfig
from yt8m_tpu.data.readers import BatchIterator as JaxBatchIterator
from yt8m_tpu.data.readers import ReaderConfig as JaxReaderConfig
from yt8m_tpu.models.hparams import ModelHParams as JaxHParams
from yt8m_tpu.train.loop import Trainer as JaxTrainer
from yt8m_tpu_torch.config import TrainConfig
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train import loop as tloop
from yt8m_tpu_torch.train.checkpoint import CheckpointManager
from yt8m_tpu_torch.train.state import TrainState

C, D_RGB, D_AUDIO, MAXF = 12, 12, 4, 20
HP = dict(netvlad_cluster_size=8, netvlad_hidden_size=16,
          compute_dtype="float32")
READER = dict(feature_names="rgb,audio", feature_sizes=f"{D_RGB},{D_AUDIO}",
              frame_features=True, num_classes=C, max_frames=MAXF)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer_data")
    write_dataset(str(root), "train", num_shards=2, videos_per_shard=16,
                  frame_level=True, num_classes=C, seed=1, rgb_dim=D_RGB,
                  audio_dim=D_AUDIO)
    return str(root / "train-*.tfrecord")


def _jax_cfg(data, train_dir, steps, optimizer):
    return JaxTrainConfig(
        train_data_pattern=data, batch_size=8, model="NetVladModel",
        train_dir=train_dir, max_steps=steps, log_every_n_steps=1,
        num_devices=1, optimizer=optimizer, base_learning_rate=0.01,
        learning_rate_decay_examples=16, hparams=JaxHParams(**HP), **READER)


def _port_cfg(data, train_dir, **kw):
    base = dict(train_data_pattern=data, batch_size=8, model="NetVladModel",
                train_dir=train_dir, log_every_n_steps=1, device="cpu",
                base_learning_rate=0.01, learning_rate_decay_examples=16,
                hparams=ModelHParams(**HP), **READER)
    base.update(kw)
    return TrainConfig(**base)


def _jax_run(cfg):
    it = JaxBatchIterator(
        cfg.train_data_pattern, JaxReaderConfig(
            cfg.feature_names, cfg.feature_sizes, True, num_classes=C,
            max_frames=MAXF),
        batch_size=cfg.batch_size, shuffle=True, num_epochs=cfg.num_epochs,
        seed=cfg.seed, pad_final_batch=True)
    return JaxTrainer(cfg, it).run()


def read_orbax(train_dir, step):
    """{"params", "batch_stats"} of the JAX trainer's checkpoint at `step`
    (numpy leaves)."""
    mgr = ocp.CheckpointManager(os.path.abspath(train_dir))
    restored = mgr.restore(step)
    mgr.close()
    return {k: jax.tree_util.tree_map(np.asarray, restored[k])
            for k in ("params", "batch_stats")}


def _losses(train_dir):
    with open(os.path.join(train_dir, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return {r["step"]: r["GlobalStep/Loss"] for r in rows
            if "GlobalStep/Loss" in r}


def test_shuffled_reader_yields_the_jax_batches(data):
    jrc = JaxReaderConfig(READER["feature_names"], READER["feature_sizes"],
                          True, num_classes=C, max_frames=MAXF)
    rc = ReaderConfig(READER["feature_names"], READER["feature_sizes"], True,
                      num_classes=C, max_frames=MAXF)
    for kw in (dict(shuffle=True, num_epochs=3, seed=5),
               dict(shuffle=True, num_epochs=2, seed=0, drop_remainder=True),
               dict(shuffle=False, num_epochs=1)):
        want = list(JaxBatchIterator(data, jrc, batch_size=5, **kw))
        got = list(BatchIterator(data, rc, batch_size=5, **kw))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g["id"] == w["id"]
            for key in ("features", "labels", "num_frames", "batch_mask"):
                np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("optimizer,rtol", [("SgdOptimizer", 1e-5),
                                            ("AdamOptimizer", 1e-3)])
def test_trainer_losses_match_the_jax_trainer(data, tmp_path, optimizer,
                                              rtol):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _jax_run(_jax_cfg(data, jdir, 0, optimizer)) == 0
    variables = read_orbax(jdir, 0)
    # The port's step-0 checkpoint: JAX's initial weights, a fresh
    # optimizer (JAX's step-0 moments are zeros).
    model = get_model("NetVladModel", _port_cfg(data, pdir).resolved_hparams())
    model.load_state_dict(state_dict_from_jax(variables))
    CheckpointManager(pdir).force_save(0, TrainState(model,
                                                     optimizer=optimizer))
    assert _jax_run(_jax_cfg(data, jdir, 6, optimizer)) == 6
    trainer = tloop.Trainer(_port_cfg(data, pdir, max_steps=6,
                                      optimizer=optimizer))
    assert trainer.run() == 6
    want, got = _losses(jdir), _losses(pdir)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5, 6]
    np.testing.assert_allclose([got[s] for s in range(1, 7)],
                               [want[s] for s in range(1, 7)], rtol=rtol)
    with open(os.path.join(pdir, "model_flags.json")) as f:
        flags = json.load(f)
    with open(os.path.join(jdir, "model_flags.json")) as f:
        jflags = json.load(f)
    assert set(flags) == set(jflags)
    assert flags["hparams"]["netvlad_cluster_size"] == 8


def _state(seed, ema):
    hp = ModelHParams(vocab_size=C, feature_dim=D_RGB + D_AUDIO,
                      max_frames=MAXF, **HP)
    model = get_model("NetVladModel", hp)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return TrainState(model, optimizer="AdamOptimizer", ema=ema)


def _train_some(state, steps=2):
    from yt8m_tpu_torch.train.losses import get_loss
    from yt8m_tpu_torch.train.step import make_train_step

    g = torch.Generator().manual_seed(9)
    batch = {
        "features": torch.randint(0, 256, (4, MAXF, D_RGB + D_AUDIO),
                                  generator=g, dtype=torch.uint8),
        "num_frames": torch.tensor([MAXF, 3, 1, 9], dtype=torch.int32),
        "labels": (torch.rand(4, C, generator=g) < 0.2).float(),
        "batch_mask": torch.ones(4),
    }
    step = make_train_step(get_loss("CrossEntropyLoss"), ema_decay=0.9)
    for _ in range(steps):
        step(state, batch)
    return state


def test_checkpoint_round_trip_model_adam_step_ema(tmp_path):
    state = _train_some(_state(0, ema=True), steps=3)
    ckpt = CheckpointManager(str(tmp_path))
    assert ckpt.force_save(3, state)
    assert not ckpt.force_save(3, state)  # already written
    other = _state(1, ema=True)
    ckpt.restore(other)
    assert other.step == 3
    for (n, a), (_, b) in zip(state.model.state_dict().items(),
                              other.model.state_dict().items()):
        assert torch.equal(a, b), n
    for n in state.ema:
        assert torch.equal(state.ema[n], other.ema[n]), n
    sa, sb = state.optimizer.state_dict(), other.optimizer.state_dict()
    for k in sa["state"]:
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa["state"][k][key], sb["state"][k][key])
    # Both go on identically.
    _train_some(state, 1)
    _train_some(other, 1)
    for a, b in zip(state.model.parameters(), other.model.parameters()):
        assert torch.equal(a, b)


def test_checkpoint_without_ema_and_ema_dropped(tmp_path, caplog):
    plain = _train_some(_state(0, ema=False))
    CheckpointManager(str(tmp_path / "a")).force_save(2, plain)
    with_ema = _state(1, ema=True)
    CheckpointManager(str(tmp_path / "a")).restore(with_ema)
    assert with_ema.ema is None  # the trainer seeds it from the params
    ema_run = _train_some(_state(2, ema=True))
    CheckpointManager(str(tmp_path / "b")).force_save(2, ema_run)
    no_ema = _state(3, ema=False)
    with caplog.at_level(logging.INFO):
        CheckpointManager(str(tmp_path / "b")).restore(no_ema, for_write=True)
    assert "DROPPED" in caplog.text and no_ema.ema is None


def test_checkpoint_interval_rotation_and_atomicity(tmp_path, monkeypatch):
    state = _state(0, ema=False)
    ckpt = CheckpointManager(str(tmp_path), max_to_keep=2,
                             save_interval_steps=3)
    saved = [s for s in range(1, 11) if ckpt.save(s, state)]
    assert saved == [3, 6, 9]
    assert ckpt.all_steps() == [6, 9] and ckpt.latest_step() == 9
    assert not ckpt.save(9, state) and not ckpt.save(6, state)

    # A crash while a step is written leaves the previous step as latest.
    def crash(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(json, "dump", crash)
    with pytest.raises(OSError):
        ckpt.force_save(10, state)
    monkeypatch.undo()
    assert ckpt.all_steps() == [6, 9]
    assert sorted(os.listdir(tmp_path)) == ["6", "9"]
    # A half-written directory that never got its step file is not a step.
    os.makedirs(tmp_path / "12")
    assert ckpt.latest_step() == 9


def test_trainer_resumes_and_continues_the_count(data, tmp_path):
    run = str(tmp_path / "run")
    cfg = dict(save_checkpoint_every_n_steps=2, max_checkpoints_to_keep=1)
    assert tloop.Trainer(_port_cfg(data, run, max_steps=3, **cfg)).run() == 3
    assert CheckpointManager(run).all_steps() == [3]
    trainer = tloop.Trainer(_port_cfg(data, run, max_steps=5, **cfg))
    assert trainer.run() == 5
    assert CheckpointManager(run).all_steps() == [5]
    assert sorted(_losses(run)) == [1, 2, 3, 4, 5]
    # --start_new_model wipes the run: training starts at step 0 again.
    trainer = tloop.Trainer(_port_cfg(data, run, max_steps=1,
                                      start_new_model=True))
    assert trainer.run() == 1
    assert CheckpointManager(run).all_steps() == [1]


def test_trainer_restore_seeds_ema_from_a_pre_ema_checkpoint(data, tmp_path):
    run = str(tmp_path / "run")
    tloop.Trainer(_port_cfg(data, run, max_steps=1)).run()
    trainer = tloop.Trainer(_port_cfg(data, run, max_steps=2,
                                      ema_decay=0.5))
    assert trainer.run() == 2
    assert os.path.exists(os.path.join(run, "2", "ema.pt"))


def test_nan_loss_fails_fast_and_saves_no_final_checkpoint(data, tmp_path,
                                                           monkeypatch):
    run = str(tmp_path / "run")
    trainer = tloop.Trainer(_port_cfg(data, run, max_steps=4))
    step = trainer.train_step

    def poisoned(state, batch, generator=None):
        state, metrics = step(state, batch, generator)
        metrics["loss"] = torch.tensor(float("nan"))
        return state, metrics

    trainer.train_step = poisoned
    with pytest.raises(tloop.NanLossDuringTrainingError, match="step 1"):
        trainer.run()
    # The check runs before the step's save; no final save either.
    assert CheckpointManager(run).all_steps() == []
    tloop.check_loss_finite(float("inf"), 3, fail_on_nan=False)  # logs only


def test_use_ema_weights_without_decay_and_unported_flags_fail_fast(
        data, tmp_path):
    with pytest.raises(SystemExit, match="ema_decay"):
        tloop.Trainer(_port_cfg(data, str(tmp_path), use_ema_weights=True))
    for kw in (dict(model_parallel=2), dict(fsdp_min_size=1000),
               dict(num_devices=4), dict(distill_data_pattern="x*"),
               dict(boost_weights_file="w.npz"), dict(export_model_steps=10),
               dict(async_checkpoint=True), dict(num_readers=4),
               dict(reader_processes=True), dict(adam_mu_dtype="bfloat16")):
        with pytest.raises(ValueError, match="not ported"):
            _port_cfg(data, str(tmp_path), **kw)
    from yt8m_tpu_torch.config import EvalConfig, InferenceConfig

    for cls, kw in ((EvalConfig, dict(ensemble_train_dirs="a,b")),
                    (InferenceConfig, dict(output_probabilities_dir="p")),
                    (InferenceConfig, dict(output_probabilities_topk=5)),
                    (InferenceConfig, dict(ensemble_weights="1,2"))):
        with pytest.raises(ValueError, match="not ported"):
            cls(**kw)
    assert _port_cfg(data, str(tmp_path), num_devices=1).num_devices == 1


def test_profile_dir_writes_a_trace_of_steps_10_to_20(data, tmp_path):
    profile = str(tmp_path / "profile")
    trainer = tloop.Trainer(_port_cfg(data, str(tmp_path / "run"),
                                      max_steps=21, log_every_n_steps=10,
                                      num_epochs=None, profile_dir=profile))
    assert trainer.run() == 21
    with open(os.path.join(profile, "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"]
