"""The port's multi-GPU lifecycle through its CLIs on the CPU
(`--num_devices=2 --device=cpu`: two gloo ranks that cli.train, cli.eval
and cli.inference spawn themselves), after the JAX package's
tests/test_multihost.py:235 (train -> checkpoint -> restore in new
processes -> go on -> eval) and :413 (the same with FSDP-sharded state).

  * The 2-rank trainer (FSDP, Adam, an EMA, the fused VLAD core) is the
    global batch's step: each rank reads its files
    (shard_files(files, rank, 2)) at batch 4 with seed 0 + rank; the
    port's one-device step on the ranks' batches stacked in rank order
    (rank 1, out of files after two batches, steps on padding at step 3)
    logs the same losses within rtol 2e-4, and its model, Adam moments
    and EMA meet rank 0's step-3 checkpoint within rtol 2e-4, atol 1e-5
    (float32 sums in another order: tests/test_manual_train.py's
    trajectory tolerance).
  * The checkpoint is the one-card format: a one-card TrainState
    restores it; a 2-rank resume from step 2 (the data starts over, as
    the JAX trainer's does) takes the one-device step from step 2 on the
    first batches; a 1-rank run resumes the 2-rank FSDP checkpoint and a
    2-rank run resumes a 1-rank checkpoint.
  * Eval and inference at 2 ranks (each serves its block of every
    padded batch; rank 1's block of the last batch has no real row) give
    rank 0 the 1-rank run's GAP, Hit@1, PERR, mAP and loss exactly, and
    its CSV and dense dumps byte for byte; the 2-rank FSDP checkpoint
    also serves through infer/export.py.

Every spawned group has a deadline of 240 s (parallel/distributed.py ::
launch's timeout_s, which the CLIs pass on), which fails the test; the
CLIs give the launcher none of their own.
"""

import copy
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as inference_cli
from yt8m_tpu_torch.cli import train as train_cli
from yt8m_tpu_torch.data.pipeline import make_batch_iterator
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.data.tfrecord import glob_files, shard_files
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.parallel import distributed
from yt8m_tpu_torch.train import loop as tloop
from yt8m_tpu_torch.train.checkpoint import CheckpointManager
from yt8m_tpu_torch.train.losses import get_loss
from yt8m_tpu_torch.train.state import TrainState
from yt8m_tpu_torch.train.step import make_train_step

C, D_RGB, D_AUDIO, MAXF = 12, 12, 4, 20
BATCH = 8
RTOL, ATOL = 2e-4, 1e-5
HP = dict(netvlad_cluster_size=8, netvlad_hidden_size=16,
          compute_dtype="float32", netvlad_fused_train=True)
READER = ["--frame_features", "--feature_names=rgb,audio",
          f"--feature_sizes={D_RGB},{D_AUDIO}", f"--num_classes={C}",
          f"--max_frames={MAXF}", "--device=cpu"]
TRAIN = [*READER, "--model=NetVladModel", f"--batch_size={BATCH}",
         "--netvlad_cluster_size=8", "--netvlad_hidden_size=16",
         "--compute_dtype=float32", "--netvlad_fused_train",
         "--ema_decay=0.9", "--log_every_n_steps=1",
         "--save_checkpoint_every_n_steps=2", "--num_epochs=1"]
FSDP = ["--num_devices=2", "--fsdp_min_size=100"]
DEADLINE_S = 240.0


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("multiprocess_data")
    # Three training shards of 6 videos: rank 0 reads two (3 batches of
    # 4), rank 1 one (a full batch, then 2 videos and 2 padded rows).
    write_dataset(str(root), "train", num_shards=3, videos_per_shard=6,
                  frame_level=True, num_classes=C, seed=1, rgb_dim=D_RGB,
                  audio_dim=D_AUDIO)
    write_dataset(str(root), "validate", num_shards=2, videos_per_shard=10,
                  frame_level=True, num_classes=C, seed=2, rgb_dim=D_RGB,
                  audio_dim=D_AUDIO)
    return str(root)


def _spawn(tmp_path, name):
    """The launcher's options of a CLI's spawned ranks here: a file store
    in `tmp_path` and the test's deadline."""
    return dict(init_method="file://" + str(tmp_path / f"store-{name}"),
                timeout_s=DEADLINE_S)


def _losses(train_dir):
    with open(os.path.join(train_dir, "events.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [(r["step"], r["GlobalStep/Loss"]) for r in rows
            if "GlobalStep/Loss" in r]


def _rank_batches(data):
    """The batches each rank's reader yields in the 2-rank run."""
    cfg = train_cli.parse_into(train_cli.TrainConfig, [
        f"--train_data_pattern={data}/train-*.tfrecord", *TRAIN],
        hparams_cls=ModelHParams)[0]
    rc = tloop.reader_config_from(cfg)
    files = glob_files(cfg.train_data_pattern)
    return [list(make_batch_iterator(
        shard_files(files, rank, 2), rc, batch_size=BATCH // 2,
        shuffle=True, num_epochs=1, seed=rank, pad_final_batch=True))
        for rank in range(2)], rc


def _stacked(per_rank, rc, i):
    parts = [b[i] if i < len(b) else tloop.padding_batch(rc, BATCH // 2,
                                                         False)
             for b in per_rank]
    return {k: torch.from_numpy(np.concatenate([p[k] for p in parts]))
            for k in ("features", "labels", "num_frames", "batch_mask")}


def _one_device(state=None):
    hp = ModelHParams(vocab_size=C, feature_dim=D_RGB + D_AUDIO,
                      max_frames=MAXF, **HP)
    if state is None:
        model = get_model("NetVladModel", hp)
        model.reset_parameters(torch.Generator().manual_seed(0))
        state = TrainState(model, global_batch_size=BATCH, ema=True)
    return state, make_train_step(get_loss("CrossEntropyLoss"),
                                  ema_decay=0.9)


def _snapshot(state):
    return {"model": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "optimizer": copy.deepcopy(state.optimizer.state_dict()),
            "ema": {k: v.clone() for k, v in state.ema.items()}}


@pytest.fixture(scope="module")
def run2(data, tmp_path_factory):
    """The 2-rank FSDP run to the end of its data (3 steps), and the
    one-device replay of its global batches (losses; states at 2, 3)."""
    tmp = tmp_path_factory.mktemp("run2")
    train_dir = str(tmp / "run")
    pattern = f"{data}/train-*.tfrecord"
    last = train_cli.main([f"--train_data_pattern={pattern}",
                           f"--train_dir={train_dir}", *TRAIN, *FSDP],
                          **_spawn(tmp, "train"))
    per_rank, rc = _rank_batches(data)
    assert [len(b) for b in per_rank] == [3, 2]
    state, step = _one_device()
    losses, states = [], {}
    for i in range(3):
        state, metrics = step(state, _stacked(per_rank, rc, i))
        losses.append(float(metrics["loss"]))
        states[i + 1] = _snapshot(state)
    return dict(last=last, dir=train_dir, losses=losses, states=states,
                per_rank=per_rank, rc=rc, tmp=tmp, pattern=pattern)


def _close_state(files, want):
    for k, v in want["model"].items():
        np.testing.assert_allclose(files["model"][k].numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    for k, v in want["ema"].items():
        np.testing.assert_allclose(files["ema"][k].numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    got, ref = files["optimizer"]["state"], want["optimizer"]["state"]
    assert set(got) == set(ref)
    for i in ref:
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_allclose(
                got[i][key].numpy(), ref[i][key].numpy(), rtol=RTOL,
                atol=ATOL, err_msg=f"{i} {key}")
        assert float(got[i]["step"]) == float(ref[i]["step"])


def _files(train_dir, step):
    path = os.path.join(train_dir, str(step))
    load = lambda name: torch.load(os.path.join(path, name),  # noqa: E731
                                   weights_only=True)
    return {"model": load("model.pt"), "optimizer": load("optimizer.pt"),
            "ema": load("ema.pt")}


def test_two_rank_trainer_takes_the_global_batch_step(run2):
    assert run2["last"] == 3
    logged = _losses(run2["dir"])
    assert [s for s, _ in logged] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in logged], run2["losses"],
                               rtol=RTOL)
    assert CheckpointManager(run2["dir"]).all_steps() == [2, 3]
    for step in (2, 3):
        _close_state(_files(run2["dir"], step), run2["states"][step])
    with open(os.path.join(run2["dir"], "model_flags.json")) as f:
        assert json.load(f)["hparams"]["bn_axis"] == ""


def test_the_fsdp_checkpoint_is_the_one_card_format(run2):
    state, _ = _one_device()
    CheckpointManager(run2["dir"]).restore(state, 3)
    assert state.step == 3
    for name, p in state.model.named_parameters():
        for value in state.optimizer.state[p].values():
            assert value.dim() == 0 or value.shape == p.shape, name
    for name, p in state.model.named_parameters():
        assert state.ema[name].shape == p.shape


def test_resume_at_two_ranks_takes_the_step_from_the_checkpoint(run2):
    """Resumed from step 2 in new processes, the ranks' readers start over:
    step 3 is the one-device step from step 2 on the first batches."""
    train_dir = str(run2["tmp"] / "resumed")
    shutil.copytree(run2["dir"], train_dir)
    shutil.rmtree(os.path.join(train_dir, "3"))
    os.remove(os.path.join(train_dir, "events.jsonl"))
    last = train_cli.main([f"--train_data_pattern={run2['pattern']}",
                           f"--train_dir={train_dir}", *TRAIN, *FSDP,
                           "--max_steps=3"],
                          **_spawn(run2["tmp"], "resume"))
    assert last == 3
    state, step = _one_device()
    CheckpointManager(run2["dir"]).restore(state, 2)
    state, metrics = step(state, _stacked(run2["per_rank"], run2["rc"], 0))
    logged = _losses(train_dir)
    assert [s for s, _ in logged] == [3]
    np.testing.assert_allclose(logged[0][1], float(metrics["loss"]),
                               rtol=RTOL)
    _close_state(_files(train_dir, 3), _snapshot(state))


def test_checkpoints_move_between_one_and_two_ranks(run2, data, tmp_path,
                                                    caplog):
    pattern = f"--train_data_pattern={data}/train-*.tfrecord"
    # The 2-rank FSDP checkpoint resumes on one rank.
    one = str(tmp_path / "one")
    shutil.copytree(run2["dir"], one)
    with caplog.at_level(logging.INFO, logger="yt8m_tpu_torch.train"):
        assert train_cli.main([pattern, f"--train_dir={one}", *TRAIN,
                               "--num_devices=1", "--max_steps=4"]) == 4
    assert "restoring checkpoint at step 3" in caplog.text
    assert CheckpointManager(one).latest_step() == 4
    # A 1-rank checkpoint resumes on 2 ranks.
    two = str(tmp_path / "two")
    assert train_cli.main([pattern, f"--train_dir={two}", *TRAIN,
                           "--max_steps=2"]) == 2
    assert train_cli.main([pattern, f"--train_dir={two}", *TRAIN, *FSDP,
                           "--max_steps=4"],
                          **_spawn(tmp_path, "two")) == 4
    assert [s for s, _ in _losses(two)] == [1, 2, 3, 4]
    assert CheckpointManager(two).all_steps() == [2, 4]


def test_two_rank_eval_and_inference_equal_one_rank(run2, data, tmp_path):
    serve = [f"--train_dir={run2['dir']}", f"--batch_size={BATCH}",
             "--device=cpu"]
    evals = {n: eval_cli.main([f"--eval_data_pattern={data}/validate-*",
                               *serve, "--run_once", f"--num_devices={n}"],
                              **_spawn(tmp_path, f"eval{n}"))
             for n in (1, 2)}
    for key in ("gap", "avg_hit_at_one", "avg_perr", "avg_loss", "aps",
                "step", "nonfinite_predictions"):
        assert evals[2][key] == evals[1][key], key
    assert evals[1]["step"] == 3 and np.isfinite(evals[1]["gap"])
    dense = {n: eval_cli.main([f"--eval_data_pattern={data}/validate-*",
                               *serve, "--run_once", f"--num_devices={n}",
                               "--device_metric_topk=0"],
                              **_spawn(tmp_path, f"dense{n}"))
             for n in (1, 2)}
    for key in ("gap", "avg_hit_at_one", "avg_perr", "avg_loss", "aps"):
        assert dense[2][key] == dense[1][key], key
    outs = {}
    for n in (1, 2):
        csv, dumps = tmp_path / f"out{n}.csv", tmp_path / f"dumps{n}"
        stats = inference_cli.main([
            f"--input_data_pattern={data}/validate-*", *serve,
            f"--output_file={csv}", f"--output_probabilities_dir={dumps}",
            f"--num_devices={n}"], **_spawn(tmp_path, f"inf{n}"))
        assert stats["num_videos"] == 20
        outs[n] = (csv.read_bytes(), sorted(os.listdir(dumps)), dumps)
    assert outs[2][0] == outs[1][0]
    assert outs[2][1] == outs[1][1] == ["predictions-00000.npz",
                                        "predictions-00001.npz",
                                        "predictions-00002.npz"]
    for name in outs[1][1]:
        a, b = (np.load(outs[n][2] / name) for n in (1, 2))
        np.testing.assert_array_equal(a["ids"], b["ids"])
        np.testing.assert_array_equal(a["predictions"], b["predictions"])


def test_the_fsdp_checkpoint_serves_through_the_export(run2, tmp_path):
    from yt8m_tpu_torch.convert import load_model
    from yt8m_tpu_torch.infer.export import export_model, load_serving

    hp = ModelHParams(vocab_size=C, feature_dim=D_RGB + D_AUDIO,
                      max_frames=MAXF, **HP)
    model = load_model(run2["dir"], "NetVladModel", hp, "cpu")
    export_model(str(tmp_path / "export"), "NetVladModel", hp, model)
    serve, meta = load_serving(str(tmp_path / "export"), device="cpu")
    batch = run2["per_rank"][0][0]
    values, indices = serve(batch["features"], batch["num_frames"])
    with torch.no_grad():
        probs = model(torch.from_numpy(batch["features"]),
                      torch.from_numpy(batch["num_frames"]))["predictions"]
    want = torch.topk(probs, values.shape[1])
    torch.testing.assert_close(values, want.values, rtol=1e-6, atol=1e-7)
    assert distributed.process_count() == 1
