"""The port's eval loop (yt8m_tpu_torch/eval/loop.py) and the train ->
eval -> inference CLIs against the JAX package.

A JAX Trainer run's orbax checkpoint is read here (the port itself
imports no orbax), converted with convert.state_dict_from_jax, and
evaluated by the port and by the JAX package's evaluate_checkpoint on
the same shards. Tolerance: GAP, Hit@1, PERR, mAP and the average loss
within 1e-5 (absolute; all lie in [0, 1] but the loss, ~7 here), on the
sparse (device_metric_topk=64) and the dense (0) paths: float32 forwards
of the same graph whose sums run in another order (1e-6 relative), fed
to the same numpy metrics. Poll and sweep modes and the CLIs are checked
for what they do, on the CPU (--device=cpu).
"""

import os

import numpy as np
import pytest

from yt8m_tpu.config import EvalConfig as JaxEvalConfig
from yt8m_tpu.eval.loop import evaluate_checkpoint as jax_evaluate
from yt8m_tpu.models.hparams import ModelHParams as JaxHParams
from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as inference_cli
from yt8m_tpu_torch.cli import train as train_cli
from yt8m_tpu_torch.config import EvalConfig
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.eval import loop as tloop
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train.checkpoint import CheckpointManager
from yt8m_tpu_torch.train.state import TrainState

import test_torch_trainer as trainer_tests  # noqa: E402

C, MAXF = trainer_tests.C, trainer_tests.MAXF
HP, READER = trainer_tests.HP, trainer_tests.READER


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval_data")
    for split, n, seed in (("train", 16, 1), ("validate", 20, 2)):
        write_dataset(str(root), split, num_shards=2, videos_per_shard=n,
                      frame_level=True, num_classes=C, seed=seed,
                      rgb_dim=12, audio_dim=4)
    return str(root)


@pytest.fixture(scope="module")
def jax_run(shards, tmp_path_factory):
    """A JAX Trainer run of 5 Adam steps; its train_dir and the step-5
    variables from its orbax checkpoint."""
    run = str(tmp_path_factory.mktemp("jax_run") / "run")
    cfg = trainer_tests._jax_cfg(os.path.join(shards, "train-*.tfrecord"),
                                 run, 5, "AdamOptimizer")
    assert trainer_tests._jax_run(cfg) == 5
    return run, trainer_tests.read_orbax(run, 5)


def _eval_cfgs(shards, train_dir, k):
    common = dict(eval_data_pattern=os.path.join(shards, "validate-*"),
                  batch_size=8, model="NetVladModel", train_dir=train_dir,
                  device_metric_topk=k, **READER)
    return (JaxEvalConfig(hparams=JaxHParams(**HP), **common),
            EvalConfig(hparams=ModelHParams(**HP), device="cpu", **common))


def _port_run(tmp_path, variables, steps=(5,)):
    run = str(tmp_path / "port_run")
    hp = ModelHParams(vocab_size=C, feature_dim=16, max_frames=MAXF, **HP)
    model = get_model("NetVladModel", hp)
    model.load_state_dict(state_dict_from_jax(variables))
    ckpt = CheckpointManager(run)
    for s in steps:
        ckpt.force_save(s, TrainState(model))
    return run


@pytest.mark.parametrize("k", [64, 0], ids=["sparse", "dense"])
def test_port_eval_of_a_jax_checkpoint_matches_jax(shards, jax_run,
                                                   tmp_path, k):
    jdir, variables = jax_run
    run = _port_run(tmp_path, variables)
    jcfg, cfg = _eval_cfgs(shards, jdir, k)
    want = jax_evaluate(jcfg)
    cfg.train_dir = run
    got = tloop.evaluate_checkpoint(cfg)
    assert got["step"] == want["step"] == 5
    assert got["nonfinite_predictions"] == 0
    for key in ("gap", "avg_hit_at_one", "avg_perr", "avg_loss"):
        assert abs(got[key] - want[key]) <= 1e-5, (key, got[key], want[key])
    assert abs(np.mean(got["aps"]) - np.mean(want["aps"])) <= 1e-5
    events = os.path.join(run, "eval", "events.jsonl")
    assert os.path.exists(events) and "Epoch/GAP" in open(events).read()


def test_poll_and_sweep_modes(shards, jax_run, tmp_path, monkeypatch):
    _, variables = jax_run
    run = _port_run(tmp_path, variables, steps=(2, 4, 6))
    _, cfg = _eval_cfgs(shards, run, 64)
    cfg.run_once = False
    seen = []
    real = tloop.evaluate_checkpoint

    def record(config, step=None):
        seen.append(step)
        return real(config, step=step)

    monkeypatch.setattr(tloop, "evaluate_checkpoint", record)
    out = tloop.evaluation_loop(cfg, max_evaluations=-1)
    assert seen == [2, 4, 6] and out["step"] == 6
    seen.clear()
    assert tloop.evaluation_loop(cfg, max_evaluations=2)["step"] == 4
    assert seen == [2, 4]
    seen.clear()
    cfg.checkpoint_step = 4  # one evaluation of that step
    assert tloop.evaluation_loop(cfg)["step"] == 4 and seen == [4]
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    cfg.train_dir, cfg.checkpoint_step = empty, None
    assert tloop.evaluation_loop(cfg, max_evaluations=-1) == {}
    with pytest.raises(FileNotFoundError):
        real(_eval_cfgs(shards, empty, 64)[1])


def test_cli_train_eval_inference_on_the_cpu(shards, tmp_path):
    """The reference workflow through the port's CLIs: train, resume,
    eval of the latest and of an earlier step, inference to the CSV, and
    --use_ema_weights on both."""
    run = str(tmp_path / "run")
    common = ["--frame_features", "--feature_names=rgb,audio",
              "--feature_sizes=12,4", f"--num_classes={C}",
              f"--max_frames={MAXF}", "--device=cpu"]
    train = [f"--train_data_pattern={shards}/train-*.tfrecord",
             f"--train_dir={run}", "--batch_size=8", "--model=NetVladModel",
             "--netvlad_cluster_size=8", "--netvlad_hidden_size=16",
             "--netvlad_fused_train", "--save_checkpoint_every_n_steps=2",
             "--max_checkpoints_to_keep=3", "--ema_decay=0.9",
             "--log_every_n_steps=1"] + common
    assert train_cli.main(train + ["--max_steps=3"]) == 3
    assert train_cli.main(train + ["--max_steps=5"]) == 5
    assert CheckpointManager(run).all_steps() == [2, 3, 4, 5][-3:]
    data = f"--eval_data_pattern={shards}/validate-*.tfrecord"
    out = eval_cli.main([data, f"--train_dir={run}", "--batch_size=8",
                         "--device=cpu"])
    assert out["step"] == 5 and 0 <= out["gap"] <= 1
    assert 0 <= out["avg_hit_at_one"] <= 1 and np.isfinite(out["avg_loss"])
    earlier = eval_cli.main([data, f"--train_dir={run}", "--batch_size=8",
                             "--device=cpu", "--checkpoint_step=3",
                             "--use_ema_weights"])
    assert earlier["step"] == 3 and earlier["gap"] != out["gap"]
    csv = str(tmp_path / "out.csv")
    stats = inference_cli.main([
        f"--input_data_pattern={shards}/validate-*.tfrecord",
        f"--train_dir={run}", f"--output_file={csv}", "--batch_size=8",
        "--top_k=5", "--device=cpu", "--use_ema_weights"])
    assert stats["num_videos"] == 40 and stats["nonfinite_predictions"] == 0
    with open(csv) as f:
        lines = f.read().splitlines()
    assert lines[0] == "VideoId,LabelConfidencePairs" and len(lines) == 41
    assert all(len(line.split(",")[1].split()) == 10 for line in lines[1:])
