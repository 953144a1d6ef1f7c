"""The port's CLIs on video-level records, on the CPU: the starter
workflow with no --model (LogisticModel over mean_rgb, 4716 classes, the
config's defaults throughout), then ChainMoeModel, each through
cli.train -> cli.eval --run_once -> cli.inference; and the trainer's
warning when --frame_features disagrees with the model."""

import json
import logging

import numpy as np
import pytest

from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as inference_cli
from yt8m_tpu_torch.cli import train as train_cli
from yt8m_tpu_torch.config import TrainConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.train.loop import Trainer


def _read_csv(path):
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "VideoId,LabelConfidencePairs"
    return lines[1:]


def _workflow(data, run, tmp_path, flags=(), serve_flags=()):
    last = train_cli.main([f"--train_data_pattern={data}/train-*.tfrecord",
                           f"--train_dir={run}", "--device=cpu", *flags])
    assert last >= 1
    out = eval_cli.main([f"--eval_data_pattern={data}/validate-*.tfrecord",
                         f"--train_dir={run}", "--device=cpu", *serve_flags])
    assert out["step"] == last and out["nonfinite_predictions"] == 0
    assert 0 <= out["gap"] <= 1 and np.isfinite(out["avg_loss"])
    csv = str(tmp_path / "out.csv")
    stats = inference_cli.main([
        f"--input_data_pattern={data}/validate-*.tfrecord",
        f"--train_dir={run}", f"--output_file={csv}", "--device=cpu",
        *serve_flags])
    assert stats["nonfinite_predictions"] == 0
    return last, out, stats, _read_csv(csv)


def test_default_cli_workflow_trains_logistic_model(tmp_path):
    """python -m yt8m_tpu_torch.cli.train --train_data_pattern=...
    --train_dir=... --device=cpu: no --model, no --frame_features."""
    data = str(tmp_path / "data")
    write_dataset(data, "train", num_shards=2, videos_per_shard=24, seed=1)
    write_dataset(data, "validate", num_shards=1, videos_per_shard=20,
                  seed=2)
    run = str(tmp_path / "run")
    last, out, stats, lines = _workflow(data, run, tmp_path)
    with open(f"{run}/model_flags.json") as f:
        recorded = json.load(f)
    assert recorded["model"] == "LogisticModel"
    assert recorded["frame_features"] is False
    assert recorded["feature_names"] == "mean_rgb"
    assert recorded["num_classes"] == 4716
    assert stats["num_videos"] == 20 and len(lines) == 20
    assert all(len(line.split(",")[1].split()) == 40 for line in lines)


def test_chain_moe_cli_workflow(tmp_path):
    data = str(tmp_path / "data")
    kw = dict(num_classes=20, rgb_dim=24, audio_dim=8)
    write_dataset(data, "train", num_shards=2, videos_per_shard=16, seed=1,
                  **kw)
    write_dataset(data, "validate", num_shards=1, videos_per_shard=12,
                  seed=2, **kw)
    flags = ["--model=ChainMoeModel", "--feature_names=mean_rgb,mean_audio",
             "--feature_sizes=24,8", "--num_classes=20", "--batch_size=8",
             "--max_steps=3", "--chain_hidden_size=16", "--chain_stages=3",
             "--log_every_n_steps=1"]
    serve = ["--batch_size=8", "--top_k=5"]
    last, out, stats, lines = _workflow(data, str(tmp_path / "run"),
                                        tmp_path, flags, serve)
    assert last == 3 and out["step"] == 3
    assert stats["num_videos"] == 12 and len(lines) == 12
    assert all(len(line.split(",")[1].split()) == 10 for line in lines)


@pytest.mark.parametrize("model,frame_features,warns", [
    ("LogisticModel", False, False),
    ("FrameLevelLogisticModel", False, True),
    ("LogisticModel", True, True),
])
def test_trainer_warns_when_frame_features_disagree(tmp_path, caplog, model,
                                                    frame_features, warns):
    """The JAX Trainer's warning (train/loop.py): the model's
    frame-level flag against --frame_features."""
    data = str(tmp_path / "data")
    write_dataset(data, "train", num_shards=1, videos_per_shard=2,
                  frame_level=frame_features, num_classes=5, rgb_dim=6,
                  audio_dim=2)
    cfg = TrainConfig(train_data_pattern=f"{data}/train-*.tfrecord",
                      train_dir=str(tmp_path / "run"), model=model,
                      frame_features=frame_features, device="cpu",
                      feature_sizes="8", num_classes=5)
    with caplog.at_level(logging.WARNING, logger="yt8m_tpu_torch.train"):
        Trainer(cfg)
    said = [r.getMessage() for r in caplog.records
            if "frame-level" in r.getMessage()]
    assert bool(said) == warns, said
