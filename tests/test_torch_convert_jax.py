"""A JAX run's orbax checkpoint converted into the port's run directory
(scripts/convert_jax_checkpoint.py, convert.write_step_from_jax), then
served and resumed by the port.

The JAX Trainer trains NetVladModel at small widths (float32) for 2
steps, then resumes to 4 (the data iterator starts over on a resume in
both packages, so the port resumed from the converted step 2 reads the
batches the JAX run read at steps 3-4). Step 2 is converted. Tolerances:
  * eval metrics (GAP, Hit@1, PERR, the loss) of the port's cli.eval
    against JAX's evaluate_checkpoint of the same step: 1e-5 absolute,
    tests/test_torch_eval.py's bound (float32 forwards of one graph, sums
    in another order);
  * the dumped probabilities of the port's cli.inference against JAX's
    inference of the same step: 1e-5 * max|ref| + 1e-6, the same cause;
  * the resumed losses at steps 3-4 against the JAX run's: 1e-3
    relative, the Adam bound of tests/test_torch_trainer.py ::
    test_trainer_losses_match_the_jax_trainer (a bf16 first moment too);
  * the converted weights, EMA and Adam moments: exact (f32 copies; bf16
    moments widened and narrowed exactly).
"""

import json
import os

import numpy as np
import pytest
import torch

from yt8m_tpu.config import EvalConfig as JaxEvalConfig
from yt8m_tpu.config import InferenceConfig as JaxInferenceConfig
from yt8m_tpu.config import TrainConfig as JaxTrainConfig
from yt8m_tpu.eval.loop import evaluate_checkpoint as jax_evaluate
from yt8m_tpu.infer.predict import inference as jax_inference
from yt8m_tpu.models.hparams import ModelHParams as JaxHParams
from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as inference_cli
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.ensemble.average import load_prediction_dir
from yt8m_tpu_torch.train import loop as tloop
from yt8m_tpu_torch.train.checkpoint import (
    EMA_FILE,
    MODEL_FILE,
    OPTIMIZER_FILE,
    step_dirs,
)

import test_torch_trainer as trainer_tests  # noqa: E402

from scripts import convert_jax_checkpoint as converter  # noqa: E402

C, HP, READER = trainer_tests.C, trainer_tests.HP, trainer_tests.READER


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("convert_data")
    for split, n, seed in (("train", 16, 1), ("validate", 12, 2)):
        write_dataset(str(root), split, num_shards=2, videos_per_shard=n,
                      frame_level=True, num_classes=C, seed=seed,
                      rgb_dim=12, audio_dim=4)
    return str(root)


def _jax_cfg(shards, run, steps, optimizer, **kw):
    return JaxTrainConfig(
        train_data_pattern=os.path.join(shards, "train-*.tfrecord"),
        batch_size=8, model="NetVladModel", train_dir=run, max_steps=steps,
        log_every_n_steps=1, num_devices=1, optimizer=optimizer,
        base_learning_rate=0.01, learning_rate_decay_examples=16,
        save_checkpoint_every_n_steps=1, max_checkpoints_to_keep=10,
        hparams=JaxHParams(**HP), **READER, **kw)


def _jax_run(shards, tmp_path, optimizer, steps=(2, 4), **kw):
    run = str(tmp_path / "jax")
    for s in steps:  # a resume at each but the first
        assert trainer_tests._jax_run(
            _jax_cfg(shards, run, s, optimizer, **kw)) == s
    return run


def _convert(jax_dir, port_dir, step=2):
    return converter.main([f"--jax_train_dir={jax_dir}",
                           f"--train_dir={port_dir}", f"--step={step}"])


def _port_cfg(shards, run, **kw):
    return trainer_tests._port_cfg(
        os.path.join(shards, "train-*.tfrecord"), run, **kw)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_converted_adam_run_serves_and_resumes_on_the_jax_trajectory(
        shards, tmp_path, mu_dtype):
    jdir = _jax_run(shards, tmp_path, "AdamOptimizer",
                    adam_mu_dtype=mu_dtype)
    pdir = str(tmp_path / "port")
    done = _convert(jdir, pdir)
    assert done["optimizer"] == "AdamOptimizer"
    assert done["adam_mu_dtype"] == mu_dtype and not done["ema"]
    assert step_dirs(pdir) == [2]
    assert sorted(os.listdir(os.path.join(pdir, "2"))) == [
        MODEL_FILE, OPTIMIZER_FILE, "step.json"]
    with open(os.path.join(jdir, "model_flags.json")) as f:
        flags = json.load(f)
    with open(os.path.join(pdir, "model_flags.json")) as f:
        assert json.load(f) == flags
    # The moments are optax's, exactly.
    restored = converter.read_orbax_step(jdir, 2)[1]
    adam = restored["opt_state"][1][0]
    opt = torch.load(os.path.join(pdir, "2", OPTIMIZER_FILE),
                     weights_only=True)
    model = torch.load(os.path.join(pdir, "2", MODEL_FILE),
                       weights_only=True)
    names = list(model)  # parameters first, in the model's order
    first = opt["state"][0]
    mu_key = "mu" if mu_dtype == "bfloat16" else "exp_avg"
    path = names[0].split(".")
    want = adam["mu"]
    for key in path:
        want = want[key]
    np.testing.assert_array_equal(first[mu_key].float().numpy(),
                                  np.asarray(want, np.float32))
    assert int(first["step"]) == 2

    # cli.inference's probabilities against JAX's inference of step 2.
    data = os.path.join(shards, "validate-*.tfrecord")
    jdump, pdump = str(tmp_path / "jdump"), str(tmp_path / "pdump")
    jax_inference(JaxInferenceConfig(
        input_data_pattern=data, train_dir=jdir, checkpoint_step=2,
        batch_size=8, model="NetVladModel", output_file="",
        output_probabilities_dir=jdump, optimizer="AdamOptimizer",
        adam_mu_dtype=mu_dtype, hparams=JaxHParams(**HP), **READER))
    stats = inference_cli.main([
        f"--input_data_pattern={data}", f"--train_dir={pdir}",
        "--output_file=", f"--output_probabilities_dir={pdump}",
        "--batch_size=8", "--device=cpu",
                         "--compute_dtype=float32"])
    assert stats["num_videos"] == 24
    jids, jp = load_prediction_dir(jdump)
    pids, pp = load_prediction_dir(pdump)
    assert pids == jids
    err = np.max(np.abs(pp.astype(np.float64) - jp))
    assert err <= 1e-5 * np.max(np.abs(jp)) + 1e-6, err

    # cli.eval of the converted step against JAX's eval of step 2.
    common = dict(eval_data_pattern=data, batch_size=8, model="NetVladModel",
                  **READER)
    want = jax_evaluate(JaxEvalConfig(hparams=JaxHParams(**HP),
                                      train_dir=jdir, checkpoint_step=2,
                                      optimizer="AdamOptimizer",
                                      adam_mu_dtype=mu_dtype, **common))
    got = eval_cli.main([f"--eval_data_pattern={data}",
                         f"--train_dir={pdir}", "--batch_size=8",
                         "--device=cpu", "--compute_dtype=float32"])
    assert got["step"] == want["step"] == 2
    for key in ("gap", "avg_hit_at_one", "avg_perr", "avg_loss"):
        assert abs(got[key] - want[key]) <= 1e-5, (key, got[key], want[key])

    # The port's trainer resumes at step 2 and meets JAX's steps 3-4.
    trainer = tloop.Trainer(_port_cfg(shards, pdir, max_steps=4,
                                      adam_mu_dtype=mu_dtype))
    assert trainer.run() == 4
    want, got = trainer_tests._losses(jdir), trainer_tests._losses(pdir)
    assert sorted(got) == [3, 4]
    np.testing.assert_allclose([got[3], got[4]], [want[3], want[4]],
                               rtol=1e-3)


def test_converted_run_keeps_the_ema(shards, tmp_path):
    jdir = _jax_run(shards, tmp_path, "AdamOptimizer", steps=(2,),
                    ema_decay=0.9)
    pdir = str(tmp_path / "port")
    done = _convert(jdir, pdir)
    assert done["ema"] and done["optimizer"] == "AdamOptimizer"
    ema = torch.load(os.path.join(pdir, "2", EMA_FILE), weights_only=True)
    restored = converter.read_orbax_step(jdir, 2)[1]
    for name, value in ema.items():
        want = restored["ema_params"]
        for key in name.split("."):
            want = want[key]
        np.testing.assert_array_equal(value.numpy(), np.asarray(want))
    model = torch.load(os.path.join(pdir, "2", MODEL_FILE), weights_only=True)
    assert set(ema) < set(model)  # the parameters, not the BN statistics
    data = os.path.join(shards, "validate-*.tfrecord")
    raw = eval_cli.main([f"--eval_data_pattern={data}",
                         f"--train_dir={pdir}", "--batch_size=8",
                         "--device=cpu", "--compute_dtype=float32"])
    averaged = eval_cli.main([f"--eval_data_pattern={data}",
                              f"--train_dir={pdir}", "--batch_size=8",
                              "--device=cpu", "--use_ema_weights",
                              "--compute_dtype=float32"])
    assert raw["step"] == averaged["step"] == 2
    assert raw["gap"] != averaged["gap"] or raw["avg_loss"] != \
        averaged["avg_loss"]
    # The trainer resumes with the average and keeps it.
    assert tloop.Trainer(_port_cfg(shards, pdir, max_steps=3,
                                   ema_decay=0.9)).run() == 3
    assert os.path.exists(os.path.join(pdir, "3", EMA_FILE))


def test_converted_adafactor_run_serves_but_refuses_to_resume(shards,
                                                              tmp_path):
    jdir = _jax_run(shards, tmp_path, "AdafactorOptimizer", steps=(2,))
    pdir = str(tmp_path / "port")
    done = _convert(jdir, pdir)
    assert done["optimizer"] is None
    assert not os.path.exists(os.path.join(pdir, "2", OPTIMIZER_FILE))
    data = os.path.join(shards, "validate-*.tfrecord")
    out = eval_cli.main([f"--eval_data_pattern={data}",
                         f"--train_dir={pdir}", "--batch_size=8",
                         "--device=cpu", "--compute_dtype=float32"])
    assert out["step"] == 2 and 0 <= out["gap"] <= 1
    trainer = tloop.Trainer(_port_cfg(shards, pdir, max_steps=3,
                                      optimizer="AdafactorOptimizer"))
    with pytest.raises(FileNotFoundError, match="holds no optimizer.pt"):
        trainer.run()
    assert step_dirs(pdir) == [2]
