"""The port's eval and inference CLIs accept the reference command lines.

The JAX package's EvalConfig and InferenceConfig carry `--optimizer` and
`--adam_mu_dtype` (the optimizer tree a checkpoint is restored with), so
eval.py and inference.py command lines written for the reference pass
them. The port's CLIs take both flags at the JAX defaults; they are inert
there (the port's checkpoint restores the model without the optimizer
state). Each test runs a CLI's `main` with its loop replaced by a probe,
so that what is checked is the parse, not the evaluation.
"""

import dataclasses

import pytest

from yt8m_tpu.config import EvalConfig as JaxEvalConfig
from yt8m_tpu.config import InferenceConfig as JaxInferenceConfig
from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as inference_cli
from yt8m_tpu_torch.config import EvalConfig, InferenceConfig

REFERENCE_FLAGS = ["--optimizer=AdamOptimizer", "--adam_mu_dtype=float32"]


def _run(cli, loop_name, argv, monkeypatch):
    seen = {}

    def probe(cfg):
        seen["cfg"] = cfg
        return {}

    monkeypatch.setattr(cli, loop_name, probe)
    monkeypatch.setattr(cli, "apply_recorded_model_flags",
                        lambda cfg, argv: None)
    cli.main(argv)
    return seen["cfg"]


@pytest.mark.parametrize("cli,loop_name,argv", [
    (eval_cli, "evaluation_loop",
     ["--eval_data_pattern=data/validate-*.tfrecord", "--train_dir=run",
      "--run_once", "--device=cpu"]),
    (inference_cli, "inference",
     ["--input_data_pattern=data/test-*.tfrecord", "--train_dir=run",
      "--output_file=out.csv", "--device=cpu"]),
], ids=["eval", "inference"])
def test_cli_parses_the_reference_optimizer_flags(cli, loop_name, argv,
                                                  monkeypatch):
    cfg = _run(cli, loop_name, argv + REFERENCE_FLAGS, monkeypatch)
    assert cfg.optimizer == "AdamOptimizer"
    assert cfg.adam_mu_dtype == "float32"
    assert cfg.device == "cpu"


@pytest.mark.parametrize("port,jax_cls", [
    (EvalConfig, JaxEvalConfig), (InferenceConfig, JaxInferenceConfig)],
    ids=["eval", "inference"])
def test_optimizer_fields_default_as_in_the_jax_configs(port, jax_cls):
    want = {f.name: f.default for f in dataclasses.fields(jax_cls)}
    got = {f.name: f.default for f in dataclasses.fields(port)}
    for name in ("optimizer", "adam_mu_dtype"):
        assert got[name] == want[name]
