"""The port's serving slice end to end on the CPU: the CSV writer against
the JAX package's, the inference CLI over a synthetic dataset, the
checkpoint round trip, device resolution, and import hygiene (the port
and chip_smoke.py import nothing of JAX or of the JAX package)."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from yt8m_tpu.infer.predict import format_lines as jax_format_lines
from yt8m_tpu.models.hparams import ModelHParams as JaxHParams
from yt8m_tpu_torch.cli import inference as cli
from yt8m_tpu_torch.convert import load_model, save_checkpoint
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.infer.predict import format_lines, make_topk_predict_step
from yt8m_tpu_torch.models import ModelHParams, get_model

REPO = pathlib.Path(__file__).resolve().parents[1]
HP = ModelHParams(vocab_size=40, feature_dim=96, max_frames=20,
                  dbof_cluster_size=64, dbof_hidden_size=32, iterations=8)
RECORDED = dict(frame_features=True, feature_names="rgb,audio",
                feature_sizes="64,32", num_classes=40, max_frames=20,
                label_loss="CrossEntropyLoss")


def test_format_lines_byte_identical_to_jax():
    rng = np.random.default_rng(0)
    values = rng.random((6, 20)).astype(np.float32)
    values[1] = np.sort(values[1])  # ascending: formatter must re-sort
    values[2, :5] = 0.5             # ties keep their order
    values[3, 0] = 1e-30
    values[4, 3] = -3.0e38
    indices = rng.integers(0, 4716, (6, 20)).astype(np.int32)
    ids = [b"vid0", "vid1", b"a,b", b"", "x" * 40, b"\xc3\xa9"]
    got = "".join(format_lines(ids, values, indices))
    want = "".join(jax_format_lines(ids, values, indices))
    assert got.encode() == want.encode()


def _write_run(tmp_path, seed=0):
    data = str(tmp_path / "data")
    write_dataset(data, "test", num_shards=2, videos_per_shard=5,
                  frame_level=True, num_classes=40, seed=1, rgb_dim=64,
                  audio_dim=32, max_frames=20)
    model = get_model("DbofModel", HP)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    run = str(tmp_path / "run")
    save_checkpoint(run, model, "DbofModel", HP, **RECORDED)
    return data, run, model


def _cli_argv(data, run, out, device, top_k=5, batch_size=4):
    return [f"--input_data_pattern={data}/test-*.tfrecord",
            f"--train_dir={run}", f"--output_file={out}",
            f"--batch_size={batch_size}", f"--top_k={top_k}",
            f"--device={device}"]


def test_inference_cli_writes_top_k_csv_on_cpu(tmp_path):
    data, run, model = _write_run(tmp_path)
    out = str(tmp_path / "out.csv")
    stats = cli.main(_cli_argv(data, run, out, "cpu"))
    assert stats["num_videos"] == 10 and stats["device"] == "cpu"
    assert stats["nonfinite_predictions"] == 0
    lines = open(out).read().splitlines()
    assert lines[0] == "VideoId,LabelConfidencePairs"
    assert len(lines) == 11
    for line in lines[1:]:
        vid, pairs = line.split(",")
        toks = pairs.split()
        assert len(toks) == 10
        vals = [float(v) for v in toks[1::2]]
        assert vals == sorted(vals, reverse=True)
        assert all(0 <= int(c) < 40 for c in toks[0::2])

    # The CLI's lines equal the step's own top-k, formatted, for the same
    # sampling seed (InferenceConfig.seed = 0).
    step = make_topk_predict_step(model.eval(), 5)
    gen = torch.Generator().manual_seed(0)
    rc = ReaderConfig("rgb,audio", "64,32", frame_features=True,
                      num_classes=40, max_frames=20)
    want = ["VideoId,LabelConfidencePairs\n"]
    for batch in BatchIterator(f"{data}/test-*.tfrecord", rc, batch_size=4):
        v, i = step(torch.from_numpy(batch["features"]),
                    torch.from_numpy(batch["num_frames"]), gen)
        keep = batch["batch_mask"] > 0
        ids = [x for x, k in zip(batch["id"], keep) if k]
        want += format_lines(ids, v.numpy()[keep], i.numpy()[keep])
    assert open(out).read() == "".join(want)


def test_inference_defaults_to_cuda_and_raises_without_it(tmp_path,
                                                          monkeypatch):
    data, run, _ = _write_run(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _cli_argv(data, run, str(tmp_path / "o.csv"), "cpu")[:-1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


def test_checkpoint_round_trip(tmp_path):
    _, run, model = _write_run(tmp_path, seed=3)
    loaded = load_model(run, "DbofModel", HP, "cpu")
    assert not loaded.training
    for (k, a), (k2, b) in zip(model.state_dict().items(),
                               loaded.state_dict().items()):
        assert k == k2 and torch.equal(a, b)
    flags = json.load(open(os.path.join(run, "model_flags.json")))
    assert flags["model"] == "DbofModel"
    assert ModelHParams(**flags["hparams"]) == HP


def test_jax_recorded_model_flags_load_unchanged(tmp_path):
    """A model_flags.json as the JAX trainer writes it rebuilds the
    port's config: every recorded hparam is a field of the port's."""
    jhp = JaxHParams(dbof_cluster_size=128, iterations=10,
                     compute_dtype="float32")
    payload = {"model": "DbofModel", **RECORDED,
               "hparams": dataclasses.asdict(jhp)}
    run = tmp_path / "run"
    run.mkdir()
    (run / "model_flags.json").write_text(json.dumps(payload))
    from yt8m_tpu_torch.config import InferenceConfig
    from yt8m_tpu_torch.utils.flags import apply_recorded_model_flags

    cfg = InferenceConfig(train_dir=str(run))
    assert apply_recorded_model_flags(cfg, [])
    assert cfg.model == "DbofModel" and cfg.frame_features is True
    hp = cfg.resolved_hparams()
    assert hp.dbof_cluster_size == 128 and hp.iterations == 10
    assert hp.feature_dim == 96 and hp.vocab_size == 40
    # compute_dtype is a serving knob: the CLI keeps its own.
    assert hp.compute_dtype == "bfloat16"
    assert ModelHParams(**payload["hparams"]).dbof_cluster_size == 128


def test_port_and_chip_smoke_import_nothing_of_jax():
    """Every module of the port, and chip_smoke.py as a module, in a fresh
    interpreter: neither JAX, flax, orbax nor yt8m_tpu gets imported, and
    no source names them."""
    pkg = REPO / "yt8m_tpu_torch"
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in pkg.rglob("*.py")
    )
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'optax', 'yt8m_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "yt8m_tpu_torch.kernels.dbof" in modules
    for path in list(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]:
        text = path.read_text()
        for needle in ("import jax", "from jax", "import flax", "from flax",
                       "import orbax", "from orbax",
                       "yt8m_tpu."):
            assert needle not in text, f"{path} names {needle!r}"
