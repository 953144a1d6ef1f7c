"""The port's native input pipeline (yt8m_tpu_torch/data/pipeline.py)
against the JAX package's (yt8m_tpu/data/pipeline.py), on the same
synthetic shards made from numpy seeds.

Tolerances: none. Both drive the same C++ parser (cpp/yt8m_io.cc) with
the same numpy generators, so batches are equal element for element and
in order; the CSV formatter's output is equal byte for byte. Also the
trainer's reader (it reads through make_batch_iterator: a shuffled run
gets the JAX trainer's batches), the fallback to the Python reader, the
fan-out readers' coverage and the library's one build under concurrent
first use.
"""

import logging
import os
import threading

import numpy as np
import pytest

from yt8m_tpu.data import pipeline as jax_pipeline
from yt8m_tpu.data.readers import ReaderConfig as JaxReaderConfig
from yt8m_tpu.infer.predict import format_lines_text as jax_format_text
from yt8m_tpu_torch.data import pipeline
from yt8m_tpu_torch.data.proto import encode_example
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.data.tfrecord import write_tfrecords

C, D_RGB, D_AUDIO, MAXF = 12, 12, 4, 20
KEYS = ("features", "labels", "num_frames", "batch_mask")

needs_native = pytest.mark.skipif(
    jax_pipeline.get_native_lib() is None or pipeline.get_native_lib() is None,
    reason="g++ cannot build cpp/yt8m_io.cc here")


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("pipeline_data")
    write_dataset(str(root), "frames", num_shards=3, videos_per_shard=7,
                  frame_level=True, num_classes=C, seed=2, rgb_dim=D_RGB,
                  audio_dim=D_AUDIO, max_frames=2 * MAXF, min_frames=1)
    write_dataset(str(root), "videos", num_shards=3, videos_per_shard=6,
                  frame_level=False, num_classes=C, seed=3, rgb_dim=D_RGB,
                  audio_dim=D_AUDIO)
    return str(root)


def _configs(frame_level, **kw):
    names = "rgb,audio" if frame_level else "mean_rgb,mean_audio"
    sizes = f"{D_RGB},{D_AUDIO}"
    return (ReaderConfig(names, sizes, frame_level, num_classes=C,
                         max_frames=MAXF, **kw),
            JaxReaderConfig(names, sizes, frame_level, num_classes=C,
                            max_frames=MAXF, **kw))


def assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["id"] == w["id"]
        assert set(g) == set(w)
        for key in set(g) - {"id"}:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@needs_native
@pytest.mark.parametrize("frame_level", [True, False])
@pytest.mark.parametrize("kw", [
    dict(shuffle=True, num_epochs=2, seed=7),
    dict(shuffle=False, num_epochs=1, drop_remainder=True),
    dict(shuffle=True, num_epochs=2, seed=0, pad_final_batch=False,
         prefetch=0),
])
def test_native_batches_equal_the_jax_native_batches(shards, frame_level,
                                                     kw):
    pattern = os.path.join(shards, ("frames" if frame_level else "videos")
                           + "-*.tfrecord")
    rc, jrc = _configs(frame_level)
    got = pipeline.make_batch_iterator(pattern, rc, 4, **kw)
    want = jax_pipeline.make_batch_iterator(pattern, jrc, 4, **kw)
    assert isinstance(got, pipeline.NativeBatchIterator)
    assert isinstance(want, jax_pipeline.NativeBatchIterator)
    got, want = list(got), list(want)
    assert_same_batches(got, want)
    if frame_level and kw.get("pad_final_batch", True):
        # padded rows report 0 frames at frame level
        last = got[-1]
        assert np.all(last["num_frames"][last["batch_mask"] == 0] == 0)
    if not frame_level:
        assert np.all(got[-1]["num_frames"] == 1)


def _wide_label_shard(path, num_classes, seed):
    """Video-level records with a teacher feature, one of them with 150
    labels (past the 64-a-video budget), ids `w<seed>_<i>`."""
    rng = np.random.default_rng(seed)
    records = []
    for i in range(5):
        n = 150 if i == 1 else int(rng.integers(1, 5))
        labels = rng.choice(num_classes, size=n, replace=False)
        records.append(encode_example({
            "id": ("bytes", [f"w{seed}_{i}".encode()]),
            "labels": ("int64", sorted(labels.tolist())),
            "mean_rgb": ("float", rng.normal(size=D_RGB).tolist()),
            "mean_audio": ("float", rng.normal(size=D_AUDIO).tolist()),
            "predictions": ("float",
                            rng.random(num_classes).astype(np.float32)
                            .tolist()),
        }))
    write_tfrecords(path, records)


@needs_native
def test_teacher_and_labels_past_the_budget_match_jax(tmp_path, caplog):
    classes = 200
    for s in range(2):
        _wide_label_shard(str(tmp_path / f"wide-{s}.tfrecord"), classes, s)
    pattern = str(tmp_path / "wide-*.tfrecord")
    kw = dict(feature_names="mean_rgb,mean_audio",
              feature_sizes=f"{D_RGB},{D_AUDIO}", frame_features=False,
              num_classes=classes, distill_feature="predictions",
              distill_dim=classes)
    rc, jrc = ReaderConfig(**kw), JaxReaderConfig(**kw)
    with caplog.at_level(logging.WARNING):
        # batch 2: a budget of 128 label slots, which the 150 overflow
        got = list(pipeline.make_batch_iterator(pattern, rc, 2, seed=1,
                                                shuffle=True, num_epochs=2))
    port_warnings = [r.getMessage() for r in caplog.records
                     if r.name == "yt8m_tpu_torch.data"]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        want = list(jax_pipeline.make_batch_iterator(
            pattern, jrc, 2, seed=1, shuffle=True, num_epochs=2))
    jax_warnings = [r.getMessage() for r in caplog.records
                    if r.name == "yt8m_tpu.data"]
    assert_same_batches(got, want)
    assert "teacher" in got[0] and got[0]["teacher"].shape == (2, classes)
    assert port_warnings == jax_warnings
    assert len(port_warnings) == 2  # one an epoch
    assert "labels exceeded the batch label budget" in port_warnings[0]
    # Below the budget every label arrives, as in the Python reader.
    python = list(BatchIterator(pattern, rc, 8))
    native = list(pipeline.make_batch_iterator(pattern, rc, 8))
    assert_same_batches(native, python)
    assert python[0]["labels"][1].sum() == 150


@needs_native
def test_fanout_readers_cover_every_video_once(shards):
    pattern = os.path.join(shards, "videos-*.tfrecord")
    rc, _ = _configs(False)
    want = {}
    for b in pipeline.make_batch_iterator(pattern, rc, 4, prefetch=0):
        for i, (vid, m) in enumerate(zip(b["id"], b["batch_mask"])):
            if m:
                want[vid] = (b["features"][i].copy(), b["labels"][i].copy())
    for kind, kw in (("threaded", dict(num_readers=3)),
                     ("processes", dict(num_readers=2,
                                        reader_processes=True))):
        it = pipeline.make_batch_iterator(pattern, rc, 4, **kw)
        assert pipeline.reader_kind(it) == kind
        seen = [(vid, b["features"][i], b["labels"][i])
                for b in it
                for i, (vid, m) in enumerate(zip(b["id"], b["batch_mask"]))
                if m]
        assert sorted(v for v, _, _ in seen) == sorted(want)
        for vid, feats, labels in seen:
            np.testing.assert_array_equal(feats, want[vid][0])
            np.testing.assert_array_equal(labels, want[vid][1])


@needs_native
def test_csv_formatter_matches_jax_byte_for_byte():
    rng = np.random.default_rng(3)
    n, k = 37, 20
    vals = rng.random((n, k)).astype(np.float32)
    vals[0, :] = 0.25          # all ties: the stable order
    vals[1, :5] = 1e-7         # %g's exponent notation
    vals[2, 0] = 0.0
    vals[3, 3] = 123456.789
    idxs = rng.integers(0, 4716, (n, k)).astype(np.int32)
    ids = [f"vid{i:08d}".encode() for i in range(n)]
    ids[5] = b"s"
    ids[6] = "str_id"
    got = pipeline.format_lines_text(ids, vals, idxs)
    assert got == jax_format_text(ids, vals, idxs)
    assert got == "".join(pipeline.format_lines(ids, vals, idxs))
    assert pipeline.format_lines_text([], vals[:0], idxs[:0]) == ""


def test_trainer_reads_the_jax_trainers_batches(shards, tmp_path):
    """A shuffled training run reads JAX make_batch_iterator's batches
    (the native parser shuffles the file list only; the Python reader's
    record reservoir would reorder them)."""
    from yt8m_tpu_torch.config import TrainConfig
    from yt8m_tpu_torch.models import ModelHParams
    from yt8m_tpu_torch.train.loop import Trainer

    pattern = os.path.join(shards, "frames-*.tfrecord")
    cfg = TrainConfig(
        train_data_pattern=pattern, train_dir=str(tmp_path / "run"),
        batch_size=4, num_epochs=2, seed=11, model="FrameLevelLogisticModel",
        feature_names="rgb,audio", feature_sizes=f"{D_RGB},{D_AUDIO}",
        frame_features=True, num_classes=C, max_frames=MAXF, device="cpu",
        hparams=ModelHParams(compute_dtype="float32"))
    trainer = Trainer(cfg)
    _, jrc = _configs(True)
    want = jax_pipeline.make_batch_iterator(
        pattern, jrc, batch_size=4, shuffle=True, num_epochs=2, seed=11,
        pad_final_batch=True)
    assert trainer.reader == ("native" if isinstance(
        want, jax_pipeline.NativeBatchIterator) else "python")
    assert_same_batches(list(trainer.data_iterator), list(want))


def test_fallback_is_the_python_reader_with_one_warning(shards, monkeypatch,
                                                        caplog):
    pattern = os.path.join(shards, "frames-*.tfrecord")
    rc, _ = _configs(True)
    monkeypatch.setattr(pipeline, "get_native_lib", lambda: None)
    monkeypatch.setattr(pipeline, "_warned_fallback", False)
    with caplog.at_level(logging.WARNING, logger="yt8m_tpu_torch.data"):
        its = [pipeline.make_batch_iterator(pattern, rc, 4, shuffle=True,
                                            seed=3, prefetch=2,
                                            num_readers=n)
               for n in (1, 4)]
    assert [pipeline.reader_kind(it) for it in its] == ["python", "python"]
    assert len([r for r in caplog.records
                if "pure-Python BatchIterator" in r.getMessage()]) == 1
    assert_same_batches(list(its[0]), list(BatchIterator(
        pattern, rc, 4, shuffle=True, seed=3)))


def test_library_builds_once_under_concurrent_first_use(tmp_path,
                                                        monkeypatch):
    """Threads racing for the first build (each with its own lock file
    handle, as processes have) run the compiler once; the others load the
    renamed file. A failing compiler yields None (the fallback)."""
    monkeypatch.setattr(pipeline, "_LIB_DIR", str(tmp_path / "lib"))
    runs = []
    real_run = pipeline.subprocess.run

    def counting_run(cmd, **kw):
        runs.append(cmd)
        if cmd[0] != "g++":
            return real_run(cmd, **kw)
        # Stand in for the compiler: write the output slowly, so that a
        # reader of a half-written file would see it.
        out = cmd[cmd.index("-o") + 1]
        with open(out, "wb") as f:
            f.write(b"partial")
            threading.Event().wait(0.2)
            f.write(b" library")
        return None

    monkeypatch.setattr(pipeline.subprocess, "run", counting_run)
    results = []
    threads = [threading.Thread(
        target=lambda: results.append(pipeline._build_library()))
        for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    lib = pipeline.library_path()
    assert results == [lib] * 4 and len(runs) == 1
    assert lib.startswith(str(tmp_path / "lib"))
    with open(lib, "rb") as f:
        assert f.read() == b"partial library"
    assert sorted(os.listdir(tmp_path / "lib")) == [".lock",
                                                     os.path.basename(lib)]

    def failing_run(cmd, **kw):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(pipeline, "_LIB_DIR", str(tmp_path / "none"))
    monkeypatch.setattr(pipeline.subprocess, "run", failing_run)
    assert pipeline._build_library() is None
    assert os.listdir(tmp_path / "none") == [".lock"]
