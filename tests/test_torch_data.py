"""The port's data modules (yt8m_tpu_torch/data) against the JAX
package's: the same files give byte-identical batches, the port's writer
gives files the JAX reader reads (byte-identical to the JAX writer's),
and the codec pieces agree exactly."""

import importlib
import os

import numpy as np
import pytest

from yt8m_tpu.data import crc32c as jcrc
from yt8m_tpu.data import proto as jproto
from yt8m_tpu.data import readers as jreaders
from yt8m_tpu.data import synthetic as jsynth
from yt8m_tpu_torch.data import crc32c as tcrc
from yt8m_tpu_torch.data import proto as tproto
from yt8m_tpu_torch.data import quantize as tquant
from yt8m_tpu_torch.data import readers as treaders
from yt8m_tpu_torch.data import synthetic as tsynth

# yt8m_tpu.data re-exports the function `quantize` under the module's name.
jquant = importlib.import_module("yt8m_tpu.data.quantize")

FRAME = dict(frame_level=True, num_classes=50, rgb_dim=24, audio_dim=8,
             max_frames=40)
VIDEO = dict(frame_level=False, num_classes=50, rgb_dim=24, audio_dim=8)


def _config(mod, frame_level):
    if frame_level:
        return mod.ReaderConfig("rgb,audio", "24,8", frame_features=True,
                                num_classes=50, max_frames=40)
    return mod.ReaderConfig("mean_rgb,mean_audio", "24,8",
                            frame_features=False, num_classes=50)


def _batches(mod, pattern, frame_level, batch_size):
    return list(mod.BatchIterator(pattern, _config(mod, frame_level),
                                  batch_size=batch_size))


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        assert g["id"] == w["id"]
        for key in ("features", "labels", "num_frames", "batch_mask"):
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.parametrize("kw", [FRAME, VIDEO], ids=["frame", "video"])
@pytest.mark.parametrize("batch_size", [4, 7])
def test_port_reader_gives_identical_batches_on_jax_fixture(
        tmp_path, kw, batch_size):
    jsynth.write_dataset(str(tmp_path), "test", num_shards=2,
                         videos_per_shard=6, seed=2, **kw)
    pattern = os.path.join(str(tmp_path), "test-*.tfrecord")
    frame_level = kw["frame_level"]
    got = _batches(treaders, pattern, frame_level, batch_size)
    want = _batches(jreaders, pattern, frame_level, batch_size)
    _assert_same_batches(got, want)
    if frame_level:
        assert got[0]["features"].dtype == np.uint8
        assert got[0]["features"].shape == (batch_size, 40, 32)
        assert got[0]["num_frames"].dtype == np.int32


@pytest.mark.parametrize("kw", [FRAME, VIDEO], ids=["frame", "video"])
def test_port_writer_files_read_back_by_jax_reader(tmp_path, kw):
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tpaths = tsynth.write_dataset(str(tdir), "train", num_shards=2,
                                  videos_per_shard=5, seed=4, **kw)
    jpaths = jsynth.write_dataset(str(jdir), "train", num_shards=2,
                                  videos_per_shard=5, seed=4, **kw)
    for tp, jp in zip(tpaths, jpaths):
        with open(tp, "rb") as a, open(jp, "rb") as b:
            assert a.read() == b.read()
    frame_level = kw["frame_level"]
    got = _batches(jreaders, os.path.join(str(tdir), "train-*.tfrecord"),
                   frame_level, 4)
    want = _batches(treaders, os.path.join(str(tdir), "train-*.tfrecord"),
                    frame_level, 4)
    _assert_same_batches(got, want)


def test_frame_reader_pads_and_truncates_like_jax():
    rng = np.random.default_rng(0)
    for n_frames in (0, 1, 39, 40, 41, 55):
        frames = [("bytes", [rng.integers(0, 256, 24, np.uint8).tobytes()])
                  for _ in range(n_frames)]
        audio = [("bytes", [rng.integers(0, 256, 8, np.uint8).tobytes()])
                 for _ in range(n_frames)]
        rec = jproto.encode_sequence_example(
            {"id": ("bytes", [b"v"]), "labels": ("int64", [3, 49])},
            {"rgb": frames, "audio": audio})
        got = treaders.parse_frame_sequence_example(
            rec, _config(treaders, True))
        want = jreaders.parse_frame_sequence_example(
            rec, _config(jreaders, True))
        assert got[0] == want[0] and got[2] == want[2] and got[3] == want[3]
        np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("n", [0, 1, 7, 64, 1000])
def test_crc32c_matches_jax(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert tcrc.masked_crc32c(data) == jcrc.masked_crc32c(data)
    assert tcrc.crc32c(data) == jcrc.crc32c(data)


def test_proto_codec_matches_jax():
    feats = {"id": ("bytes", [b"abc"]), "labels": ("int64", [1, -2, 2**40]),
             "mean_rgb": ("float", [0.5, -1.25, 3.0])}
    assert tproto.encode_example(feats) == jproto.encode_example(feats)
    assert tproto.decode_example(jproto.encode_example(feats)) == \
        jproto.decode_example(jproto.encode_example(feats))


def test_dequantize_matches_jax():
    x = np.arange(256, dtype=np.float32)
    np.testing.assert_array_equal(tquant.dequantize(x), jquant.dequantize(x))
    assert tquant.DEQUANT_SCALE == jquant.DEQUANT_SCALE
    assert tquant.DEQUANT_BIAS == jquant.DEQUANT_BIAS
    y = np.linspace(-3, 3, 101)
    np.testing.assert_array_equal(tquant.quantize(y), jquant.quantize(y))
