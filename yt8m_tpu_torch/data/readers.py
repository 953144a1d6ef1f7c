"""YT-8M record -> batch readers (reference: readers.py).

A copy of the JAX package's pure-Python reader (its shuffling, epochs,
seed and remainder options; no distillation feature):
  * YT8MAggregatedFeatureReader: video-level tf.Example with float features
    (`mean_rgb`[1024], `mean_audio`[128]) concatenated per --feature_names,
    labels -> dense multi-hot over 4716 classes.
  * YT8MFrameFeatureReader: frame-level tf.SequenceExample; per-frame bytes
    decoded as uint8, `resize_axis` pad/truncate to max_frames=300,
    num_frames = min(len, 300) returned for masking. Dequantization happens
    on the device (uint8 stays on the wire).

Output batch dict (numpy, host side):
    video level: {"id": list[bytes], "features": f32 [B, D],
                  "labels": f32 [B, C], "num_frames": i32 [B] (=1),
                  "batch_mask": f32 [B]}
    frame level: {"id": list[bytes], "features": u8 [B, F, D],
                  "labels": f32 [B, C], "num_frames": i32 [B],
                  "batch_mask": f32 [B]}
`batch_mask` marks real rows in a padded final batch (eval and inference
need every video exactly once).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from yt8m_tpu_torch.data import proto
from yt8m_tpu_torch.data.features import (
    MAX_FRAMES,
    NUM_CLASSES,
    get_feature_names_and_sizes,
)
from yt8m_tpu_torch.data.tfrecord import glob_files, tfrecord_iterator


@dataclasses.dataclass
class ReaderConfig:
    feature_names: str
    feature_sizes: str
    frame_features: bool
    num_classes: int = NUM_CLASSES
    max_frames: int = MAX_FRAMES

    @property
    def names_and_sizes(self):
        return get_feature_names_and_sizes(self.feature_names, self.feature_sizes)

    @property
    def feature_dim(self) -> int:
        _, sizes = self.names_and_sizes
        return sum(sizes)


def _labels_from_feature(feat) -> List[int]:
    if feat is None:
        return []
    kind, values = feat
    return [int(v) for v in values]


def _video_id(features) -> bytes:
    vid = features.get("id", features.get("video_id", ("bytes", [b""])))[1]
    return vid[0] if vid else b""


def parse_video_example(buf: bytes, config: ReaderConfig):
    """One video-level tf.Example -> (id, features f32 [D], labels)."""
    feats = proto.decode_example(buf)
    names, sizes = config.names_and_sizes
    parts = []
    for name, size in zip(names, sizes):
        kind, values = feats[name]
        arr = np.asarray(values, dtype=np.float32)
        if arr.shape[0] != size:
            raise ValueError(
                f"feature {name!r}: got {arr.shape[0]} values, want {size}"
            )
        parts.append(arr)
    labels = _labels_from_feature(feats.get("labels"))
    return _video_id(feats), np.concatenate(parts), labels


def parse_frame_sequence_example(buf: bytes, config: ReaderConfig):
    """One SequenceExample -> (id, u8 [max_frames, D], num_frames, labels).

    Mirrors readers.py :: YT8MFrameFeatureReader.prepare_serialized_examples:
    decode_raw(uint8) per frame, resize_axis to max_frames (zero pad or
    truncate), num_frames clipped to max_frames.
    """
    context, feature_lists = proto.decode_sequence_example(buf)
    names, sizes = config.names_and_sizes
    max_frames = config.max_frames

    num_frames_raw = None
    per_feature: List[np.ndarray] = []
    for name, size in zip(names, sizes):
        frames = feature_lists.get(name, [])
        if num_frames_raw is None:
            num_frames_raw = len(frames)
        arr = np.zeros((max_frames, size), dtype=np.uint8)
        for t, feat in enumerate(frames[:max_frames]):
            kind, values = feat
            raw = np.frombuffer(values[0], dtype=np.uint8)
            if raw.shape[0] != size:
                raise ValueError(
                    f"feature_list {name!r} frame {t}: {raw.shape[0]} bytes,"
                    f" want {size}"
                )
            arr[t] = raw
        per_feature.append(arr)

    features = np.concatenate(per_feature, axis=1)
    num_frames = min(int(num_frames_raw or 0), max_frames)
    labels = _labels_from_feature(context.get("labels"))
    return _video_id(context), features, num_frames, labels


def _dense_labels(label_lists: Sequence[Sequence[int]], num_classes: int):
    out = np.zeros((len(label_lists), num_classes), dtype=np.float32)
    for i, labels in enumerate(label_lists):
        for c in labels:
            if 0 <= c < num_classes:
                out[i, c] = 1.0
    return out


class BatchIterator:
    """Batches from TFRecord shards (the JAX package's pure-Python
    BatchIterator, data/readers.py:160-260).

    Unshuffled: file order, each video once per epoch. Shuffled: the file
    list is shuffled each epoch by numpy's default_rng(seed), and records
    pass through a reservoir of 4 * batch_size drawn by
    default_rng(seed + 1); the same seed gives the JAX iterator's batches
    in its order. num_epochs=None repeats forever. The native C++ parser
    of the JAX package is not ported.
    """

    def __init__(self, file_pattern, config: ReaderConfig, batch_size: int,
                 shuffle: bool = False, num_epochs: Optional[int] = 1,
                 seed: int = 0, pad_final_batch: bool = True,
                 drop_remainder: bool = False):
        if isinstance(file_pattern, str):
            self.files = glob_files(file_pattern)
        else:
            self.files = list(file_pattern)
        if not self.files:
            raise IOError(f"no files matched {file_pattern!r}")
        self.config = config
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_epochs = num_epochs
        self.seed = seed
        self.pad_final_batch = pad_final_batch
        self.drop_remainder = drop_remainder

    def _records(self) -> Iterator[bytes]:
        epoch = 0
        rng = np.random.default_rng(self.seed)
        while self.num_epochs is None or epoch < self.num_epochs:
            files = list(self.files)
            if self.shuffle:
                rng.shuffle(files)
            for path in files:
                yield from tfrecord_iterator(path)
            epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        buf = []
        records = self._records()
        if self.shuffle:
            rng = np.random.default_rng(self.seed + 1)
            pool: List[bytes] = []
            pool_size = 4 * self.batch_size
            for rec in records:
                pool.append(rec)
                if len(pool) >= pool_size:
                    idx = int(rng.integers(0, len(pool)))
                    rec, pool[idx] = pool[idx], pool[-1]
                    pool.pop()
                    buf.append(self._parse(rec))
                    if len(buf) == self.batch_size:
                        yield self._make_batch(buf)
                        buf = []
            rng.shuffle(pool)
            records = pool
        for rec in records:
            buf.append(self._parse(rec))
            if len(buf) == self.batch_size:
                yield self._make_batch(buf)
                buf = []
        if buf and not self.drop_remainder:
            yield self._make_batch(buf)

    def _parse(self, rec: bytes):
        if self.config.frame_features:
            return parse_frame_sequence_example(rec, self.config)
        return parse_video_example(rec, self.config)

    def _make_batch(self, rows) -> Dict[str, np.ndarray]:
        cfg = self.config
        n = len(rows)
        bsz = self.batch_size if (self.pad_final_batch and n < self.batch_size) else n
        batch_mask = np.zeros((bsz,), dtype=np.float32)
        batch_mask[:n] = 1.0
        ids: List[bytes] = [b""] * bsz
        label_lists = []
        if cfg.frame_features:
            feats = np.zeros(
                (bsz, cfg.max_frames, cfg.feature_dim), dtype=np.uint8
            )
            num_frames = np.zeros((bsz,), dtype=np.int32)
            for i, (vid, x, nf, labels) in enumerate(rows):
                ids[i] = vid
                feats[i] = x
                num_frames[i] = nf
                label_lists.append(labels)
        else:
            feats = np.zeros((bsz, cfg.feature_dim), dtype=np.float32)
            num_frames = np.ones((bsz,), dtype=np.int32)
            for i, (vid, x, labels) in enumerate(rows):
                ids[i] = vid
                feats[i] = x
                label_lists.append(labels)
        label_lists += [[]] * (bsz - n)
        return {
            "id": ids,
            "features": feats,
            "labels": _dense_labels(label_lists, cfg.num_classes),
            "num_frames": num_frames,
            "batch_mask": batch_mask,
        }
