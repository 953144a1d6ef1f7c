"""Synthetic YT-8M fixture generator.

A copy of the JAX package's writer (without its label-dropout option):
the same arguments give byte-identical files. The reference repo ships no
test data; these shards are wire-format-identical synthetic YT-8M records
(video-level tf.Example and frame-level tf.SequenceExample) with a
*planted label signal*.

Field layout matches the public YT-8M dataset:
  video-level Example features:
      id        : bytes[1]
      labels    : int64 list (subset of [0, num_classes))
      mean_rgb  : float[1024]
      mean_audio: float[128]
  frame-level SequenceExample:
      context  { id: bytes[1], labels: int64 list }
      feature_lists {
          rgb  : one bytes entry per frame, each 1024 uint8 (quantized)
          audio: one bytes entry per frame, each 128 uint8
      }
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from yt8m_tpu_torch.data.proto import encode_example, encode_sequence_example
from yt8m_tpu_torch.data.quantize import quantize
from yt8m_tpu_torch.data.tfrecord import write_tfrecords


def _planted_features(
    rng: np.random.Generator, labels: np.ndarray, dim: int, num_classes: int
) -> np.ndarray:
    """Draw a feature vector whose direction weakly encodes the labels.

    Each class c gets a fixed pseudo-random unit direction (seeded by c);
    the video's clean feature is the sum of its label directions plus noise.
    """
    x = rng.normal(0.0, 0.6, size=(dim,))
    for c in labels:
        class_rng = np.random.default_rng(1000 + int(c))
        direction = class_rng.normal(0.0, 1.0, size=(dim,))
        direction /= np.linalg.norm(direction) + 1e-8
        x += 1.5 * direction
    return x.astype(np.float32)


def _random_labels(
    rng: np.random.Generator, num_classes: int, max_labels: int
) -> np.ndarray:
    k = int(rng.integers(1, max_labels + 1))
    # Zipf-ish skew like the real vocabulary: low class ids more frequent.
    raw = rng.zipf(1.3, size=4 * k) - 1
    labels = np.unique(raw[raw < num_classes])[:k]
    if labels.size == 0:
        labels = np.array([int(rng.integers(0, num_classes))])
    return labels.astype(np.int64)


def write_video_level_shard(
    path: str,
    num_videos: int,
    num_classes: int = 4716,
    rgb_dim: int = 1024,
    audio_dim: int = 128,
    max_labels: int = 4,
    seed: int = 0,
) -> List[bytes]:
    """Write one video-level tf.Example shard; returns the video ids."""
    rng = np.random.default_rng(seed)
    ids, records = [], []
    for i in range(num_videos):
        vid = f"vid{seed:02d}_{i:05d}".encode()
        labels = _random_labels(rng, num_classes, max_labels)
        mean_rgb = _planted_features(rng, labels, rgb_dim, num_classes)
        mean_audio = _planted_features(rng, labels, audio_dim, num_classes)
        records.append(
            encode_example(
                {
                    "id": ("bytes", [vid]),
                    "labels": ("int64", labels.tolist()),
                    "mean_rgb": ("float", mean_rgb.tolist()),
                    "mean_audio": ("float", mean_audio.tolist()),
                }
            )
        )
        ids.append(vid)
    write_tfrecords(path, records)
    return ids


def write_frame_level_shard(
    path: str,
    num_videos: int,
    num_classes: int = 4716,
    rgb_dim: int = 1024,
    audio_dim: int = 128,
    max_frames: int = 300,
    min_frames: int = 8,
    max_labels: int = 4,
    seed: int = 0,
) -> List[Tuple[bytes, int]]:
    """Write one frame-level tf.SequenceExample shard.

    Returns [(video_id, num_frames)] for test assertions.
    """
    rng = np.random.default_rng(seed)
    meta, records = [], []
    for i in range(num_videos):
        vid = f"vid{seed:02d}_{i:05d}".encode()
        labels = _random_labels(rng, num_classes, max_labels)
        n_frames = int(rng.integers(min_frames, max_frames + 1))
        base_rgb = _planted_features(rng, labels, rgb_dim, num_classes)
        base_audio = _planted_features(rng, labels, audio_dim, num_classes)
        # Vectorized over frames (the per-frame loop was ~29 videos/s at
        # 300x1152; this is ~10x, making 50k-video soak fixtures
        # practical). Same noise distribution/planted signal as before.
        q_rgb = quantize(
            base_rgb[None, :] + rng.normal(0.0, 0.3, size=(n_frames, rgb_dim))
        )
        q_audio = quantize(
            base_audio[None, :]
            + rng.normal(0.0, 0.3, size=(n_frames, audio_dim))
        )
        rgb_frames = [
            ("bytes", [q_rgb[f].tobytes()]) for f in range(n_frames)
        ]
        audio_frames = [
            ("bytes", [q_audio[f].tobytes()]) for f in range(n_frames)
        ]
        records.append(
            encode_sequence_example(
                context={
                    "id": ("bytes", [vid]),
                    "labels": ("int64", labels.tolist()),
                },
                feature_lists={"rgb": rgb_frames, "audio": audio_frames},
            )
        )
        meta.append((vid, n_frames))
    write_tfrecords(path, records)
    return meta


def write_dataset(
    out_dir: str,
    split: str = "train",
    num_shards: int = 2,
    videos_per_shard: int = 32,
    frame_level: bool = False,
    num_classes: int = 4716,
    seed: int = 0,
    **kw,
):
    """Write `<split>-NNNN.tfrecord` shards; returns list of paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for s in range(num_shards):
        path = os.path.join(out_dir, f"{split}-{s:04d}.tfrecord")
        if frame_level:
            write_frame_level_shard(
                path, videos_per_shard, num_classes=num_classes,
                seed=seed * 1000 + s, **kw,
            )
        else:
            write_video_level_shard(
                path, videos_per_shard, num_classes=num_classes,
                seed=seed * 1000 + s, **kw,
            )
        paths.append(path)
    return paths
