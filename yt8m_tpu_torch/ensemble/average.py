"""Prediction-file ensembling (reference: fork ensemble scripts +
inference-pre-ensemble.py; a copy of the JAX package's
ensemble/average.py).

Members dump dense probabilities per video (np.savez chunks from
infer.predict with --output_probabilities_dir); this module aligns them by
video id, fits/applies ensemble weights, and writes the final CSV.
Checkpoint ensembling = same averaging over dumps from several checkpoints
of one run.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from yt8m_tpu_torch.metrics import calculate_gap


def load_prediction_dir(directory: str) -> Tuple[List[str], np.ndarray]:
    """Concatenate predictions-*.npz chunks -> (ids, [N, C] float32).

    Accepts both dump formats written by infer.predict: dense chunks
    (`predictions` [n, C]) and sparse top-N chunks (`values`/`indices`
    [n, k] + `num_classes`, --output_probabilities_topk); sparse chunks
    densify with zeros for the untracked classes (fork semantics).
    """
    paths = sorted(glob.glob(os.path.join(directory, "predictions-*.npz")))
    if not paths:
        raise IOError(f"no prediction chunks in {directory}")
    ids: List[str] = []
    preds = []
    for p in paths:
        with np.load(p, allow_pickle=False) as z:
            ids.extend(z["ids"].tolist())
            if "predictions" in z:
                preds.append(z["predictions"].astype(np.float32))
            else:
                values = z["values"].astype(np.float32)
                indices = z["indices"].astype(np.int64)
                dense = np.zeros(
                    (values.shape[0], int(z["num_classes"])), np.float32
                )
                np.put_along_axis(dense, indices, values, axis=1)
                preds.append(dense)
    return ids, np.concatenate(preds, axis=0)


def align_members(
    members: Sequence[Tuple[List[str], np.ndarray]],
) -> Tuple[List[str], List[np.ndarray]]:
    """Re-order every member's rows to the first member's video-id order."""
    base_ids = members[0][0]
    index = {v: i for i, v in enumerate(base_ids)}
    aligned = [members[0][1]]
    for ids, preds in members[1:]:
        if ids == base_ids:
            aligned.append(preds)
            continue
        perm = np.full(len(base_ids), -1, dtype=np.int64)
        for row, vid in enumerate(ids):
            j = index.get(vid)
            if j is not None:
                perm[j] = row
        if np.any(perm < 0):
            missing = sum(perm < 0)
            raise ValueError(f"member missing {missing} videos")
        aligned.append(preds[perm])
    return base_ids, aligned


def weighted_average(
    preds: Sequence[np.ndarray], weights: Optional[Sequence[float]] = None
) -> np.ndarray:
    if weights is None:
        weights = [1.0] * len(preds)
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    out = np.zeros_like(preds[0], dtype=np.float64)
    for wi, p in zip(w, preds):
        out += wi * p
    return out.astype(np.float32)


def fit_weights_by_gap(
    preds: Sequence[np.ndarray],
    labels: np.ndarray,
    top_k: int = 20,
    iterations: int = 2,
    grid: Sequence[float] = (0.0, 0.25, 0.5, 0.75, 1.0, 1.5, 2.0),
) -> List[float]:
    """Coordinate-ascent weight fit on validate GAP (the reference tuned
    weights by hand or regression on validate)."""
    n = len(preds)
    weights = [1.0] * n
    for _ in range(iterations):
        for i in range(n):
            best_w, best_gap = weights[i], -1.0
            for w in grid:
                trial = list(weights)
                trial[i] = w
                if sum(trial) == 0:
                    continue
                gap = calculate_gap(
                    weighted_average(preds, trial), labels, top_k
                )
                if gap > best_gap:
                    best_gap, best_w = gap, w
            weights[i] = best_w
    return weights


def labels_from_tfrecords(
    file_pattern: str, frame_level: bool, num_classes: int
) -> Dict[str, np.ndarray]:
    """Ground-truth dense labels keyed by video id (for weight fitting)."""
    from yt8m_tpu_torch.data import proto
    from yt8m_tpu_torch.data.tfrecord import glob_files, tfrecord_iterator

    out: Dict[str, np.ndarray] = {}
    for path in glob_files(file_pattern):
        for rec in tfrecord_iterator(path):
            if frame_level:
                ctx, _ = proto.decode_sequence_example(rec)
            else:
                ctx = proto.decode_example(rec)
            vid = ctx.get("id", ctx.get("video_id", ("bytes", [b""])))[1]
            vid = (vid[0] if vid else b"").decode()
            dense = np.zeros((num_classes,), dtype=np.float32)
            for c in ctx.get("labels", ("int64", []))[1]:
                if 0 <= c < num_classes:
                    dense[int(c)] = 1.0
            out[vid] = dense
    return out


def ensemble_directories(
    member_dirs: Sequence[str],
    weights: Optional[Sequence[float]] = None,
    output_csv: Optional[str] = None,
    top_k: int = 20,
) -> Tuple[List[str], np.ndarray]:
    """Average member dumps; optionally write the Kaggle CSV."""
    members = [load_prediction_dir(d) for d in member_dirs]
    ids, aligned = align_members(members)
    avg = weighted_average(aligned, weights)
    if output_csv:
        from yt8m_tpu_torch.data.pipeline import format_lines

        k = min(top_k, avg.shape[1])
        part = np.argpartition(-avg, k - 1, axis=1)[:, :k]
        rows = np.arange(avg.shape[0])[:, None]
        with open(output_csv, "w") as f:
            f.write("VideoId,LabelConfidencePairs\n")
            f.writelines(
                format_lines(ids, avg[rows, part], part.astype(np.int32))
            )
    return ids, avg
