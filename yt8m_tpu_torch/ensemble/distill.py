"""Distillation data preparation (a copy of the JAX package's
ensemble/distill.py):
write the teacher ensemble's per-video predictions back into the training
TFRecords so a student can train on
  alpha * CE(labels) + (1 - alpha) * CE(teacher)
(see train/losses.py :: MixedCrossEntropyDistillLoss; the reader exposes
the extra feature as batch["teacher"]).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from yt8m_tpu_torch.data import proto
from yt8m_tpu_torch.data.tfrecord import (
    glob_files,
    tfrecord_iterator,
    write_tfrecords,
)

TEACHER_FEATURE = "predictions"


def write_distill_dataset(
    input_pattern: str,
    teacher: Dict[str, np.ndarray],
    output_dir: str,
    frame_level: bool,
    top_k_sparsify: Optional[int] = None,
) -> int:
    """Copy shards, injecting the teacher predictions as a float feature.

    top_k_sparsify keeps only the top-k teacher probabilities (zeroing the
    rest) to shrink the files, as the fork's pipeline did with top-k dumps.
    Returns the number of videos annotated.
    """
    os.makedirs(output_dir, exist_ok=True)
    n_annotated = 0
    for path in glob_files(input_pattern):
        out_records = []
        for rec in tfrecord_iterator(path):
            if frame_level:
                ctx, fl = proto.decode_sequence_example(rec)
            else:
                ctx = proto.decode_example(rec)
                fl = None
            vid_feat = ctx.get("id", ctx.get("video_id", ("bytes", [b""])))
            vid = (vid_feat[1][0] if vid_feat[1] else b"").decode()
            preds = teacher.get(vid)
            if preds is not None:
                p = np.asarray(preds, dtype=np.float32)
                if top_k_sparsify:
                    k = min(top_k_sparsify, p.shape[0])
                    thresh = np.partition(p, -k)[-k]
                    p = np.where(p >= thresh, p, 0.0)
                ctx[TEACHER_FEATURE] = ("float", p.tolist())
                n_annotated += 1
            if frame_level:
                out_records.append(proto.encode_sequence_example(ctx, fl))
            else:
                out_records.append(proto.encode_example(ctx))
        write_tfrecords(
            os.path.join(output_dir, os.path.basename(path)), out_records
        )
    return n_annotated


def teacher_from_prediction_dir(directory: str) -> Dict[str, np.ndarray]:
    from yt8m_tpu_torch.ensemble.average import load_prediction_dir

    ids, preds = load_prediction_dir(directory)
    return {v: preds[i] for i, v in enumerate(ids)}
