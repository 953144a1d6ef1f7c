"""Bagging data splits (reference: the fork's data-split scripts; a copy
of the JAX package's ensemble/bagging.py). Ensemble members train on
different shard subsets."""

from __future__ import annotations

from typing import List

from yt8m_tpu_torch.data.tfrecord import glob_files


def bag_files(
    file_pattern: str, num_bags: int, bag_index: int, holdout: bool = False
) -> List[str]:
    """Deterministic round-robin bagging of shards.

    holdout=False: bag i gets every shard EXCEPT those = i (mod num_bags) —
    each member sees (num_bags-1)/num_bags of the data, like the fork's
    leave-one-fold-out bagging. holdout=True returns the held-out fold.
    """
    files = glob_files(file_pattern)
    if not files:
        raise IOError(f"no files matched {file_pattern!r}")
    in_fold = [f for i, f in enumerate(files) if i % num_bags == bag_index]
    if holdout:
        return in_fold
    return [f for i, f in enumerate(files) if i % num_bags != bag_index]
