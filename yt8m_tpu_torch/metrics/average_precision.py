"""Streaming (global) average precision.

Reference: average_precision_calculator.py :: AveragePrecisionCalculator.
Semantics preserved exactly, implementation vectorised:

  * ``accumulate(predictions, actuals, num_positives=None)`` streams sparse
    (prediction, actual) pairs; when ``top_n`` is set only the ``top_n``
    highest predictions are retained (reference used a bounded heap; we keep
    chunked arrays and re-truncate lazily — same retained set).
  * ``peek_ap_at_n`` computes interpolated AP
        AP = sum_i I[actual_i > 0] * (poscount_i / i) / num_pos
    over predictions sorted descending, where
    num_pos = min(total_positives, top_n).
  * Tie-breaking: the reference applies random.seed(0); random.sample
    permutation before a stable sort so equal scores are ranked in a fixed
    pseudo-random order. We reproduce that EXACT permutation (stdlib
    random with seed 0), so AP matches the reference bit-for-bit even
    when scores contain exact ties.

A numpy copy of the JAX package's metrics/average_precision.py, so that
the port imports nothing of that package.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def ap_at_n(
    predictions,
    actuals,
    n: Optional[int] = 20,
    total_num_positives: Optional[int] = None,
) -> float:
    """AP of the ranked list, truncated at n (None = full list)."""
    predictions = np.asarray(predictions, dtype=np.float64)
    actuals = np.asarray(actuals, dtype=np.float64)
    if predictions.shape != actuals.shape or predictions.ndim != 1:
        raise ValueError("predictions and actuals must be 1-D and same size")
    if predictions.size == 0:
        return 0.0

    # Fixed pseudo-random permutation for tie-breaking — the reference's
    # _shuffle: random.seed(0); random.sample(range(n), n). Reproduced
    # exactly so ties rank identically.
    perm = np.asarray(
        random.Random(0).sample(range(predictions.size), predictions.size)
    )
    predictions = predictions[perm]
    actuals = actuals[perm]

    sortidx = np.argsort(-predictions, kind="stable")

    if total_num_positives is None:
        numpos = int(np.sum(actuals > 0))
    else:
        numpos = int(total_num_positives)
    if numpos == 0:
        return 0.0
    if n is not None:
        numpos = min(numpos, n)

    r = sortidx.size if n is None else min(sortidx.size, n)
    ranked = actuals[sortidx[:r]] > 0
    poscount = np.cumsum(ranked)
    ranks = np.arange(1, r + 1)
    ap = float(np.sum((poscount[ranked] / ranks[ranked])) / numpos)
    return ap


class AveragePrecisionCalculator:
    """Streaming AP accumulator (sparse pairs across many batches)."""

    def __init__(self, top_n: Optional[int] = None):
        if not (top_n is None or (isinstance(top_n, int) and top_n >= 0)):
            raise ValueError("top_n must be a non-negative integer or None.")
        self._top_n = top_n
        self._total_positives = 0
        self._pred_chunks = []
        self._act_chunks = []
        self._retained = 0

    @property
    def heap_size(self) -> int:
        return self._retained

    @property
    def num_accumulated_positives(self) -> int:
        return self._total_positives

    def accumulate(self, predictions, actuals, num_positives=None) -> None:
        predictions = np.asarray(predictions, dtype=np.float64).ravel()
        actuals = np.asarray(actuals, dtype=np.float64).ravel()
        if predictions.size != actuals.size:
            raise ValueError("predictions and actuals size mismatch")
        if num_positives is not None:
            self._total_positives += int(num_positives)
        else:
            self._total_positives += int(np.sum(actuals > 0))
        self._pred_chunks.append(predictions)
        self._act_chunks.append(actuals)
        self._retained += predictions.size
        if self._top_n is not None and self._retained > 4 * max(
            self._top_n, 1024
        ):
            self._truncate()

    def _truncate(self) -> None:
        if self._top_n is None:
            return
        preds = np.concatenate(self._pred_chunks)
        acts = np.concatenate(self._act_chunks)
        if preds.size > self._top_n:
            keep = np.argpartition(-preds, self._top_n - 1)[: self._top_n]
            preds, acts = preds[keep], acts[keep]
        self._pred_chunks, self._act_chunks = [preds], [acts]
        self._retained = preds.size

    def clear(self) -> None:
        self._total_positives = 0
        self._pred_chunks, self._act_chunks = [], []
        self._retained = 0

    def peek_ap_at_n(self) -> float:
        if self._retained <= 0:
            return 0.0
        self._truncate()
        preds = np.concatenate(self._pred_chunks)
        acts = np.concatenate(self._act_chunks)
        return ap_at_n(
            preds,
            acts,
            n=self._top_n,
            total_num_positives=self._total_positives,
        )
