"""Batch evaluation metrics: Hit@1, PERR, GAP@20, mAP.

Reference: eval_util.py :: EvaluationMetrics, calculate_hit_at_one,
calculate_precision_at_equal_recall_rate, calculate_gap, top_k_by_class.
Exact formula port, vectorised (the reference accumulated Python heaps —
the CPU-bound hot loop of its eval, SURVEY.md §3.5).

A numpy copy of the JAX package's metrics/eval_metrics.py, so that the
port imports nothing of that package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from yt8m_tpu_torch.metrics.average_precision import (
    AveragePrecisionCalculator,
    ap_at_n,
)


def calculate_hit_at_one(predictions: np.ndarray, actuals: np.ndarray) -> float:
    """Fraction of videos whose top-scored class is a true label."""
    top = np.argmax(predictions, axis=1)
    hits = actuals[np.arange(actuals.shape[0]), top].astype(np.float64)
    return float(np.mean(hits))


def calculate_precision_at_equal_recall_rate(
    predictions: np.ndarray, actuals: np.ndarray
) -> float:
    """Mean precision@k where k = per-video number of true labels.

    Matches the reference semantics, including its `prediction > 0` guard;
    videos with zero labels contribute 0 (the reference's behaviour there
    is degenerate -[-0:] slicing- and real YT-8M videos always have >=1
    label). Vectorised: one descending sort per batch instead of a Python
    loop of argpartitions (this was the reference eval's CPU hot loop).
    """
    num_videos = actuals.shape[0]
    if num_videos == 0:
        return 0.0
    k = np.sum(actuals > 0, axis=1).astype(np.int64)  # per-video #labels
    kmax = max(int(k.max()), 1)
    rows = np.arange(num_videos)[:, None]
    # Only the top-kmax entries can matter; avoid sorting all C columns.
    # (argpartition at the TOP end is ~10x faster than at the bottom in
    # numpy's introselect, hence -kmax rather than negating.)
    if kmax < predictions.shape[1]:
        part = np.argpartition(predictions, -kmax, axis=1)[:, -kmax:]
    else:
        part = np.broadcast_to(
            np.arange(predictions.shape[1]), predictions.shape
        )
    part_vals = predictions[rows, part]
    inner = np.argsort(-part_vals, axis=1)
    order = part[rows, inner]  # [B, kmax] class ids, descending score
    ranked_hits = (actuals[rows, order] > 0) & (
        predictions[rows, order] > 0
    )
    csum = np.cumsum(ranked_hits, axis=1)
    valid = k > 0
    perr = np.zeros(num_videos, dtype=np.float64)
    kv = np.clip(k, 1, None)
    perr[valid] = (
        csum[np.arange(num_videos), kv - 1][valid] / kv[valid]
    )
    return float(np.mean(perr))


def top_k_triplets(predictions: np.ndarray, labels: np.ndarray, k: int = 20):
    """[(class_index, prediction, label)] for the top-k scored classes."""
    m = predictions.shape[0]
    k = min(k, m)
    indices = np.argpartition(predictions, -k)[-k:]
    return [(int(i), float(predictions[i]), float(labels[i])) for i in indices]


def top_k_by_class(
    predictions: np.ndarray, labels: np.ndarray, k: int = 20
):
    """Sparsify a batch to per-class top-k entries.

    Returns (per-class prediction lists, per-class label lists,
    per-class total positive counts over the FULL label matrix).
    """
    if k <= 0:
        raise ValueError("k must be a positive integer.")
    num_classes = predictions.shape[1]
    k = min(k, num_classes)
    b = predictions.shape[0]

    idx = np.argpartition(predictions, -k, axis=1)[:, -k:]  # [B, k]
    rows = np.arange(b)[:, None]
    preds_k = predictions[rows, idx].ravel()
    labels_k = labels[rows, idx].ravel()
    classes_k = idx.ravel()

    out_predictions: List[List[float]] = [[] for _ in range(num_classes)]
    out_labels: List[List[float]] = [[] for _ in range(num_classes)]
    order = np.argsort(classes_k, kind="stable")
    for j in order:
        c = classes_k[j]
        out_predictions[c].append(float(preds_k[j]))
        out_labels[c].append(float(labels_k[j]))
    out_true_positives = (labels > 0).sum(axis=0).astype(np.int64).tolist()
    return out_predictions, out_labels, out_true_positives


def flatten(lst: Sequence[Sequence]) -> List:
    return [item for sub in lst for item in sub]


def calculate_gap(
    predictions: np.ndarray, actuals: np.ndarray, top_k: int = 20
) -> float:
    """Global AP over the flattened per-video top-k predictions."""
    gap_calculator = AveragePrecisionCalculator()
    sparse_p, sparse_l, num_pos = top_k_by_class(predictions, actuals, top_k)
    gap_calculator.accumulate(
        np.asarray(flatten(sparse_p)),
        np.asarray(flatten(sparse_l)),
        sum(num_pos),
    )
    return gap_calculator.peek_ap_at_n()


class EvaluationMetrics:
    """Streaming eval accumulator; mirror of eval_util.EvaluationMetrics.

    Implementation differs from the reference (which pushed every sparse
    prediction through per-class Python heaps — its eval CPU hot loop,
    SURVEY.md §3.2): batches contribute vectorised top-k chunks, and the
    per-class grouping for mAP happens once at get() with a single sort.
    Results are identical (same AP formula, same top-k truncation).
    """

    def __init__(self, num_class: int, top_k: int = 20):
        self.num_class = num_class
        self.sum_hit_at_one = 0.0
        self.sum_perr = 0.0
        self.sum_loss = 0.0
        self.global_ap_calculator = AveragePrecisionCalculator()
        self.top_k = top_k
        self.num_examples = 0
        self._class_chunks = []
        self._pred_chunks = []
        self._label_chunks = []
        self._class_positives = np.zeros(num_class, dtype=np.int64)

    def accumulate(
        self,
        predictions: np.ndarray,
        labels: np.ndarray,
        loss,
        batch_mask: Optional[np.ndarray] = None,
    ) -> Dict[str, float]:
        """Add one batch. `batch_mask` drops padded rows (rebuild addition —
        the reference relied on queue OutOfRange to avoid padding)."""
        if batch_mask is not None:
            keep = np.asarray(batch_mask) > 0
            predictions = predictions[keep]
            labels = labels[keep]
            loss = np.asarray(loss)
            if loss.ndim > 0 and loss.shape[0] == keep.shape[0]:
                loss = loss[keep]
        batch_size = labels.shape[0]
        if batch_size == 0:
            return {"hit_at_one": 0.0, "perr": 0.0, "loss": 0.0}
        mean_hit = calculate_hit_at_one(predictions, labels)
        mean_perr = calculate_precision_at_equal_recall_rate(
            predictions, labels
        )
        mean_loss = float(np.mean(loss))

        k = min(self.top_k, predictions.shape[1])
        idx = np.argpartition(predictions, -k, axis=1)[:, -k:]
        rows = np.arange(batch_size)[:, None]
        preds_k = predictions[rows, idx].ravel()
        labels_k = labels[rows, idx].ravel()
        classes_k = idx.ravel().astype(np.int32)
        num_pos_batch = int(np.sum(labels > 0))

        self._class_chunks.append(classes_k)
        self._pred_chunks.append(preds_k.astype(np.float64))
        self._label_chunks.append(labels_k.astype(np.float64))
        self._class_positives += (labels > 0).sum(axis=0).astype(np.int64)
        self.global_ap_calculator.accumulate(
            preds_k, labels_k, num_pos_batch
        )

        self.num_examples += batch_size
        self.sum_hit_at_one += mean_hit * batch_size
        self.sum_perr += mean_perr * batch_size
        self.sum_loss += mean_loss * batch_size
        return {
            "hit_at_one": mean_hit,
            "perr": mean_perr,
            "loss": mean_loss,
        }

    def accumulate_topk(
        self,
        topk_values: np.ndarray,
        topk_indices: np.ndarray,
        topk_labels: np.ndarray,
        labels_per_video: np.ndarray,
        class_positives: np.ndarray,
        loss,
        batch_mask: Optional[np.ndarray] = None,
    ) -> Dict[str, float]:
        """Device-sparsified accumulate (train.step.make_sparse_eval_step).

        Inputs are the per-video top-K triplets (K >= top_k, sorted by
        descending score), per-video positive-label counts, and the
        batch's per-class positive totals (padded rows already masked on
        device). Produces results identical to accumulate() whenever
        (a) no score ties straddle the K boundary and (b) every video has
        <= K positive labels (the native pipeline caps labels/video at 64,
        so K=64 keeps PERR exact); equivalence is tested.
        """
        self._class_positives += np.asarray(class_positives, np.int64)
        if batch_mask is not None:
            keep = np.asarray(batch_mask) > 0
            topk_values = topk_values[keep]
            topk_indices = topk_indices[keep]
            topk_labels = topk_labels[keep]
            labels_per_video = np.asarray(labels_per_video)[keep]
            loss = np.asarray(loss)
            if loss.ndim > 0 and loss.shape[0] == keep.shape[0]:
                loss = loss[keep]
        batch_size = topk_values.shape[0]
        if batch_size == 0:
            return {"hit_at_one": 0.0, "perr": 0.0, "loss": 0.0}
        big_k = topk_values.shape[1]

        mean_hit = float(np.mean(topk_labels[:, 0] > 0))

        kv = np.asarray(labels_per_video, np.int64)
        if int(kv.max(initial=0)) > big_k and not getattr(
            self, "_warned_kv_overflow", False
        ):
            # PERR@k_v is truncated to the top-K triplets for such
            # videos (the native pipeline caps labels/video at 64, so
            # this only occurs with uncapped readers + K < label count).
            import logging

            logging.getLogger("yt8m_tpu_torch.metrics").warning(
                "video with %d labels exceeds device_metric_topk=%d; "
                "PERR is truncated for such videos (raise "
                "--device_metric_topk or use 0 for the dense path)",
                int(kv.max()), big_k,
            )
            self._warned_kv_overflow = True
        ranked_hits = (topk_labels > 0) & (topk_values > 0)
        csum = np.cumsum(ranked_hits, axis=1)
        valid = kv > 0
        kc = np.clip(kv, 1, big_k)
        perr = np.zeros(batch_size, dtype=np.float64)
        perr[valid] = (
            csum[np.arange(batch_size), kc - 1][valid]
            / np.clip(kv, 1, None)[valid]
        )
        mean_perr = float(np.mean(perr))
        mean_loss = float(np.mean(loss))

        k = min(self.top_k, big_k)
        preds_k = topk_values[:, :k].ravel()
        labels_k = topk_labels[:, :k].ravel()
        classes_k = topk_indices[:, :k].ravel().astype(np.int32)
        num_pos_batch = int(kv.sum())

        self._class_chunks.append(classes_k)
        self._pred_chunks.append(preds_k.astype(np.float64))
        self._label_chunks.append(labels_k.astype(np.float64))
        self.global_ap_calculator.accumulate(
            preds_k, labels_k, num_pos_batch
        )

        self.num_examples += batch_size
        self.sum_hit_at_one += mean_hit * batch_size
        self.sum_perr += mean_perr * batch_size
        self.sum_loss += mean_loss * batch_size
        return {
            "hit_at_one": mean_hit,
            "perr": mean_perr,
            "loss": mean_loss,
        }

    def get(self) -> Dict:
        if self.num_examples <= 0:
            raise ValueError("total_sample must be positive.")
        # Group the sparse top-k entries by class with ONE sort.
        aps = [0.0] * self.num_class
        if self._class_chunks:
            classes = np.concatenate(self._class_chunks)
            preds = np.concatenate(self._pred_chunks)
            labels = np.concatenate(self._label_chunks)
            order = np.argsort(classes, kind="stable")
            classes, preds, labels = (
                classes[order], preds[order], labels[order]
            )
            bounds = np.searchsorted(
                classes, np.arange(self.num_class + 1)
            )
            for c in range(self.num_class):
                lo, hi = bounds[c], bounds[c + 1]
                if hi > lo:
                    aps[c] = ap_at_n(
                        preds[lo:hi],
                        labels[lo:hi],
                        n=None,
                        total_num_positives=int(
                            self._class_positives[c]
                        ),
                    )
        return {
            "avg_hit_at_one": self.sum_hit_at_one / self.num_examples,
            "avg_perr": self.sum_perr / self.num_examples,
            "avg_loss": self.sum_loss / self.num_examples,
            "aps": aps,
            "gap": self.global_ap_calculator.peek_ap_at_n(),
        }

    def clear(self) -> None:
        self.sum_hit_at_one = 0.0
        self.sum_perr = 0.0
        self.sum_loss = 0.0
        self.global_ap_calculator.clear()
        self.num_examples = 0
        self._class_chunks = []
        self._pred_chunks = []
        self._label_chunks = []
        self._class_positives = np.zeros(self.num_class, dtype=np.int64)
