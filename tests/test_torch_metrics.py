"""The port's numpy copies of the eval metrics (yt8m_tpu_torch/metrics)
against the JAX package's metrics/ on the same inputs, and the port's
eval steps against the metrics they feed.

Tolerance: none. The copies run the same numpy code on the same arrays,
so every value equals the JAX package's bit for bit, scores with exact
ties included (the AP's seeded tie-break permutation is the reference's).
The sparse eval step feeds accumulate_topk, which equals the dense
accumulate exactly when no score tie straddles the K boundary and no
video has more than K labels (the JAX package's contract, held here).
"""

import numpy as np
import pytest
import torch

from yt8m_tpu import metrics as jm
from yt8m_tpu_torch import metrics as tm
from yt8m_tpu_torch.train.losses import get_loss
from yt8m_tpu_torch.train.step import make_eval_step, make_sparse_eval_step

C = 40


def _data(seed, b=24, ties=False):
    rng = np.random.default_rng(seed)
    preds = rng.uniform(size=(b, C)).astype(np.float32)
    if ties:
        preds = np.round(preds * 8) / 8  # many exact ties
    labels = (rng.uniform(size=(b, C)) < 0.1).astype(np.float32)
    labels[0] = 0.0  # a video with no label
    labels[1, :5] = 1.0
    return preds, labels


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_batch_metrics_equal_jax(ties):
    preds, labels = _data(0, ties=ties)
    for name in ("calculate_hit_at_one",
                 "calculate_precision_at_equal_recall_rate",
                 "calculate_gap"):
        assert getattr(tm, name)(preds, labels) == getattr(jm, name)(
            preds, labels), name
    for n in (None, 5, 20):
        assert tm.ap_at_n(preds[:, 3], labels[:, 3], n=n) == jm.ap_at_n(
            preds[:, 3], labels[:, 3], n=n)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_streaming_calculators_equal_jax(ties):
    ours = tm.AveragePrecisionCalculator(top_n=30)
    theirs = jm.AveragePrecisionCalculator(top_n=30)
    ours_map = tm.MeanAveragePrecisionCalculator(C)
    theirs_map = jm.MeanAveragePrecisionCalculator(C)
    for seed in range(4):
        preds, labels = _data(seed + 1, ties=ties)
        ours.accumulate(preds.ravel(), labels.ravel())
        theirs.accumulate(preds.ravel(), labels.ravel())
        ours_map.accumulate(list(preds.T), list(labels.T))
        theirs_map.accumulate(list(preds.T), list(labels.T))
    assert ours.peek_ap_at_n() == theirs.peek_ap_at_n()
    assert ours_map.peek_map_at_n() == theirs_map.peek_map_at_n()


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_evaluation_metrics_equal_jax(ties):
    ours = tm.EvaluationMetrics(C, top_k=20)
    theirs = jm.EvaluationMetrics(C, top_k=20)
    for seed in range(3):
        preds, labels = _data(seed + 7, ties=ties)
        loss = np.random.default_rng(seed).uniform(size=preds.shape[0])
        mask = np.ones(preds.shape[0], np.float32)
        mask[-2:] = 0.0
        assert ours.accumulate(preds, labels, loss, mask) == \
            theirs.accumulate(preds, labels, loss, mask)
    assert ours.get() == theirs.get()


def _topk_inputs(preds, labels, k):
    idx = np.argsort(-preds, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(preds, idx, axis=1)
    lab = np.take_along_axis(labels, idx, axis=1)
    return vals, idx.astype(np.int32), lab


def test_accumulate_topk_equals_accumulate():
    dense = tm.EvaluationMetrics(C, top_k=20)
    sparse = tm.EvaluationMetrics(C, top_k=20)
    jsparse = jm.EvaluationMetrics(C, top_k=20)
    for seed in range(3):
        preds, labels = _data(seed + 11)
        loss = np.random.default_rng(seed).uniform(size=preds.shape[0])
        mask = np.ones(preds.shape[0], np.float32)
        mask[-1] = 0.0
        dense.accumulate(preds, labels, loss, mask)
        vals, idx, lab = _topk_inputs(preds, labels, 32)
        pos = labels > 0
        class_pos = (pos & (mask > 0)[:, None]).sum(0)
        args = (vals, idx, lab, pos.sum(1), class_pos, loss, mask)
        sparse.accumulate_topk(*args)
        jsparse.accumulate_topk(*args)
    want, got = dense.get(), sparse.get()
    assert got == jsparse.get()
    for key in ("avg_hit_at_one", "avg_perr", "avg_loss", "gap"):
        assert got[key] == pytest.approx(want[key], abs=1e-12), key
    np.testing.assert_allclose(got["aps"], want["aps"], atol=1e-12)


class _Fixed(torch.nn.Module):
    """A stand-in model that returns the given predictions."""

    def __init__(self, preds):
        super().__init__()
        self.preds = torch.from_numpy(preds)

    def forward(self, features, num_frames, generator=None):
        return {"predictions": self.preds}


def test_sparse_eval_step_matches_dense_eval_step():
    preds, labels = _data(5)
    preds[2, 7] = np.nan  # the tripwire counts it, on a real row only
    preds[-1, 3] = np.inf  # a padded row: not counted
    mask = np.ones(preds.shape[0], np.float32)
    mask[-1] = 0.0
    batch = {"features": torch.zeros(preds.shape[0], 1),
             "num_frames": torch.ones(preds.shape[0], dtype=torch.int32),
             "labels": torch.from_numpy(labels),
             "batch_mask": torch.from_numpy(mask)}
    model = _Fixed(preds)
    loss = get_loss("CrossEntropyLoss")
    p, per_ex = make_eval_step(model, loss)(batch)
    out = make_sparse_eval_step(model, loss, 64)(batch)
    assert int(out["nonfinite_predictions"]) == 1
    np.testing.assert_array_equal(out["loss"].numpy(), per_ex.numpy())
    np.testing.assert_array_equal(out["labels_per_video"].numpy(),
                                  (labels > 0).sum(1))
    np.testing.assert_array_equal(out["class_positives"].numpy(),
                                  (labels[:-1] > 0).sum(0))
    finite = np.where(np.isnan(preds), -3.0e38, preds)
    order = np.argsort(-finite, axis=1, kind="stable")[:, :C]
    np.testing.assert_array_equal(out["topk_indices"].numpy(), order)
    np.testing.assert_array_equal(
        out["topk_labels"].numpy(), np.take_along_axis(labels, order, 1))
    assert out["topk_values"].shape == (preds.shape[0], C)
