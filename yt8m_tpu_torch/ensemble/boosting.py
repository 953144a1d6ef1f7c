"""Boosting: per-video sample reweighting between ensemble members
(reference: the fork's bagging/boosting orchestration; a copy of the JAX
package's ensemble/boosting.py).

Flow (scripts/boosted_pipeline.sh):
  1. train member 1 on uniform weights
  2. pre-ensemble inference over the TRAIN split -> dense predictions
  3. fit_boost_weights: upweight videos the member got wrong
  4. train member 2 with --boost_weights_file
  5. ensemble-average members (ensemble/average.py)

The weights stay on the host, keyed by video id: no TFRecord rewrite,
no reader change. BoostedIterator injects a
[B] "example_weights" array into each batch (default 1.0 for unseen
ids); the train step folds it into the loss mask (weighted mean).
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator

import numpy as np

_EPS = 1e-6


def fit_boost_weights(
    ids,
    predictions: np.ndarray,
    labels: np.ndarray,
    beta: float = 1.0,
    clip: float = 5.0,
) -> Dict[str, float]:
    """AdaBoost-flavoured reweighting from a member's train-split output.

    weight_i = exp(beta * (err_i - mean_err)), clipped to [1/clip, clip]
    and normalised to mean 1, where err_i is the per-video mean sigmoid
    cross entropy of the member's predictions against the labels.
    """
    p = np.clip(np.asarray(predictions, np.float64), _EPS, 1.0 - _EPS)
    y = np.asarray(labels, np.float64)
    err = -np.mean(y * np.log(p) + (1.0 - y) * np.log(1.0 - p), axis=1)
    w = np.exp(beta * (err - err.mean()))
    w = np.clip(w, 1.0 / clip, clip)
    w = w / w.mean()
    return {
        (v.decode() if isinstance(v, bytes) else str(v)): float(wi)
        for v, wi in zip(ids, w)
    }


def save_boost_weights(path: str, weights: Dict[str, float]) -> None:
    ids = np.asarray(list(weights.keys()))
    vals = np.asarray(list(weights.values()), np.float32)
    np.savez_compressed(path, ids=ids, weights=vals)


def load_boost_weights(path: str) -> Dict[str, float]:
    z = np.load(path, allow_pickle=True)
    return {str(v): float(w) for v, w in zip(z["ids"], z["weights"])}


class BoostedIterator:
    """Wrap a batch iterator, injecting per-video example_weights."""

    def __init__(self, it: Iterable[dict], weights: Dict[str, float]):
        self.inner = it
        self._weights = weights

    def __iter__(self) -> Iterator[dict]:
        for batch in self.inner:
            w = np.ones(batch["batch_mask"].shape, np.float32)
            for i, vid in enumerate(batch["id"]):
                key = (
                    vid.decode() if isinstance(vid, bytes) else str(vid)
                )
                w[i] = self._weights.get(key, 1.0)
            batch = dict(batch)
            batch["example_weights"] = w
            yield batch


def main(argv=None):
    """CLI: fit weights from a pre-ensemble dump of the train split.

    python -m yt8m_tpu_torch.ensemble.boosting \
        --predictions_dir=member1_train_probs \
        --train_data_pattern='data/train-*.tfrecord' \
        --output=boost_weights.npz [--beta=1.0]
    """
    import argparse

    from yt8m_tpu_torch.ensemble.average import (
        labels_from_tfrecords,
        load_prediction_dir,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--predictions_dir", required=True)
    ap.add_argument("--train_data_pattern", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--beta", type=float, default=1.0)
    ap.add_argument("--frame_features", default="true")
    ap.add_argument("--num_classes", type=int, default=4716)
    args = ap.parse_args(argv)

    ids, preds = load_prediction_dir(args.predictions_dir)
    frame_level = args.frame_features.lower() in ("true", "t", "1")
    label_map = labels_from_tfrecords(
        args.train_data_pattern, frame_level, args.num_classes
    )
    kept = [v for v in ids if v in label_map]
    if not kept:
        raise SystemExit(
            f"no video ids from --predictions_dir ({len(ids)} ids) match "
            f"--train_data_pattern ({len(label_map)} labelled videos) — "
            "were the predictions dumped from a different split?"
        )
    labels = np.stack([label_map[v] for v in kept])
    keep_idx = [i for i, v in enumerate(ids) if v in label_map]
    weights = fit_boost_weights(
        kept, preds[keep_idx], labels, beta=args.beta
    )
    save_boost_weights(args.output, weights)
    print(
        f"wrote {len(weights)} boost weights to {args.output} "
        f"(min {min(weights.values()):.3f}, "
        f"max {max(weights.values()):.3f})"
    )


if __name__ == "__main__":
    main()
