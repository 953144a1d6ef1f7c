"""Ensemble CLI (reference: the fork's ensemble scripts; the JAX
package's cli/ensemble.py): the weighted average of members' probability
dumps (cli.inference --output_probabilities_dir) as the Kaggle CSV.

    python -m yt8m_tpu_torch.cli.ensemble \
        --member_dirs=preds_a,preds_b --weights=1,2 \
        --output_file=ensemble.csv \
        [--eval_labels_pattern='validate-*.tfrecord' --fit_weights]

--fit_weights fits the weights by coordinate ascent on the GAP against
--eval_labels_pattern's labels; with --eval_labels_pattern the
ensemble's GAP is printed. Runs on the host.
"""

from __future__ import annotations

import argparse
import logging
import sys

import numpy as np

from yt8m_tpu_torch.ensemble.average import (
    align_members,
    ensemble_directories,
    fit_weights_by_gap,
    labels_from_tfrecords,
    load_prediction_dir,
)
from yt8m_tpu_torch.metrics import calculate_gap


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--member_dirs", required=True,
                   help="comma-separated prediction dump dirs")
    p.add_argument("--weights", default="",
                   help="comma-separated member weights")
    p.add_argument("--output_file", default="")
    p.add_argument("--top_k", type=int, default=20)
    p.add_argument("--fit_weights", action="store_true")
    p.add_argument("--eval_labels_pattern", default="",
                   help="tfrecords with ground truth (weight fit / report)")
    p.add_argument("--frame_features", action="store_true")
    p.add_argument("--num_classes", type=int, default=4716)
    args = p.parse_args(argv)

    member_dirs = [d for d in args.member_dirs.split(",") if d]
    weights = ([float(w) for w in args.weights.split(",")]
               if args.weights else None)
    labels_by_id = None
    if args.fit_weights or args.eval_labels_pattern:
        ids, aligned = align_members(
            [load_prediction_dir(d) for d in member_dirs])
        labels_by_id = labels_from_tfrecords(
            args.eval_labels_pattern, args.frame_features, args.num_classes)
        if args.fit_weights:
            labels = np.stack([labels_by_id[v] for v in ids])
            weights = fit_weights_by_gap(aligned, labels, args.top_k)
            logging.info("fitted weights: %s", weights)

    ids, avg = ensemble_directories(
        member_dirs, weights=weights, output_csv=args.output_file or None,
        top_k=args.top_k)
    out = {"num_videos": len(ids), "weights": weights}
    if args.eval_labels_pattern:
        labels = np.stack([labels_by_id[v] for v in ids])
        out["gap"] = calculate_gap(avg, labels, args.top_k)
        logging.info("ensemble GAP: %.5f", out["gap"])
        print(f"GAP {out['gap']:.5f}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
