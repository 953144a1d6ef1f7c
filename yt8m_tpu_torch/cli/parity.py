"""Parity harness (reference: the JAX package's cli/parity.py, the
GAP-parity metric of BASELINE.json).

One command that turns "the reference tree / a reference run appears"
into a pass/fail: given reference predictions and ours over the SAME
split, align by video id and report ΔGAP@20 / ΔHit@1 / ΔPERR against
the 0.1% parity bar. Host code: it reads files and scores them with the
port's EvaluationMetrics, and launches nothing on the card.

    python -m yt8m_tpu_torch.cli.parity \
        --reference_predictions='ref/preds*.csv' \
        --our_predictions='out/preds*.csv' \
        --labels='eval/*.tfrecord'  (or a labels CSV `vid,1 5 9`) \
        --num_classes=4716 --top_k=20 --bar=0.001

Prediction inputs may be any mix of:
  * Kaggle submission CSV (`VideoId,LabelConfidencePairs`, `cls p` pairs,
    optionally .gz) — what reference inference.py and ours both write;
  * dense dumps  (.npz: ids + predictions [N, C]) — cli.inference's
    --output_probabilities_dir format, fork inference-pre-ensemble.py
    equivalent;
  * sparse dumps (.npz: ids + values + indices [N, K]).

Label inputs: YT-8M TFRecords (Example or SequenceExample — only the
`id`/`labels` context features are read, so no feature config is
needed) or a CSV of `vid,<space-separated class ids>`.

Exit status: 0 when every |Δ| <= bar over the aligned (inner-join)
video set, 1 otherwise. The last stdout line is one JSON object with
both sides' absolute metrics, the deltas, and the join coverage —
machine-checkable.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import logging
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from yt8m_tpu_torch.metrics.eval_metrics import EvaluationMetrics
from yt8m_tpu_torch.utils.flags import parse_into

log = logging.getLogger("yt8m_tpu_torch.parity")

Sparse = Tuple[np.ndarray, np.ndarray]  # (class indices i32, scores f64)


@dataclasses.dataclass
class ParityConfig:
    reference_predictions: str = ""
    our_predictions: str = ""
    labels: str = ""
    num_classes: int = 4716
    top_k: int = 20
    # |ΔGAP|, |ΔHit@1|, |ΔPERR| must all be <= bar (0.001 = the 0.1%
    # north-star parity bar, BASELINE.json)
    bar: float = 0.001
    # metric batch size for the densify→accumulate loop
    batch_size: int = 1024


# -- prediction loading -------------------------------------------------------


def _parse_submission_line(line: str) -> Optional[Tuple[str, Sparse]]:
    line = line.strip()
    if not line or line.startswith("VideoId"):
        return None
    vid, _, pairs = line.partition(",")
    toks = pairs.split()
    if len(toks) % 2:
        raise ValueError(f"odd token count in line for {vid!r}")
    idx = np.asarray(toks[0::2], dtype=np.int32)
    val = np.asarray(toks[1::2], dtype=np.float64)
    return vid, (idx, val)


def load_predictions(pattern: str) -> Dict[str, Sparse]:
    """vid -> (class indices, scores), from CSV/.csv.gz/.npz shards."""
    files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no prediction files matched {pattern!r}")
    out: Dict[str, Sparse] = {}
    for path in files:
        if path.endswith(".npz"):
            with np.load(path) as z:
                ids = [
                    i.decode() if isinstance(i, bytes) else str(i)
                    for i in z["ids"]
                ]
                if "predictions" in z:  # dense dump
                    dense = np.asarray(z["predictions"], np.float64)
                    for row, vid in enumerate(ids):
                        idx = np.nonzero(dense[row] != 0)[0].astype(np.int32)
                        out[vid] = (idx, dense[row, idx])
                else:  # sparse dump
                    values = np.asarray(z["values"], np.float64)
                    indices = np.asarray(z["indices"], np.int32)
                    for row, vid in enumerate(ids):
                        out[vid] = (indices[row], values[row])
        else:
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                for line in f:
                    parsed = _parse_submission_line(line)
                    if parsed:
                        out[parsed[0]] = parsed[1]
    return out


# -- label loading -------------------------------------------------------------


def _labels_from_tfrecords(files: List[str]) -> Dict[str, np.ndarray]:
    """Read only id+labels context features; works for both Example and
    SequenceExample shards (no feature_names/sizes config needed)."""
    from yt8m_tpu_torch.data import proto
    from yt8m_tpu_torch.data.tfrecord import tfrecord_iterator

    out: Dict[str, np.ndarray] = {}
    skipped = 0
    for path in files:
        for buf in tfrecord_iterator(path):
            feats = proto.decode_example(buf)
            if "labels" not in feats and "id" not in feats:
                # SequenceExample: labels live in the context message
                feats, _ = proto.decode_sequence_example(buf)
            vid = feats.get("id", feats.get("video_id", ("bytes", [b""])))[1]
            vid = vid[0] if vid else b""
            vid = vid.decode() if isinstance(vid, bytes) else str(vid)
            if not vid:
                # An id-less record cannot be joined; keying it on ""
                # would silently overwrite earlier id-less records and
                # shrink the parity join — count and skip instead.
                skipped += 1
                continue
            labels = feats.get("labels")
            ids = (
                np.asarray([int(v) for v in labels[1]], np.int32)
                if labels
                else np.zeros((0,), np.int32)
            )
            out[vid] = ids
    if skipped:
        log.warning(
            "label shards: skipped %d record(s) with no id context "
            "feature — they cannot be joined and are EXCLUDED from the "
            "parity comparison", skipped,
        )
    return out


def load_labels(pattern: str) -> Dict[str, np.ndarray]:
    files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no label files matched {pattern!r}")
    if files[0].endswith((".csv", ".csv.gz", ".txt")):
        out: Dict[str, np.ndarray] = {}
        for path in files:
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                for line in f:
                    line = line.strip()
                    if not line or line.startswith("VideoId"):
                        continue
                    vid, _, rest = line.partition(",")
                    out[vid] = np.asarray(
                        [int(t) for t in rest.split()], np.int32
                    )
        return out
    return _labels_from_tfrecords(files)


# -- metric computation --------------------------------------------------------


def compute_metrics(
    preds: Dict[str, Sparse],
    labels: Dict[str, np.ndarray],
    vids: List[str],
    num_classes: int,
    top_k: int,
    batch_size: int = 1024,
) -> Dict[str, float]:
    """Reference eval metrics over an explicit video set: densify the
    sparse predictions per batch and push through EvaluationMetrics —
    the same accumulator the eval driver uses, so a zero delta here is
    the same statement as matching `cli.eval`'s output."""
    em = EvaluationMetrics(num_classes, top_k=top_k)
    for lo in range(0, len(vids), batch_size):
        chunk = vids[lo : lo + batch_size]
        dense_p = np.zeros((len(chunk), num_classes), np.float64)
        dense_y = np.zeros((len(chunk), num_classes), np.float32)
        for row, vid in enumerate(chunk):
            idx, val = preds[vid]
            keep = (idx >= 0) & (idx < num_classes)
            dense_p[row, idx[keep]] = val[keep]
            y = labels[vid]
            dense_y[row, y[(y >= 0) & (y < num_classes)]] = 1.0
        em.accumulate(dense_p, dense_y, loss=0.0)
    got = em.get()
    return {
        "gap": float(got["gap"]),
        "hit_at_one": float(got["avg_hit_at_one"]),
        "perr": float(got["avg_perr"]),
        "map": float(np.mean(got["aps"])),
    }


def compare(
    reference: Dict[str, Sparse],
    ours: Dict[str, Sparse],
    labels: Dict[str, np.ndarray],
    num_classes: int = 4716,
    top_k: int = 20,
    bar: float = 0.001,
    batch_size: int = 1024,
) -> Dict:
    """Inner-join the three id sets, compute both sides' metrics over
    the SAME videos, and report deltas vs the bar."""
    joined = sorted(set(reference) & set(ours) & set(labels))
    if not joined:
        raise SystemExit(
            "no overlapping video ids between reference predictions, our "
            "predictions, and labels"
        )
    ref_m = compute_metrics(
        reference, labels, joined, num_classes, top_k, batch_size
    )
    our_m = compute_metrics(
        ours, labels, joined, num_classes, top_k, batch_size
    )
    deltas = {k: our_m[k] - ref_m[k] for k in ref_m}
    gated = ("gap", "hit_at_one", "perr")
    ok = all(abs(deltas[k]) <= bar for k in gated)
    return {
        "videos_compared": len(joined),
        "videos_reference_only": len(set(reference) - set(joined)),
        "videos_ours_only": len(set(ours) - set(joined)),
        "reference": ref_m,
        "ours": our_m,
        "delta": deltas,
        "bar": bar,
        "pass": ok,
    }


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        force=True,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    cfg, _ = parse_into(ParityConfig, argv)
    for flag in ("reference_predictions", "our_predictions", "labels"):
        if not getattr(cfg, flag):
            raise SystemExit(f"--{flag} is required")
    reference = load_predictions(cfg.reference_predictions)
    ours = load_predictions(cfg.our_predictions)
    labels = load_labels(cfg.labels)
    log.info(
        "loaded %d reference / %d our predictions, %d labeled videos",
        len(reference), len(ours), len(labels),
    )
    report = compare(
        reference, ours, labels,
        num_classes=cfg.num_classes, top_k=cfg.top_k, bar=cfg.bar,
        batch_size=cfg.batch_size,
    )
    for k in ("gap", "hit_at_one", "perr", "map"):
        log.info(
            "%-10s reference %.6f  ours %.6f  delta %+.6f%s",
            k, report["reference"][k], report["ours"][k],
            report["delta"][k],
            ""
            if k == "map"
            else (" (within bar)" if abs(report["delta"][k]) <= cfg.bar
                  else " EXCEEDS BAR"),
        )
    print(json.dumps(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
