"""Cloud-ML JSON batch predictions -> Kaggle CSV.

Reference: convert_prediction_from_json_to_csv.py (a copy of the JAX
package's utils/convert_prediction.py). Input: files of JSON
lines like {"video_id": "...", "class_indexes": [...], "predictions":
[...]} (the reference's exported-model batch output); output: the
`VideoId,LabelConfidencePairs` submission CSV.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys


def convert(json_pattern: str, csv_out: str, top_k: int = 20) -> int:
    n = 0
    with open(csv_out, "w") as out:
        out.write("VideoId,LabelConfidencePairs\n")
        for path in sorted(glob.glob(json_pattern)):
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    rec = json.loads(line)
                    vid = rec.get("video_id", rec.get("id", ""))
                    if isinstance(vid, bytes):
                        vid = vid.decode()
                    idx = rec["class_indexes"]
                    preds = rec["predictions"]
                    pairs = sorted(
                        zip(idx, preds), key=lambda t: -t[1]
                    )[:top_k]
                    body = " ".join(
                        "%i %g" % (int(i), float(p)) for i, p in pairs
                    )
                    out.write(f"{vid},{body}\n")
                    n += 1
    return n


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--json_prediction_files_pattern", required=True)
    p.add_argument("--csv_output_file", required=True)
    p.add_argument("--top_k", type=int, default=20)
    args = p.parse_args(argv)
    n = convert(
        args.json_prediction_files_pattern, args.csv_output_file, args.top_k
    )
    print(f"wrote {n} rows to {args.csv_output_file}")


if __name__ == "__main__":
    main(sys.argv[1:])
