"""Inference CLI (reference: inference.py).

    python -m yt8m_tpu_torch.cli.inference \
        --input_data_pattern='data/test-*.tfrecord' --train_dir=run \
        --output_file=out.csv --frame_features --feature_names=rgb,audio \
        --feature_sizes=1024,128 --model=DbofModel --batch_size=128

The model is rebuilt from the run's recorded model_flags.json (explicit
flags win) and runs on --device (default cuda). With
--output_probabilities_dir (and --output_file="" or a CSV besides) it
dumps each batch's probabilities, dense or with
--output_probabilities_topk=N the top N a video; with
--ensemble_train_dirs=a,b [--ensemble_weights=1,2] it serves the
members' weighted average (pass the reader flags: each member's model
comes from its own run).
"""

from __future__ import annotations

import logging
import sys

from yt8m_tpu_torch.config import InferenceConfig
from yt8m_tpu_torch.infer.predict import inference
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.utils.flags import apply_recorded_model_flags, parse_into


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    cfg, _ = parse_into(InferenceConfig, argv, hparams_cls=ModelHParams)
    if not cfg.input_data_pattern:
        raise SystemExit("--input_data_pattern is required")
    if not cfg.output_file and not cfg.output_probabilities_dir:
        raise SystemExit(
            "--output_file or --output_probabilities_dir is required")
    if not cfg.ensemble_train_dirs:
        # An ensemble rebuilds each member from its own run's flags.
        apply_recorded_model_flags(cfg, argv)
    return inference(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
