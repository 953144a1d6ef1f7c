"""Inference CLI (reference: inference.py).

    python -m yt8m_tpu_torch.cli.inference \
        --input_data_pattern='data/test-*.tfrecord' --train_dir=run \
        --output_file=out.csv --frame_features --feature_names=rgb,audio \
        --feature_sizes=1024,128 --model=DbofModel --batch_size=128

The model is rebuilt from the run's recorded model_flags.json (explicit
flags win) and runs on --device (default cuda).
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
    if not cfg.output_file:
        raise SystemExit("--output_file is required")
    apply_recorded_model_flags(cfg, argv)
    return inference(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
