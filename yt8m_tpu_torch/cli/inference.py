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
comes from its own run). On several cards (--num_devices=N, unset: every
visible card; or torchrun) each rank serves its block of every batch and
rank 0 writes the CSV and the dumps.
"""

from __future__ import annotations

import logging
import sys

from yt8m_tpu_torch.config import InferenceConfig
from yt8m_tpu_torch.infer.predict import inference
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.parallel.distributed import LOG_FORMAT, run_on_ranks
from yt8m_tpu_torch.utils.flags import apply_recorded_model_flags, parse_into


def infer(argv) -> dict:
    """One rank's inference (the whole of it on one device)."""
    cfg, _ = parse_into(InferenceConfig, argv, hparams_cls=ModelHParams)
    if not cfg.ensemble_train_dirs:
        # An ensemble rebuilds each member from its own run's flags.
        apply_recorded_model_flags(cfg, argv)
    return inference(cfg)


def main(argv=None, **launch_options) -> dict:
    """`launch_options` as cli.train's."""
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, _ = parse_into(InferenceConfig, argv, hparams_cls=ModelHParams)
    if not cfg.input_data_pattern:
        raise SystemExit("--input_data_pattern is required")
    if not cfg.output_file and not cfg.output_probabilities_dir:
        raise SystemExit(
            "--output_file or --output_probabilities_dir is required")
    return run_on_ranks(infer, (argv,), cfg.num_devices, cfg.device,
                        **launch_options)


if __name__ == "__main__":
    main(sys.argv[1:])
