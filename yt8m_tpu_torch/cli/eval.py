"""Eval CLI (reference: eval.py).

    python -m yt8m_tpu_torch.cli.eval \
        --eval_data_pattern='data/validate-*.tfrecord' --train_dir=run \
        --run_once

The model is rebuilt from the run's recorded model_flags.json (explicit
flags win) and runs on --device (default cuda).
"""

from __future__ import annotations

import logging
import sys

from yt8m_tpu_torch.config import EvalConfig
from yt8m_tpu_torch.eval.loop import evaluation_loop
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.utils.flags import apply_recorded_model_flags, parse_into


def main(argv=None) -> dict:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    cfg, _ = parse_into(EvalConfig, argv, hparams_cls=ModelHParams)
    if not cfg.eval_data_pattern:
        raise SystemExit("--eval_data_pattern is required")
    apply_recorded_model_flags(cfg, argv)
    return evaluation_loop(cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
