"""Eval CLI (reference: eval.py).

    python -m yt8m_tpu_torch.cli.eval \
        --eval_data_pattern='data/validate-*.tfrecord' --train_dir=run \
        --run_once

The model is rebuilt from the run's recorded model_flags.json (explicit
flags win) and runs on --device (default cuda); with
--ensemble_train_dirs the members' weighted average is evaluated. On
several cards (--num_devices=N, unset: every visible card; or torchrun)
each rank serves its block of every batch and rank 0 writes the metrics.
"""

from __future__ import annotations

import logging
import sys

from yt8m_tpu_torch.config import EvalConfig
from yt8m_tpu_torch.eval.loop import evaluation_loop
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.parallel.distributed import LOG_FORMAT, run_on_ranks
from yt8m_tpu_torch.utils.flags import apply_recorded_model_flags, parse_into


def evaluate(argv) -> dict:
    """One rank's evaluation (the whole of it on one device)."""
    cfg, _ = parse_into(EvalConfig, argv, hparams_cls=ModelHParams)
    if not cfg.ensemble_train_dirs:
        # An ensemble rebuilds each member from its own run's flags.
        apply_recorded_model_flags(cfg, argv)
    return evaluation_loop(cfg)


def main(argv=None, **launch_options) -> dict:
    """`launch_options` as cli.train's."""
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, _ = parse_into(EvalConfig, argv, hparams_cls=ModelHParams)
    if not cfg.eval_data_pattern:
        raise SystemExit("--eval_data_pattern is required")
    return run_on_ranks(evaluate, (argv,), cfg.num_devices, cfg.device,
                        **launch_options)


if __name__ == "__main__":
    main(sys.argv[1:])
