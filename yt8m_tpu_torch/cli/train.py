"""Train CLI (reference: train.py).

    python -m yt8m_tpu_torch.cli.train \
        --train_data_pattern='data/train-*.tfrecord' --train_dir=run \
        --model=NetVladLstmModel --frame_features \
        --feature_names=rgb,audio --feature_sizes=1024,128 \
        --batch_size=256 --netvlad_fused_train

Runs on --device (default cuda); rerunning with the same --train_dir
resumes from its latest checkpoint (--start_new_model wipes it).
"""

from __future__ import annotations

import logging
import sys

from yt8m_tpu_torch.config import TrainConfig
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.train.loop import Trainer
from yt8m_tpu_torch.utils.flags import parse_into


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s: %(message)s",
    )
    cfg, _ = parse_into(TrainConfig, argv, hparams_cls=ModelHParams)
    if not cfg.train_data_pattern:
        raise SystemExit("--train_data_pattern is required")
    return Trainer(cfg).run()


if __name__ == "__main__":
    main(sys.argv[1:])
