"""Train CLI (reference: train.py).

    python -m yt8m_tpu_torch.cli.train \
        --train_data_pattern='data/train-*.tfrecord' --train_dir=run \
        --model=NetVladLstmModel --frame_features \
        --feature_names=rgb,audio --feature_sizes=1024,128 \
        --batch_size=256 --netvlad_fused_train

Runs on --device (default cuda); rerunning with the same --train_dir
resumes from its latest checkpoint (--start_new_model wipes it). On
several cards, one rank a card: --num_devices=N spawns the ranks (unset:
every visible card), or start them with torchrun --nproc_per_node=N -m
yt8m_tpu_torch.cli.train ...; --batch_size is the global batch, and
--fsdp_min_size=E shards every variable of E elements or more.
--model_parallel=mp trains tensor-parallel on the same ranks, a
(ranks / mp) x mp grid: the head kernels and DBoF's cluster layer are
sharded on their columns over each group of mp ranks, which step on the
same rows (parallel/tensor.py); mp must divide the ranks. Each rank gets
the same argv, under --num_devices and under torchrun alike.
"""

from __future__ import annotations

import logging
import sys

from yt8m_tpu_torch.config import TrainConfig
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.parallel.distributed import LOG_FORMAT, run_on_ranks
from yt8m_tpu_torch.train.loop import Trainer
from yt8m_tpu_torch.utils.flags import parse_into


def train(argv) -> int:
    """One rank's run (the whole run on one device): the last step."""
    cfg, _ = parse_into(TrainConfig, argv, hparams_cls=ModelHParams)
    return Trainer(cfg).run()


def main(argv=None, **launch_options) -> int:
    """`launch_options` go to the launcher of spawned ranks
    (parallel/distributed.py :: launch: init_method, the store, by default
    a file in a new temporary directory; backend; timeout_s, by default
    none)."""
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, _ = parse_into(TrainConfig, argv, hparams_cls=ModelHParams)
    if not cfg.train_data_pattern:
        raise SystemExit("--train_data_pattern is required")
    return run_on_ranks(train, (argv,), cfg.num_devices, cfg.device,
                        **launch_options)


if __name__ == "__main__":
    main(sys.argv[1:])
