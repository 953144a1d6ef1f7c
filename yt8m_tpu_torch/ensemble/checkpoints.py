"""Checkpoint ensembles (reference: the fork's checkpoint ensembling; the
JAX package's ensemble/checkpoints.py): average the predictions of
several checkpoints of one run, or average their weights into one model
that serves at the cost of one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import torch

from yt8m_tpu_torch.config import InferenceConfig
from yt8m_tpu_torch.train.checkpoint import CheckpointManager, MODEL_FILE


def _steps(train_dir: str, steps, last_n: int):
    all_steps = CheckpointManager(train_dir).all_steps()
    steps = list(all_steps[-last_n:] if steps is None else steps)
    if not steps:
        raise ValueError(f"no checkpoints in {train_dir}")
    return steps


def ensemble_checkpoint_predictions(
    config: InferenceConfig,
    steps: Optional[Sequence[int]] = None,
    last_n: int = 3,
    output_dir: Optional[str] = None,
    output_csv: Optional[str] = None,
    weights: Optional[Sequence[float]] = None,
):
    """Dense probability dumps of each checkpoint (`steps`, else the last
    `last_n`) through inference, then their weighted average (and the
    CSV with `output_csv`): (ids, [N, C] float32)."""
    from yt8m_tpu_torch.ensemble.average import ensemble_directories
    from yt8m_tpu_torch.infer.predict import inference

    steps = _steps(config.train_dir, steps, last_n)
    output_dir = output_dir or os.path.join(config.train_dir,
                                            "ckpt_ensemble")
    member_dirs = []
    for s in steps:
        member_dir = os.path.join(output_dir, f"step{s}")
        inference(dataclasses.replace(config, checkpoint_step=s,
                                      output_file="",
                                      output_probabilities_dir=member_dir))
        member_dirs.append(member_dir)
    return ensemble_directories(member_dirs, weights=weights,
                                output_csv=output_csv, top_k=config.top_k)


def average_checkpoint_weights(train_dir: str, model: torch.nn.Module,
                               steps: Optional[Sequence[int]] = None,
                               last_n: int = 3) -> torch.nn.Module:
    """Load into `model` the mean of the parameters and BatchNorm
    statistics of checkpoints of one run (`steps`, else the last
    `last_n`), summed in float64 and cast back to each tensor's dtype;
    returns `model`. Neither the optimizer state nor the EMA is read."""
    steps = _steps(train_dir, steps, last_n)
    acc = None
    for s in steps:
        state = torch.load(os.path.join(train_dir, str(s), MODEL_FILE),
                           map_location="cpu", weights_only=True)
        if acc is None:
            dtypes = {k: v.dtype for k, v in state.items()}
            acc = {k: v.to(torch.float64) for k, v in state.items()}
        else:
            for k, v in state.items():
                acc[k] += v.to(torch.float64)
    mean = {k: (v / len(steps)).to(dtypes[k]) for k, v in acc.items()}
    model.load_state_dict(mean)
    model.checkpoint_step = None
    return model
