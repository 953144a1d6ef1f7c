"""Ensemble serving: N member checkpoints in one forward (reference: the
fork's averaged prediction files; the JAX package's
infer/ensemble_serve.py).

EnsembleServe is a model like the zoo's: its forward runs every member
on the same batch and sums w_i * predictions_i in float32 on the device,
so the inference and eval loops serve it as they serve one model (top-k
on the card, dumps, the CSV). ensemble/average.py averages the members'
dump files on the host instead.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence

import torch
from torch import nn

from yt8m_tpu_torch.models import get_model
from yt8m_tpu_torch.models.hparams import RUNTIME_HPARAM_FIELDS
from yt8m_tpu_torch.train.checkpoint import restore_model


class EnsembleServe(nn.Module):
    """The weighted average of member models (serving only); the weights
    are normalised to sum to 1."""

    def __init__(self, models: Sequence[nn.Module], weights: Sequence[float],
                 train_dirs: Sequence[str] = ()):
        super().__init__()
        if len(models) != len(weights):
            raise ValueError("one weight per member required")
        total = float(sum(weights))
        if total <= 0:
            raise ValueError("ensemble weights must sum to > 0")
        self.members = nn.ModuleList(models)
        self.weights = [float(w) / total for w in weights]
        self.train_dirs = list(train_dirs)
        # No single checkpoint step describes an ensemble.
        self.checkpoint_step = None

    def forward(self, features, num_frames, generator=None, u=None):
        if self.training:
            raise ValueError("EnsembleServe is inference-only")
        probs = None
        for model, w in zip(self.members, self.weights):
            out = model(features, num_frames, generator=generator, u=u)
            contrib = w * out["predictions"].to(torch.float32)
            probs = contrib if probs is None else probs + contrib
        return {"predictions": probs}


def _member_run_config(train_dir: str):
    """(model name or None, recorded hparams) of a member run's
    model_flags.json; (None, {}) where the run has none."""
    path = os.path.join(train_dir, "model_flags.json")
    if not os.path.exists(path):
        return None, {}
    with open(path) as f:
        data = json.load(f)
    return data.get("model"), data.get("hparams", {})


def _split(flag: str) -> List[str]:
    return [x for x in flag.split(",") if x]


def build_ensemble(cfg, device, step: Optional[int] = None) -> EnsembleServe:
    """The EnsembleServe of --ensemble_train_dirs, its members' weights
    restored on `device`, in eval mode.

    Members may differ in family and width: each is rebuilt from its own
    run's model_flags.json (its model, its structural hparams; the
    runtime knobs of RUNTIME_HPARAM_FIELDS stay the CLI's), or from the
    CLI's --model where a run has none; --ensemble_models names override
    the recorded ones. They must share the CLI's feature_dim, max_frames
    and vocab_size. Each restores its weights only (its EMA with
    --use_ema_weights) at `step`, else its latest checkpoint; the
    optimizer state is never read. --ensemble_weights default to
    uniform.
    """
    dirs = _split(cfg.ensemble_train_dirs)
    names = _split(cfg.ensemble_models) if cfg.ensemble_models else None
    if names and len(names) != len(dirs):
        raise SystemExit(f"--ensemble_models has {len(names)} entries for "
                         f"{len(dirs)} --ensemble_train_dirs")
    weights = ([float(w) for w in _split(cfg.ensemble_weights)]
               if cfg.ensemble_weights else [1.0] * len(dirs))
    if len(weights) != len(dirs):
        raise SystemExit(f"--ensemble_weights has {len(weights)} entries "
                         f"for {len(dirs)} --ensemble_train_dirs")
    run_hp = cfg.resolved_hparams()
    hp_fields = {f.name for f in dataclasses.fields(run_hp)}
    models = []
    for i, d in enumerate(dirs):
        recorded, overrides = _member_run_config(d)
        name = names[i] if names else (recorded or cfg.model)
        hp = run_hp.replace(**{
            k: v for k, v in overrides.items()
            if k in hp_fields and k not in RUNTIME_HPARAM_FIELDS})
        for field in ("feature_dim", "max_frames", "vocab_size"):
            if getattr(hp, field) != getattr(run_hp, field):
                raise SystemExit(
                    f"ensemble member {d}: {field}={getattr(hp, field)} "
                    f"does not match the run's {getattr(run_hp, field)} — "
                    "members must share the input/output contract")
        model = get_model(name, hp)
        restore_model(model, d, step, cfg.use_ema_weights)
        models.append(model)
    return EnsembleServe(models, weights, train_dirs=dirs).to(device).eval()
