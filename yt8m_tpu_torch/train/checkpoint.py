"""Checkpoints of the port's trainer (reference: tf.train.Saver under
Supervisor, plus the --start_new_model wipe; the JAX package's
train/checkpoint.py keeps them with orbax).

One directory per step under train_dir, named by the step as orbax names
them:

    train_dir/<step>/model.pt      the model's state_dict (parameters and
                                   BatchNorm statistics), CPU tensors
    train_dir/<step>/optimizer.pt  optimizer.state_dict()
    train_dir/<step>/ema.pt        {name: f32 tensor}, when the run keeps an EMA
    train_dir/<step>/step.json     {"step": <step>}, written last

A step is written into a hidden temporary directory that `os.replace`
renames into place, so a crash leaves the previous step as the latest.
Restarting resumes from the latest step, as Supervisor's auto-recovery
did. `save` writes every `save_interval_steps` steps (orbax's rule: the
step is a multiple of the interval and later than the latest), and
rotation keeps the newest `max_to_keep`.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import List, Optional

import torch

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
EMA_FILE = "ema.pt"
STEP_FILE = "step.json"

log = logging.getLogger("yt8m_tpu_torch.checkpoint")


def _to_host(obj):
    """A copy of a (nested) state dict with every tensor on the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu")
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, name))
               for name in os.listdir(path))


def step_dirs(directory: str) -> List[int]:
    """The complete steps under `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(name) for name in os.listdir(directory)
        if name.isdigit()
        and os.path.exists(os.path.join(directory, name, STEP_FILE))
    )


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 1):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(int(save_interval_steps), 1)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return step_dirs(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return step % self.save_interval_steps == 0

    def save(self, step: int, state) -> bool:
        """Write `state` (a TrainState) at `step` if the interval says so."""
        if not self.should_save(step):
            return False
        self._write(step, state)
        return True

    def force_save(self, step: int, state) -> bool:
        """Write `state` at `step` unless that step is already written."""
        if step in self.all_steps():
            return False
        self._write(step, state)
        return True

    def _write(self, step: int, state) -> None:
        t0 = time.perf_counter()
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(_to_host(state.model.state_dict()),
                       os.path.join(tmp, MODEL_FILE))
            torch.save(_to_host(state.optimizer.state_dict()),
                       os.path.join(tmp, OPTIMIZER_FILE))
            if state.ema is not None:
                torch.save(_to_host(state.ema), os.path.join(tmp, EMA_FILE))
            with open(os.path.join(tmp, STEP_FILE), "w") as f:
                json.dump({"step": int(step)}, f)
            os.replace(tmp, self.path(step))
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        log.info("saved checkpoint step %d (%.3f GB) in %.2f s", step,
                 dir_bytes(self.path(step)) / 1e9, time.perf_counter() - t0)
        if self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.path(old), ignore_errors=True)

    def restore(self, state, step: Optional[int] = None, *,
                for_write: bool = False):
        """Load the model, the optimizer, the step and the EMA at `step`
        (default the latest) into `state` (a TrainState) and return it.

        EMA presence may differ between the checkpoint and `state`, as in
        the JAX package: a checkpoint without one sets `state.ema` to None
        (the trainer then seeds it from the restored parameters); one whose
        EMA `state` does not keep drops it, with a warning when the restore
        resumes training in this directory (`for_write`: rotation will
        delete the older steps that still hold it), else at info."""
        t0 = time.perf_counter()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self.path(step)
        if not os.path.exists(os.path.join(path, STEP_FILE)):
            raise FileNotFoundError(f"no checkpoint at step {step} in "
                                    f"{self.directory}")
        state.model.load_state_dict(_load(path, MODEL_FILE))
        state.optimizer.load_state_dict(_load(path, OPTIMIZER_FILE))
        state.step = int(step)
        has_ema = os.path.exists(os.path.join(path, EMA_FILE))
        if not has_ema:
            state.ema = None
        elif state.ema is not None:
            device = next(iter(state.ema.values())).device
            for name, value in _load(path, EMA_FILE).items():
                state.ema[name].copy_(value.to(device))
        else:
            if for_write:
                log.warning(
                    "checkpoint step %s carries EMA params but the resumed "
                    "run was configured without them (--ema_decay=0); the "
                    "Polyak average is DROPPED and will be lost from new "
                    "checkpoints", step)
            else:
                log.info("checkpoint step %s carries EMA params; using raw "
                         "weights (pass --use_ema_weights to serve the "
                         "Polyak average)", step)
        state.model.invalidate_serving()
        log.info("restored checkpoint step %d in %.2f s", step,
                 time.perf_counter() - t0)
        return state


def _load(path: str, name: str):
    return torch.load(os.path.join(path, name), map_location="cpu",
                      weights_only=True)


def restore_model(model, train_dir: str, step: Optional[int] = None,
                  use_ema_weights: bool = False) -> Optional[int]:
    """Load the weights of `train_dir` into `model` for eval or inference
    and return the step they came from: the step directory `step`, else
    the latest, else (no step directory) a flat `train_dir/model.pt`,
    whose step is None. With `use_ema_weights` the parameters are the
    checkpoint's EMA (BatchNorm statistics stay the raw ones, as the JAX
    package serves them); a checkpoint without one raises."""
    steps = step_dirs(train_dir)
    if step is None and steps:
        step = steps[-1]
    if step is None:
        flat = os.path.join(train_dir, MODEL_FILE)
        if not os.path.exists(flat):
            raise FileNotFoundError(f"no checkpoint in {train_dir}")
        if use_ema_weights:
            raise SystemExit(f"--use_ema_weights: {train_dir} has no EMA "
                             f"params (train with --ema_decay > 0)")
        model.load_state_dict(_load(train_dir, MODEL_FILE))
        return None
    path = os.path.join(train_dir, str(step))
    if step not in steps:
        raise FileNotFoundError(f"no checkpoint at step {step} in "
                                f"{train_dir} (have {steps})")
    model.load_state_dict(_load(path, MODEL_FILE))
    has_ema = os.path.exists(os.path.join(path, EMA_FILE))
    if use_ema_weights:
        if not has_ema:
            raise SystemExit(f"--use_ema_weights: {train_dir} has no EMA "
                             f"params (train with --ema_decay > 0)")
        params = dict(model.named_parameters())
        with torch.no_grad():
            for name, value in _load(path, EMA_FILE).items():
                params[name].copy_(value)
    elif has_ema:
        log.info("checkpoint step %s carries EMA params; using raw weights "
                 "(pass --use_ema_weights to serve the Polyak average)", step)
    return step


def maybe_wipe_train_dir(train_dir: str, start_new_model: bool) -> None:
    """--start_new_model semantics (reference train.py removes the dir)."""
    if start_new_model and os.path.isdir(train_dir):
        shutil.rmtree(train_dir)
