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
rotation keeps the newest `max_to_keep`. A step converted from a JAX
run may hold no optimizer.pt (convert.py converts Adam's state only):
the trainer then refuses to resume from it.

With `async_save` (--async_checkpoint; the JAX package passes it to
orbax as `async_save`), `save` copies the state to host tensors before
it returns, and one background writer serialises and writes the step
while training goes on. A save issued while one is in flight waits for
it, so steps are written in order; `force_save` and `close` drain the
writer, so a run's last step is on disk when the trainer returns. An
exception of the writer is raised on the caller's thread at the next
save, force_save or close. `held_seconds` lists the time each save and
force_save held the caller (the copy, any wait for the writer, and the
write itself when it is synchronous); `blocking_seconds` is their sum.

In a multi-GPU run every rank holds a TrainState and makes the same
saves; rank 0 alone writes, in the format a one-card run writes: the
model, the optimizer state and the EMA gathered from the sharded
variables' blocks (ParallelTrainState: the FSDP blocks over the data
group, the tensor-parallel blocks, which the model itself holds, over
the model group).
Whether a step is due is rank 0's decision, sent to the others, and
every rank waits at a barrier after each save. A restore reads the same
files on every rank and re-shards them, so a checkpoint moves between
one card and N ranks either way.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional

import torch

from yt8m_tpu_torch.parallel import distributed

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"
EMA_FILE = "ema.pt"
STEP_FILE = "step.json"

log = logging.getLogger("yt8m_tpu_torch.checkpoint")


def _to_host(obj):
    """A copy of a (nested) state dict with every tensor copied to the
    CPU (CPU tensors too: the copy does not change when training goes on
    writing the originals)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def snapshot(state, keep: bool = True) -> Optional[Dict[str, object]]:
    """The files of a step from a TrainState: host copies of the model's
    and the optimizer's state dicts and of the EMA. In a multi-GPU run
    every rank takes part in the gathers and only rank 0 keeps the
    copies (`keep`); the others get None."""
    model = state.model_state()
    optimizer = state.optimizer_state()
    ema = state.ema_state()
    if not keep:
        return None
    files = {MODEL_FILE: _to_host(model),
             OPTIMIZER_FILE: _to_host(optimizer)}
    if ema is not None:
        files[EMA_FILE] = _to_host(ema)
    return files


def write_step(directory: str, step: int, files: Mapping[str, object]) -> str:
    """Write `files` ({name: object for torch.save}) and step.json, last,
    as directory/<step>/ through a hidden temporary directory that
    os.replace renames into place; the step's path."""
    path = os.path.join(directory, str(step))
    tmp = os.path.join(directory, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        for name, obj in files.items():
            torch.save(obj, os.path.join(tmp, name))
        with open(os.path.join(tmp, STEP_FILE), "w") as f:
            json.dump({"step": int(step)}, f)
        os.replace(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


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
                 save_interval_steps: int = 1, async_save: bool = False):
        self.world = distributed.process_count()
        self.writer = distributed.process_index() == 0
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(int(save_interval_steps), 1)
        self.async_save = async_save
        self.held_seconds: List[float] = []
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: Optional[Future] = None
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return step_dirs(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def should_save(self, step: int) -> bool:
        if step % self.save_interval_steps:
            return False
        return distributed.agreed(lambda: self._later_than_latest(step))

    def _later_than_latest(self, step: int) -> bool:
        latest = self.latest_step()
        return latest is None or latest < step

    def _barrier(self) -> None:
        if self.world > 1:
            distributed.barrier()

    @property
    def blocking_seconds(self) -> float:
        return sum(self.held_seconds)

    def save(self, step: int, state) -> bool:
        """Write `state` (a TrainState) at `step` if the interval says so."""
        if not self.should_save(step):
            return False
        t0 = time.perf_counter()
        try:
            self._write(step, state)
        finally:
            self.held_seconds.append(time.perf_counter() - t0)
        return True

    def force_save(self, step: int, state) -> bool:
        """Write `state` at `step` unless that step is already written; in
        either case every write has finished when it returns."""
        t0 = time.perf_counter()
        try:
            self.wait()
            if distributed.agreed(lambda: step in self.all_steps()):
                return False
            self._write(step, state)
            self.wait()
            self._barrier()
            return True
        finally:
            self.held_seconds.append(time.perf_counter() - t0)

    def wait(self) -> None:
        """Wait for the write in flight, if any, and raise its exception."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self, raise_errors: bool = True) -> None:
        """Drain the writer and stop its thread. With raise_errors False a
        failed write is logged, not raised (the caller is already
        unwinding from another exception). The manager stays usable: a
        later async save starts a new writer."""
        try:
            self.wait()
        except Exception:
            if raise_errors:
                raise
            log.exception("the checkpoint writer failed")
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None

    def _write(self, step: int, state) -> None:
        self.wait()  # a save waits for the one in flight: steps in order
        t0 = time.perf_counter()
        files = snapshot(state, keep=self.writer)
        if not self.writer:
            pass
        elif self.async_save:
            if self._writer is None:
                self._writer = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="checkpoint-writer")
            self._pending = self._writer.submit(self._commit, step, files,
                                                time.perf_counter())
        else:
            self._commit(step, files, t0)
        self._barrier()

    def _commit(self, step: int, files, t0: float) -> None:
        path = write_step(self.directory, step, files)
        log.info("saved checkpoint step %d (%.3f GB) in %.2f s", step,
                 dir_bytes(path) / 1e9, time.perf_counter() - t0)
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
        if not os.path.exists(os.path.join(path, OPTIMIZER_FILE)):
            raise FileNotFoundError(
                f"step {step} in {self.directory} holds no {OPTIMIZER_FILE}: "
                f"its weights were converted from a JAX run without their "
                f"optimizer state (scripts/convert_jax_checkpoint.py converts "
                f"Adam's only), and a fresh optimizer would not resume that "
                f"run; serve the step with cli.eval or cli.inference")
        state.load_model_state(_load(path, MODEL_FILE))
        state.load_optimizer_state(_load(path, OPTIMIZER_FILE))
        state.step = int(step)
        has_ema = os.path.exists(os.path.join(path, EMA_FILE))
        if not has_ema:
            state.ema = None
        elif state.ema is not None:
            state.load_ema(_load(path, EMA_FILE))
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
