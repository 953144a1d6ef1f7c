"""Training loop (reference: train.py :: Trainer; the JAX package's
train/loop.py), on one device.

Reader (shuffled, --num_epochs) -> batches on cfg.device -> make_train_step
-> a checkpoint every --save_checkpoint_every_n_steps (and at the end)
-> every --log_every_n_steps the reference's log line (Loss, Examples/sec,
and Hit@1, PERR and GAP of the training batch) and its summary scalars.

Restarting in the same train_dir resumes from the latest checkpoint
(model, optimizer, step, EMA); the data iterator starts over, as the JAX
Trainer's does. The frame-sampling generator of a step is seeded from
(seed + 1, step), as the JAX Trainer folds the step into its key, so a
resumed run samples the frames the uninterrupted run would have.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from yt8m_tpu_torch.config import TrainConfig
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.metrics import (
    calculate_gap,
    calculate_hit_at_one,
    calculate_precision_at_equal_recall_rate,
)
from yt8m_tpu_torch.models import get_model
from yt8m_tpu_torch.train import losses as losses_lib
from yt8m_tpu_torch.train.checkpoint import (
    CheckpointManager,
    maybe_wipe_train_dir,
)
from yt8m_tpu_torch.train.state import TrainState
from yt8m_tpu_torch.train.step import make_train_step
from yt8m_tpu_torch.utils.summary import SummaryWriter

log = logging.getLogger("yt8m_tpu_torch.train")

BATCH_KEYS = ("features", "labels", "num_frames", "batch_mask")


class NanLossDuringTrainingError(RuntimeError):
    """Training loss went non-finite (reference: the TF1 runtime's
    NanTensorHook raises NanLossDuringTrainingError and stops the run
    rather than writing NaN checkpoints)."""


def check_loss_finite(loss: float, step: int, fail_on_nan: bool) -> None:
    """Raise (or log, if fail_on_nan is False) on a non-finite loss.
    Checked where the loss is fetched for the log line, so the error
    names the last logged step for rollback."""
    if np.isfinite(loss):
        return
    msg = (
        f"model diverged with loss = {loss} at step {step}; "
        f"roll back to a checkpoint before this step "
        f"(--fail_on_nan_loss=False to keep going anyway)"
    )
    if fail_on_nan:
        raise NanLossDuringTrainingError(msg)
    log.error(msg)


def reader_config_from(cfg) -> ReaderConfig:
    return ReaderConfig(
        feature_names=cfg.feature_names,
        feature_sizes=cfg.feature_sizes,
        frame_features=cfg.frame_features,
        num_classes=cfg.num_classes,
        max_frames=cfg.max_frames,
    )


def to_device(batch: dict, device) -> dict:
    """The tensors of a reader batch on `device` (the ids stay behind)."""
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS}


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The frame-sampling generator of `step`, seeded from (seed, step)."""
    value = np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(value))


class Trainer:
    def __init__(self, config: TrainConfig):
        self.config = cfg = config
        maybe_wipe_train_dir(cfg.train_dir, cfg.start_new_model)
        self.hparams = cfg.resolved_hparams()
        if cfg.use_ema_weights and cfg.ema_decay <= 0:
            # Without --ema_decay no EMA is kept, so --use_ema_weights
            # would serve raw weights (the serving restore raises the same).
            raise SystemExit(
                "--use_ema_weights requires training with --ema_decay > 0")
        self.device = resolve_device(cfg.device)
        self.model = get_model(cfg.model, self.hparams)
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        self.model.to(self.device).train()
        loss_kw = ({"alpha": cfg.distill_alpha}
                   if cfg.label_loss == "MixedCrossEntropyDistillLoss"
                   else {})
        self.loss_obj = losses_lib.get_loss(cfg.label_loss, **loss_kw)
        self.data_iterator = BatchIterator(
            cfg.train_data_pattern, reader_config_from(cfg),
            batch_size=cfg.batch_size, shuffle=True,
            num_epochs=cfg.num_epochs, seed=cfg.seed, pad_final_batch=True)
        self.state = TrainState(
            self.model, optimizer=cfg.optimizer,
            base_learning_rate=cfg.base_learning_rate,
            learning_rate_decay=cfg.learning_rate_decay,
            learning_rate_decay_examples=cfg.learning_rate_decay_examples,
            global_batch_size=cfg.batch_size,
            clip_gradient_norm=cfg.clip_gradient_norm,
            ema=cfg.ema_decay > 0)
        self.train_step = make_train_step(
            self.loss_obj, regularization_penalty=cfg.regularization_penalty,
            aux_loss_weight=self.hparams.chain_aux_loss_weight,
            ema_decay=cfg.ema_decay)
        self.ckpt = CheckpointManager(
            cfg.train_dir, max_to_keep=cfg.max_checkpoints_to_keep,
            save_interval_steps=cfg.save_checkpoint_every_n_steps)
        self.summary = SummaryWriter(cfg.train_dir)
        self._write_model_flags()

    def _write_model_flags(self) -> None:
        """model_flags.json in the JAX trainer's format, from which eval
        and inference of either package rebuild the run's model."""
        cfg = self.config
        payload = {
            "model": cfg.model,
            "frame_features": cfg.frame_features,
            "feature_names": cfg.feature_names,
            "feature_sizes": cfg.feature_sizes,
            "num_classes": cfg.num_classes,
            "max_frames": cfg.max_frames,
            "label_loss": cfg.label_loss,
            "hparams": dataclasses.asdict(self.hparams),
        }
        with open(os.path.join(cfg.train_dir, "model_flags.json"), "w") as f:
            json.dump(payload, f, indent=1)

    def restore(self) -> int:
        """Resume from the latest checkpoint, if any; the step to go on
        from."""
        state = self.state
        latest = self.ckpt.latest_step()
        if latest is not None:
            log.info("restoring checkpoint at step %d", latest)
            self.ckpt.restore(state, latest, for_write=True)
            if self.config.ema_decay > 0 and state.ema is None:
                # A pre-EMA checkpoint with EMA newly enabled: seed the
                # average from the restored parameters.
                state.ema = {n: p.detach().to(torch.float32).clone()
                             for n, p in self.model.named_parameters()}
        return state.step

    def _log(self, step, metrics, batch, examples, seconds) -> None:
        cfg = self.config
        loss = float(metrics["loss"].item())
        check_loss_finite(loss, step, cfg.fail_on_nan_loss)
        eps = examples / max(seconds, 1e-9)
        mask = batch["batch_mask"] > 0
        preds = metrics["predictions"].float().cpu().numpy()[mask]
        labels = batch["labels"][mask]
        hit1 = calculate_hit_at_one(preds, labels)
        perr = calculate_precision_at_equal_recall_rate(preds, labels)
        gap = calculate_gap(preds, labels)
        log.info(
            "training step %d | Loss: %.5f Examples/sec: %.2f | "
            "Hit@1: %.4f PERR: %.4f GAP: %.4f",
            step, loss, eps, hit1, perr, gap,
        )
        self.summary.add_global_step_summary(step, {
            "Loss": loss, "Examples_Second": eps, "Hit@1": hit1,
            "PERR": perr, "GAP": gap,
        })

    def run(self) -> int:
        """Train to --max_steps or the end of the data; the last step."""
        cfg = self.config
        state = self.state
        step = None
        t_log = time.time()
        examples_since_log = 0
        profiler = None
        # A final checkpoint is written only when the loop ends normally:
        # a diverged state must not be persisted.
        try:
            for batch in self.data_iterator:
                if step is None:
                    step = self.restore()
                if cfg.max_steps is not None and step >= cfg.max_steps:
                    break
                if cfg.profile_dir and step == 10 and profiler is None:
                    profiler = self._start_profiler()
                generator = step_generator(cfg.seed + 1, step, self.device)
                state, metrics = self.train_step(
                    state, to_device(batch, self.device), generator)
                step += 1
                examples_since_log += int(batch["batch_mask"].sum())
                if profiler is not None and step == 20:
                    self._stop_profiler(profiler)
                    profiler = None
                if step % cfg.log_every_n_steps == 0:
                    self._log(step, metrics, batch, examples_since_log,
                              time.time() - t_log)
                    t_log = time.time()
                    examples_since_log = 0
                self.ckpt.save(step, state)
            if step is not None:
                self.ckpt.force_save(step, state)
        finally:
            if profiler is not None:
                self._stop_profiler(profiler)
            self.summary.close()
        log.info("training complete at step %s", step)
        return step if step is not None else 0

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profiler(self, profiler) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        path = os.path.join(self.config.profile_dir, "trace.json")
        profiler.export_chrome_trace(path)
        log.info("profile of steps 10-20 written to %s", path)
