"""Training loop (reference: train.py :: Trainer; the JAX package's
train/loop.py), on one device or one rank a card.

Reader (make_batch_iterator: the native parser, shuffled by file, with
--num_readers threads or --reader_processes; --num_epochs; the teacher
feature under --distill_data_pattern; example weights under
--boost_weights_file) -> batches on cfg.device -> make_train_step
-> a checkpoint every --save_checkpoint_every_n_steps (and at the end;
written by a background thread with --async_checkpoint)
-> every --log_every_n_steps the reference's log line (Loss, Examples/sec,
and Hit@1, PERR and GAP of the training batch) and its summary scalars.

Restarting in the same train_dir resumes from the latest checkpoint
(model, optimizer, step, EMA); the data iterator starts over, as the JAX
Trainer's does. The frame-sampling generator of a step is seeded from
(seed + 1, step), as the JAX Trainer folds the step into its key, so a
resumed run samples the frames the uninterrupted run would have.

In a multi-GPU run (parallel/distributed.py: torchrun, or --num_devices
through the CLI's launcher) each rank reads its files
(shard_files(files, rank, world)) at batch_size // world with seed
cfg.seed + rank, and steps with make_parallel_train_step on a
ParallelTrainState (--fsdp_min_size shards the large variables). The
training model's BatchNorm moments are cross-replica (hparams.bn_axis,
set on the training model only and never recorded). The frame-sampling
generator is seeded from (seed + 1, step, rank), as the JAX manual step
folds in the axis index. The run goes on while any rank has data; a rank
whose files are done (or that got none) steps on batches of padding,
which contribute nothing. Only rank 0 logs, writes the summaries and
model_flags.json, checkpoints (the one-card format) and exports; the
loss is global and Examples/sec counts the global batch; the training
batch's Hit@1, PERR and GAP are rank 0's rows'.

With --model_parallel=mp the ranks form a (data, model) grid
(parallel/distributed.py :: use_grid; mp must divide the ranks) and the
step is the JAX package's GSPMD step, the one-device step at the global
batch: the head kernels and DBoF's cluster layer are sharded on their
columns over each model group (train/state.py), the trainable kernels
keep running. The first rank of each model group reads its data block's
files (shard_files over the data blocks, batch_size // data blocks, seed
cfg.seed + data index) and broadcasts each batch to its model group; the
frame sampling draws the global batch's uniforms from (seed + 1, step)
and keeps the data block's rows (frame_utils.GlobalDraw); the BatchNorm
moments span the data group where there are several data blocks.
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
from yt8m_tpu_torch.data.pipeline import make_batch_iterator, reader_kind
from yt8m_tpu_torch.data.readers import ReaderConfig
from yt8m_tpu_torch.data.tfrecord import glob_files, shard_files
from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.metrics import (
    calculate_gap,
    calculate_hit_at_one,
    calculate_precision_at_equal_recall_rate,
)
from yt8m_tpu_torch.models import get_model, is_frame_level_model
from yt8m_tpu_torch.models.frame_utils import GlobalDraw
from yt8m_tpu_torch.parallel import distributed
from yt8m_tpu_torch.parallel.mesh import DATA_AXIS
from yt8m_tpu_torch.train import losses as losses_lib
from yt8m_tpu_torch.train.checkpoint import (
    CheckpointManager,
    maybe_wipe_train_dir,
)
from yt8m_tpu_torch.train.state import ParallelTrainState, TrainState
from yt8m_tpu_torch.train.step import (
    make_parallel_train_step,
    make_train_step,
)
from yt8m_tpu_torch.utils.summary import SummaryWriter

log = logging.getLogger("yt8m_tpu_torch.train")

BATCH_KEYS = ("features", "labels", "num_frames", "batch_mask")
# Keys a batch carries only sometimes: the teacher's predictions
# (distillation) and per-video loss weights (boosting).
OPTIONAL_BATCH_KEYS = ("teacher", "example_weights")


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
    """The reader of a run's config; --distill_data_pattern reads the
    records' "predictions" feature as the batch's teacher."""
    rc = ReaderConfig(
        feature_names=cfg.feature_names,
        feature_sizes=cfg.feature_sizes,
        frame_features=cfg.frame_features,
        num_classes=cfg.num_classes,
        max_frames=cfg.max_frames,
    )
    if getattr(cfg, "distill_data_pattern", ""):
        rc.distill_feature = "predictions"
        rc.distill_dim = cfg.num_classes
    return rc


def to_device(batch: dict, device) -> dict:
    """The tensors of a reader batch on `device` (the ids stay behind),
    with its teacher and example weights where it has them."""
    keys = BATCH_KEYS + tuple(k for k in OPTIONAL_BATCH_KEYS if k in batch)
    return {k: torch.from_numpy(batch[k]).to(device) for k in keys}


def step_generator(seed: int, step: int, device,
                   rank=None) -> torch.Generator:
    """The frame-sampling generator of `step`, seeded from (seed, step),
    or from (seed, step, rank) for one rank of a multi-GPU run."""
    entropy = [seed, step] + ([] if rank is None else [rank])
    value = np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(value))


def padding_batch(rc: ReaderConfig, batch_size: int, boosted: bool) -> dict:
    """A batch of padding rows as the reader pads a final batch (zero
    features, labels and teacher, no frames, mask 0; weights 1 where the
    run is boosted)."""
    if rc.frame_features:
        feats = np.zeros((batch_size, rc.max_frames, rc.feature_dim),
                         np.uint8)
        num_frames = np.zeros((batch_size,), np.int32)
    else:
        feats = np.zeros((batch_size, rc.feature_dim), np.float32)
        num_frames = np.ones((batch_size,), np.int32)
    batch = {"id": [b""] * batch_size, "features": feats,
             "labels": np.zeros((batch_size, rc.num_classes), np.float32),
             "num_frames": num_frames,
             "batch_mask": np.zeros((batch_size,), np.float32)}
    if rc.distill_feature:
        batch["teacher"] = np.zeros((batch_size, rc.distill_dim), np.float32)
    if boosted:
        batch["example_weights"] = np.ones((batch_size,), np.float32)
    return batch


class Trainer:
    def __init__(self, config: TrainConfig):
        self.config = cfg = config
        self.hparams = cfg.resolved_hparams()
        if cfg.use_ema_weights and cfg.ema_decay <= 0:
            # Without --ema_decay no EMA is kept, so --use_ema_weights
            # would serve raw weights (the serving restore raises the same).
            raise SystemExit(
                "--use_ema_weights requires training with --ema_decay > 0")
        self.world = distributed.process_count()
        self.rank = distributed.process_index()
        # The (data, model) grid; raises where mp does not divide the
        # ranks, a single rank included.
        self.grid = distributed.use_grid(cfg.model_parallel)
        self.device = distributed.rank_device(resolve_device(cfg.device))
        if self.rank == 0:
            maybe_wipe_train_dir(cfg.train_dir, cfg.start_new_model)
            if cfg.model_parallel > 1:
                log.warning(
                    "--model_parallel=%d shards only the head kernels and "
                    "DBoF's cluster layer (a block of their columns, with "
                    "its gradient, optimizer state and EMA, a rank) and "
                    "gathers their outputs every step; --fsdp_min_size "
                    "shards any large variable and is the JAX package's "
                    "recommended route (docs/FLAGS.md --model_parallel). "
                    "Both keep the trainable kernels here; PERF.md has the "
                    "card's step times of both", cfg.model_parallel)
        if self.world > 1:
            distributed.barrier()
        # The training model's BatchNorm moments span the data blocks;
        # the recorded hparams (model_flags.json, exports) keep the
        # user's.
        train_hparams = (self.hparams.replace(bn_axis=DATA_AXIS)
                         if self.grid.data > 1 else self.hparams)
        self.model = get_model(cfg.model, train_hparams)
        if is_frame_level_model(cfg.model) != cfg.frame_features:
            log.warning("model %s frame-level=%s but --frame_features=%s",
                        cfg.model, is_frame_level_model(cfg.model),
                        cfg.frame_features)
        self.model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
        self.model.to(self.device).train()
        loss_kw = ({"alpha": cfg.distill_alpha}
                   if cfg.label_loss == "MixedCrossEntropyDistillLoss"
                   else {})
        self.loss_obj = losses_lib.get_loss(cfg.label_loss, **loss_kw)
        files, self.rank_batch, seed = (cfg.train_data_pattern,
                                        cfg.batch_size, cfg.seed)
        g = self.grid
        if self.world > 1:
            # Each data block reads its own files at its share of the
            # batch, through its model group's first rank; a block
            # without a file steps on padding (_batches).
            files = (shard_files(glob_files(files), g.data_index, g.data)
                     if g.model_index == 0 else [])
            self.rank_batch = distributed.per_host_batch(cfg.batch_size,
                                                         g.data)
            seed += g.data_index
        self.data_iterator = make_batch_iterator(
            files, reader_config_from(cfg), batch_size=self.rank_batch,
            num_readers=cfg.num_readers,
            reader_processes=cfg.reader_processes, shuffle=True,
            num_epochs=cfg.num_epochs, seed=seed,
            pad_final_batch=True) if files else []
        if cfg.boost_weights_file:
            from yt8m_tpu_torch.ensemble.boosting import (
                BoostedIterator,
                load_boost_weights,
            )

            self.data_iterator = BoostedIterator(
                self.data_iterator, load_boost_weights(cfg.boost_weights_file))
        self.reader = reader_kind(self.data_iterator)
        log.info("reading %s with the %s reader", cfg.train_data_pattern,
                 self.reader)
        state_cls, make_step, sharding = TrainState, make_train_step, {}
        if self.world > 1:
            state_cls, make_step = ParallelTrainState, make_parallel_train_step
            sharding = {"fsdp_min_size": cfg.fsdp_min_size,
                        "model_parallel": cfg.model_parallel}
        self.state = state_cls(
            self.model, **sharding, optimizer=cfg.optimizer,
            base_learning_rate=cfg.base_learning_rate,
            learning_rate_decay=cfg.learning_rate_decay,
            learning_rate_decay_examples=cfg.learning_rate_decay_examples,
            global_batch_size=cfg.batch_size,
            clip_gradient_norm=cfg.clip_gradient_norm,
            ema=cfg.ema_decay > 0, adam_mu_dtype=cfg.adam_mu_dtype)
        self.train_step = make_step(
            self.loss_obj, regularization_penalty=cfg.regularization_penalty,
            aux_loss_weight=self.hparams.chain_aux_loss_weight,
            ema_decay=cfg.ema_decay)
        self.ckpt = CheckpointManager(
            cfg.train_dir, max_to_keep=cfg.max_checkpoints_to_keep,
            save_interval_steps=cfg.save_checkpoint_every_n_steps,
            async_save=cfg.async_checkpoint)
        self.summary = (SummaryWriter(cfg.train_dir) if self.rank == 0
                        else None)
        self._warned_raw_export = False
        self._shapes = None  # a model group's batch shapes, on first use
        if self.rank == 0:
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
                state.ema = state.fresh_ema()
        return state.step

    def _log(self, step, metrics, batch, examples, seconds) -> None:
        cfg = self.config
        loss = float(metrics["loss"].item())
        check_loss_finite(loss, step, cfg.fail_on_nan_loss)
        if self.world > 1:
            examples = int(distributed.host_all_reduce([examples])[0])
        if self.rank != 0:
            return
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

    def _device_batch(self, batch: dict) -> dict:
        """`batch` on the device; on a model group, its first rank's
        batch on every rank of the group (the others' are padding)."""
        g = self.grid
        if g.model == 1:
            return to_device(batch, self.device)
        if self._shapes is None:
            template = to_device(padding_batch(
                reader_config_from(self.config), 1,
                bool(self.config.boost_weights_file)), "cpu")
            self._shapes = {k: ((self.rank_batch,) + tuple(v.shape[1:]),
                                v.dtype) for k, v in template.items()}
        if g.model_index == 0:
            out = to_device(batch, self.device)
            got = {k: (tuple(v.shape), v.dtype) for k, v in out.items()}
            if got != self._shapes:
                raise ValueError(f"a batch of {got} is not what its model "
                                 f"group expects, {self._shapes}")
        else:
            out = {k: torch.empty(shape, dtype=dtype, device=self.device)
                   for k, (shape, dtype) in self._shapes.items()}
        for k in sorted(out):
            distributed.broadcast_(out[k], g.data_index * g.model,
                                   distributed.model_group())
        return out

    def _batches(self):
        """The reader's batches; in a multi-GPU run, while any rank has
        one, with padding where this rank has none."""
        if self.world == 1:
            yield from self.data_iterator
            return
        it = iter(self.data_iterator)
        while True:
            batch = next(it, None)
            if not distributed.host_all_reduce(
                    [batch is not None], op=torch.distributed.ReduceOp.MAX)[0]:
                return
            if batch is None:
                batch = padding_batch(reader_config_from(self.config),
                                      self.rank_batch,
                                      bool(self.config.boost_weights_file))
            yield batch

    def run(self) -> int:
        """Train to --max_steps or the end of the data; the last step."""
        cfg = self.config
        state = self.state
        step = None
        t_log = time.time()
        examples_since_log = 0
        profiler = None
        # A final checkpoint is written only when the loop ends normally:
        # a diverged state must not be persisted. The writer of
        # --async_checkpoint is drained either way; its failure is raised
        # unless another exception is already on its way out.
        finished = False
        try:
            for batch in self._batches():
                if step is None:
                    step = self.restore()
                if cfg.max_steps is not None and step >= cfg.max_steps:
                    break
                if (cfg.profile_dir and step == 10 and profiler is None
                        and self.rank == 0):
                    profiler = self._start_profiler()
                if self.grid.model > 1:
                    # The global batch's draws, this data block's rows.
                    generator = GlobalDraw(
                        step_generator(cfg.seed + 1, step, self.device),
                        self.grid.data_index * self.rank_batch,
                        cfg.batch_size)
                else:
                    generator = step_generator(
                        cfg.seed + 1, step, self.device,
                        self.rank if self.world > 1 else None)
                state, metrics = self.train_step(
                    state, self._device_batch(batch), generator)
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
                if (cfg.export_model_steps
                        and step % cfg.export_model_steps == 0):
                    self._export_serving(step)
            if step is not None:
                self.ckpt.force_save(step, state)
            finished = True
        finally:
            self.ckpt.close(raise_errors=finished)
            if profiler is not None:
                self._stop_profiler(profiler)
            if self.summary is not None:
                self.summary.close()
        log.info("training complete at step %s; checkpoint saves held the "
                 "training thread %.3f s (%s s a save)", step,
                 self.ckpt.blocking_seconds,
                 ", ".join(f"{t:.3f}" for t in self.ckpt.held_seconds))
        return step if step is not None else 0

    def _export_serving(self, step: int) -> None:
        """Periodic serving export (reference: export_model.py called from
        the train loop every --export_model_steps) to
        train_dir/export/step_<n>: a serving copy of the model with the
        EMA weights under --use_ema_weights (an --ema_decay run without
        it exports the raw weights and warns once). A failed export is
        logged and training goes on."""
        from yt8m_tpu_torch.infer.export import export_model

        cfg = self.config
        export_dir = os.path.join(cfg.train_dir, "export", f"step_{step}")
        ema = False
        # Every rank takes part in gathering the tensor-parallel blocks.
        weights = self.state.model_state()
        # Every rank takes part in gathering a sharded EMA; rank 0 exports.
        averaged = (self.state.ema_state()
                    if cfg.ema_decay > 0 and cfg.use_ema_weights else None)
        if self.rank != 0:
            return
        if cfg.ema_decay > 0:
            if averaged is not None:
                weights = {**weights, **{
                    name: value.to(weights[name].dtype)
                    for name, value in averaged.items()}}
                ema = True
            elif not self._warned_raw_export:
                log.warning("--ema_decay=%g run exports RAW weights (pass "
                            "--use_ema_weights to export the Polyak "
                            "average)", cfg.ema_decay)
                self._warned_raw_export = True
        try:
            serving = get_model(cfg.model, self.hparams)
            serving.load_state_dict(weights)
            serving.to(self.device).eval()
            export_model(export_dir, cfg.model, self.hparams, serving,
                         ema=ema)
            log.info("exported serving model to %s (ema=%s)", export_dir,
                     ema)
        except Exception:  # an export never stops training
            log.exception("serving export failed at step %d", step)

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
