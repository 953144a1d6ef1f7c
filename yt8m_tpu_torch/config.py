"""Run configuration of the port's train, eval and inference CLIs: the
reference's flag names and the JAX package's defaults (reference:
train.py, eval.py, inference.py flags), plus `device` (default "cuda").

Flags of features the port does not have yet are kept under their names
and raise ValueError when set to anything but their default, so that no
such flag is silently ignored (UNPORTED lists them, with what they would
need).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from yt8m_tpu_torch.data.features import get_feature_names_and_sizes
from yt8m_tpu_torch.models.hparams import ModelHParams

# flag -> why it raises. `num_devices` and `num_readers` raise above 1.
UNPORTED = {
    "model_parallel": "tensor-parallel training (one device)",
    "fsdp_min_size": "FSDP (one device)",
    "num_devices": "multi-device training (one device)",
    "distill_data_pattern": "distillation (no teacher reader)",
    "boost_weights_file": "boosting weights",
    "export_model_steps": "serving export",
    "async_checkpoint": "asynchronous checkpoints",
    "num_readers": "parallel readers (one pure-Python reader)",
    "reader_processes": "reader processes (one pure-Python reader)",
    "adam_mu_dtype": "a bf16 Adam first moment",
    "ensemble_train_dirs": "ensembles",
    "ensemble_models": "ensembles",
    "ensemble_weights": "ensembles",
    "output_probabilities_dir": "probability dumps",
    "output_probabilities_dtype": "probability dumps",
    "output_probabilities_topk": "probability dumps",
}
_ALLOWED = {"num_devices": (None, 1), "num_readers": (0, 1)}


class _Config:
    """Shared behaviour: the model's widths follow the reader flags, and
    unported flags refuse non-default values."""

    def __post_init__(self):
        for field in dataclasses.fields(self):
            if field.name not in UNPORTED:
                continue
            value = getattr(self, field.name)
            ok = _ALLOWED.get(field.name, (field.default,))
            if value not in ok:
                raise ValueError(
                    f"--{field.name}={value!r}: {UNPORTED[field.name]} is not "
                    f"ported to the PyTorch package yet (see ROADMAP.md)")

    def resolved_hparams(self) -> ModelHParams:
        """feature_dim follows --feature_sizes, vocab_size --num_classes."""
        _, sizes = get_feature_names_and_sizes(
            self.feature_names, self.feature_sizes
        )
        return self.hparams.replace(
            vocab_size=self.num_classes,
            max_frames=self.max_frames,
            feature_dim=sum(sizes),
        )


@dataclasses.dataclass
class TrainConfig(_Config):
    # data
    train_data_pattern: str = ""
    feature_names: str = "mean_rgb"
    feature_sizes: str = "1024"
    frame_features: bool = False
    num_classes: int = 4716
    max_frames: int = 300
    batch_size: int = 1024
    num_epochs: Optional[int] = 5
    num_readers: int = 1
    reader_processes: bool = False

    # model / loss selection
    model: str = "LogisticModel"
    label_loss: str = "CrossEntropyLoss"

    # optimisation
    optimizer: str = "AdamOptimizer"
    base_learning_rate: float = 0.01
    learning_rate_decay: float = 0.95
    learning_rate_decay_examples: int = 4_000_000
    regularization_penalty: float = 1.0
    clip_gradient_norm: float = 1.0
    adam_mu_dtype: str = "float32"
    # > 0: keep a Polyak/EMA average of the parameters in the checkpoints
    ema_decay: float = 0.0
    use_ema_weights: bool = False
    max_steps: Optional[int] = None

    # run management
    train_dir: str = "/tmp/yt8m_model/"
    start_new_model: bool = False
    save_checkpoint_every_n_steps: int = 1000
    async_checkpoint: bool = False
    export_model_steps: int = 0
    max_checkpoints_to_keep: int = 5
    log_every_n_steps: int = 10
    fail_on_nan_loss: bool = True
    seed: int = 0

    # distillation, boosting
    distill_data_pattern: str = ""
    distill_alpha: float = 0.5
    boost_weights_file: str = ""

    # parallelism
    model_parallel: int = 1
    fsdp_min_size: int = 0
    num_devices: Optional[int] = None

    # torch.profiler trace of steps 10-20 into this directory
    profile_dir: str = ""
    device: str = "cuda"

    hparams: ModelHParams = dataclasses.field(default_factory=ModelHParams)


@dataclasses.dataclass
class EvalConfig(_Config):
    eval_data_pattern: str = ""
    feature_names: str = "mean_rgb"
    feature_sizes: str = "1024"
    frame_features: bool = False
    num_classes: int = 4716
    max_frames: int = 300
    batch_size: int = 1024
    model: str = "LogisticModel"
    label_loss: str = "CrossEntropyLoss"
    # evaluate the EMA weights (requires training with --ema_decay > 0)
    use_ema_weights: bool = False
    ensemble_train_dirs: str = ""
    ensemble_models: str = ""
    ensemble_weights: str = ""
    train_dir: str = "/tmp/yt8m_model/"
    run_once: bool = True
    # --run_once=False: stop after this many evaluations; -1 = evaluate
    # every existing checkpoint once, ascending, then exit; None/0 = poll
    # forever (the reference eval.py)
    max_evaluations: Optional[int] = None
    num_readers: int = 1
    reader_processes: bool = False
    top_k: int = 20
    checkpoint_step: Optional[int] = None
    # > 0: the device returns per-video top-K triplets instead of the
    # dense [B, num_classes] predictions; 0 = the dense path
    device_metric_topk: int = 64
    seed: int = 0
    device: str = "cuda"
    hparams: ModelHParams = dataclasses.field(default_factory=ModelHParams)


@dataclasses.dataclass
class InferenceConfig(_Config):
    input_data_pattern: str = ""
    feature_names: str = "mean_rgb"
    feature_sizes: str = "1024"
    frame_features: bool = False
    num_classes: int = 4716
    max_frames: int = 300
    batch_size: int = 8192
    model: str = "LogisticModel"
    # serve the EMA weights (requires training with --ema_decay > 0)
    use_ema_weights: bool = False
    train_dir: str = "/tmp/yt8m_model/"
    output_file: str = ""
    top_k: int = 20
    checkpoint_step: Optional[int] = None
    num_readers: int = 1
    reader_processes: bool = False
    ensemble_train_dirs: str = ""
    ensemble_models: str = ""
    ensemble_weights: str = ""
    output_probabilities_dir: str = ""
    output_probabilities_dtype: str = "float32"
    output_probabilities_topk: int = 0
    seed: int = 0
    device: str = "cuda"
    hparams: ModelHParams = dataclasses.field(default_factory=ModelHParams)
