"""Run configuration of the port's train, eval and inference CLIs: the
reference's flag names and the JAX package's defaults (reference:
train.py, eval.py, inference.py flags), plus `device` (default "cuda").
Every flag of the JAX package's CLIs is ported.

--num_devices is the number of ranks of a multi-GPU run (None: every
visible card on the card, one rank on the CPU; parallel/distributed.py),
for training, eval and inference; --fsdp_min_size shards the training
state's large variables over them (parallel/mesh.py), and
--model_parallel=mp arranges them as a (data, model) grid of
ranks // mp x mp for tensor-parallel training, which shards the head
kernels and DBoF's cluster layer on their columns over each model group
(parallel/tensor.py); mp must divide the ranks. Eval and inference serve
a tensor-parallel run's checkpoint as any other (the one-card format).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from yt8m_tpu_torch.data.features import get_feature_names_and_sizes
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.parallel.distributed import grid_shape

class _Config:
    """Shared behaviour: the model's widths follow the reader flags."""

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

    # parallelism: the model axis of the (data, model) grid of ranks
    # (1: data-parallel), the FSDP threshold in elements (0: everything
    # replicated), ranks (None: every card)
    model_parallel: int = 1
    fsdp_min_size: int = 0
    num_devices: Optional[int] = None

    # torch.profiler trace of steps 10-20 into this directory
    profile_dir: str = ""
    device: str = "cuda"

    hparams: ModelHParams = dataclasses.field(default_factory=ModelHParams)

    def __post_init__(self):
        # The grid of parallel/distributed.py :: grid_shape, checked here
        # where the ranks are given (else when the run starts).
        grid_shape(self.num_devices or self.model_parallel,
                   self.model_parallel)


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
    # accepted as the reference's eval.py accepts them; inert here (the
    # checkpoint restores the model without the optimizer state)
    optimizer: str = "AdamOptimizer"
    adam_mu_dtype: str = "float32"
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
    # ranks serving the batches (None: every card; one on the CPU)
    num_devices: Optional[int] = None
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
    # accepted as the reference's inference.py accepts them; inert here
    # (the checkpoint restores the model without the optimizer state)
    optimizer: str = "AdamOptimizer"
    adam_mu_dtype: str = "float32"
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
    # ranks serving the batches (None: every card; one on the CPU)
    num_devices: Optional[int] = None
    hparams: ModelHParams = dataclasses.field(default_factory=ModelHParams)
