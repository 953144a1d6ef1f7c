"""Model hyper-parameters — one dataclass covering the reference's flag
surface, with the field names and defaults of the JAX package's
`ModelHParams`, so that a recorded model_flags.json loads unchanged. CLI
flags with the same names map 1:1 onto these fields.

Fields that select a Pallas kernel in the JAX package
(`*_use_pallas`, `moe_head_pallas`) are inert here: the port's serving
path always runs its CUDA kernels. `netvlad_fused_train` (with
`netvlad_use_pallas`) selects the trainable VLAD core in training, as in
the JAX package. Fields of model families not yet
ported are kept so that recordings of any run load; they are inert too.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelHParams:
    vocab_size: int = 4716
    feature_dim: int = 1152
    max_frames: int = 300
    compute_dtype: str = "bfloat16"

    # video_level_models.py flags
    moe_num_mixtures: int = 2
    moe_head_pallas: bool = True
    moe_l2_penalty: float = 1e-8
    l2_penalty: float = 1e-8

    # frame_level_models.py :: DbofModel flags
    dbof_cluster_size: int = 8192
    dbof_hidden_size: int = 1024
    dbof_pooling_method: str = "max"  # max | average
    dbof_use_pallas: bool = True
    # int8 serving path of the JAX package; not ported yet (raises)
    dbof_int8_serving: bool = False
    dbof_add_batch_norm: bool = True
    sample_random_frames: bool = True
    iterations: int = 30  # frames sampled per video
    video_level_classifier_model: str = "MoeModel"

    # frame_level_models.py :: LstmModel / GRU family flags
    lstm_cells: int = 1024
    lstm_layers: int = 2
    lstm_pooling: str = "last"  # last | max | mean
    rnn_bidirectional: bool = False
    lstm_use_pallas: bool = True
    lstm_layer_norm: bool = False
    rnn_residual: bool = False
    gru_cells: int = 1024
    gru_layers: int = 2

    # NetVLAD family
    netvlad_cluster_size: int = 256
    netvlad_hidden_size: int = 1024
    netvlad_add_batch_norm: bool = True
    netvlad_gating: bool = True
    netvlad_sample_frames: int = 0  # 0 = use all (masked) frames
    netvlad_use_pallas: bool = True
    netvlad_fused_train: bool = False

    # Attention pooling family
    attention_heads: int = 8
    attention_hidden_size: int = 512
    attention_cluster_size: int = 32
    attention_use_pallas: bool = True

    # NeXtVLAD
    nextvlad_groups: int = 8
    nextvlad_expansion: int = 2
    nextvlad_cluster_size: int = 128
    nextvlad_hidden_size: int = 1024
    nextvlad_use_pallas: bool = True
    nextvlad_train_fused: bool = True

    # Temporal CNN family
    cnn_filters: int = 1024
    cnn_layers: int = 2
    cnn_kernel: int = 3

    # Chaining family
    chain_stages: int = 3
    chain_hidden_size: int = 1024
    chain_aux_loss_weight: float = 0.5

    # Distillation
    distill_alpha: float = 0.5

    # Cross-replica BatchNorm axis of the JAX trainer; runtime-only,
    # recordings keep "".
    bn_axis: str = ""

    @property
    def dtype(self) -> torch.dtype:
        return (
            torch.bfloat16
            if self.compute_dtype == "bfloat16"
            else torch.float32
        )

    def replace(self, **kw) -> "ModelHParams":
        return dataclasses.replace(self, **kw)


# Serving-time knobs that stay under the CLI's control when a model is
# rebuilt from a recorded model_flags.json; everything else is
# structural and is taken from the recording.
RUNTIME_HPARAM_FIELDS = frozenset({
    "compute_dtype", "moe_head_pallas", "dbof_use_pallas",
    "dbof_int8_serving", "lstm_use_pallas", "netvlad_use_pallas",
    "netvlad_fused_train", "attention_use_pallas",
    "nextvlad_use_pallas", "nextvlad_train_fused", "bn_axis",
})
