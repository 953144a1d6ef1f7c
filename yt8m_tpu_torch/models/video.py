"""Video-level models (reference: video_level_models.py; the JAX
package's models/video.py) and the classifier hook the frame models
share.

Input: mean-pooled features [B, D] (float). Output: "predictions"
[B, vocab] f32 probabilities, and in training "regularization_loss".
"""

from __future__ import annotations

from yt8m_tpu_torch.models.heads import LogisticHead, MoeHead
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule


def logistic_head(hp: ModelHParams, in_features: int) -> LogisticHead:
    return LogisticHead(in_features, vocab_size=hp.vocab_size,
                        dtype=hp.dtype, l2_penalty=hp.l2_penalty)


def moe_head(hp: ModelHParams, in_features: int) -> MoeHead:
    """Every MoE head of the zoo (MoeModel, the frame models' classifier,
    the chains' stages), with --moe_head_pallas as each JAX call site
    passes it."""
    return MoeHead(in_features, vocab_size=hp.vocab_size,
                   num_mixtures=hp.moe_num_mixtures, dtype=hp.dtype,
                   l2_penalty=hp.moe_l2_penalty,
                   use_pallas=hp.moe_head_pallas)


def make_classifier_head(hp: ModelHParams, in_features: int):
    """The `--*_video_level_classifier_model` hook every frame model uses."""
    cls_name = hp.video_level_classifier_model
    if cls_name == "MoeModel":
        return moe_head(hp, in_features)
    if cls_name == "LogisticModel":
        return logistic_head(hp, in_features)
    raise ValueError(f"unknown video-level classifier {cls_name!r}")


class _VideoModel(ServingModule):
    """One head named `tower` over the features [B, D]; nothing is
    sampled, and `num_frames`, `generator` and `u` are accepted for the
    serving step's signature."""

    def __init__(self, hp: ModelHParams, tower):
        super().__init__()
        self.hp = hp
        self.tower = tower

    def reset_parameters(self, generator=None):
        self.tower.reset_parameters(generator)
        self.invalidate_serving()

    def forward(self, features, num_frames=None, generator=None, u=None):
        return self.tower(features.float())


@register("LogisticModel", frame_level=False)
class LogisticModel(_VideoModel):
    def __init__(self, hp: ModelHParams):
        super().__init__(hp, logistic_head(hp, hp.feature_dim))


@register("MoeModel", frame_level=False)
class MoeModel(_VideoModel):
    """Serves on moe_head_serving (kernels/moe_head.py), as MoeHead does
    (the plain head with --moe_head_pallas=false)."""

    def __init__(self, hp: ModelHParams):
        super().__init__(hp, moe_head(hp, hp.feature_dim))
