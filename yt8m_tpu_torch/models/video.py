"""Video-level classifier hook shared by the frame models."""

from __future__ import annotations

from yt8m_tpu_torch.models.heads import MoeHead
from yt8m_tpu_torch.models.hparams import ModelHParams


def make_classifier_head(hp: ModelHParams, in_features: int):
    """The `--*_video_level_classifier_model` hook every frame model uses."""
    cls_name = hp.video_level_classifier_model
    if cls_name == "MoeModel":
        return MoeHead(
            in_features,
            vocab_size=hp.vocab_size,
            num_mixtures=hp.moe_num_mixtures,
            dtype=hp.dtype,
            l2_penalty=hp.moe_l2_penalty,
        )
    if cls_name == "LogisticModel":
        raise NotImplementedError(
            "the LogisticModel classifier head is not ported yet"
        )
    raise ValueError(f"unknown video-level classifier {cls_name!r}")
