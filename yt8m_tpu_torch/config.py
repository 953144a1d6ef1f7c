"""Run configuration of the port's inference CLI (the reference's flag
names; reference: inference.py flags)."""

from __future__ import annotations

import dataclasses

from yt8m_tpu_torch.data.features import get_feature_names_and_sizes
from yt8m_tpu_torch.models.hparams import ModelHParams


@dataclasses.dataclass
class InferenceConfig:
    input_data_pattern: str = ""
    feature_names: str = "mean_rgb"
    feature_sizes: str = "1024"
    frame_features: bool = False
    num_classes: int = 4716
    max_frames: int = 300
    batch_size: int = 8192
    model: str = "LogisticModel"
    train_dir: str = "/tmp/yt8m_model/"
    output_file: str = ""
    top_k: int = 20
    seed: int = 0
    device: str = "cuda"
    hparams: ModelHParams = dataclasses.field(default_factory=ModelHParams)

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
