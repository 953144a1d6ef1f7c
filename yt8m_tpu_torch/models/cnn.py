"""1-D temporal CNN frame model (reference: the JAX package's
models/cnn.py :: FrameCnnModel).

    for each of --cnn_layers: zero the padded frames, conv over time
    (--cnn_filters, --cnn_kernel, "SAME"), BatchNorm, ReLU
    masked max pool over the frames -> the video-level head

Each `conv{i}` keeps flax's nn.Conv layout, `kernel` [k, in, out] and
`bias` [out], so that convert.py transposes nothing; the kernel is
permuted to torch's [out, in, k] at use. "SAME" pads (k-1)//2 frames
below and k//2 above (XLA's rule, which differs from a symmetric pad for
an even k). As flax computes it at compute dtype bf16, the convolution
takes operands rounded to bf16 (f32 sums), its output is rounded to
bf16, the bias (rounded) is added in bf16, and the sum widened to f32.
The JAX package runs the convolution outside Pallas, so the port runs
torch's conv1d, on the card too. `conv{i}_bn` is flax's BatchNorm over
a [B, F, C] input: its statistics span B and F, padded frames included,
so it runs on the [B*F, C] view.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yt8m_tpu_torch.models.frame_utils import (
    ensure_float,
    frame_mask,
    frame_pooling,
)
from yt8m_tpu_torch.models.heads import rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.norm import BatchNorm
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import make_classifier_head


class Conv1d(nn.Module):
    """flax nn.Conv over [B, F, C_in] with padding "SAME": `kernel` [k,
    in, out], `bias` [out]."""

    def __init__(self, in_features: int, features: int, kernel_size: int,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(kernel_size, in_features,
                                               features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator=None):
        """lecun_normal over fan_in = k * in, zero bias, as flax."""
        k, cin, _ = self.kernel.shape
        with torch.no_grad():
            self.kernel.normal_(0.0, (k * cin) ** -0.5, generator=generator)
            self.bias.zero_()

    def forward(self, x):
        """x [B, F, C_in] f32 -> [B, F, C_out] f32."""
        k = self.kernel.shape[0]
        xt = F.pad(rounded(x, self.dtype).transpose(1, 2),
                   ((k - 1) // 2, k // 2))
        w = rounded(self.kernel, self.dtype).permute(2, 1, 0)
        y = F.conv1d(xt, w).transpose(1, 2)
        return (y.to(self.dtype) + self.bias.to(self.dtype)).to(torch.float32)


@register("FrameCnnModel", frame_level=True)
class FrameCnnModel(ServingModule):
    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        width = hp.feature_dim
        for i in range(hp.cnn_layers):
            setattr(self, f"conv{i}", Conv1d(width, hp.cnn_filters,
                                             hp.cnn_kernel, hp.dtype))
            setattr(self, f"conv{i}_bn", BatchNorm(hp.cnn_filters,
                                                   axis=hp.bn_axis))
            width = hp.cnn_filters
        self.video_classifier = make_classifier_head(hp, width)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        for i in range(self.hp.cnn_layers):
            getattr(self, f"conv{i}").reset_parameters(generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training the head's
        "regularization_loss". Nothing is sampled."""
        x = ensure_float(features)
        b, f, _ = x.shape
        mask = frame_mask(num_frames, f)
        for i in range(self.hp.cnn_layers):
            x = getattr(self, f"conv{i}")(x * mask[:, :, None])
            x = getattr(self, f"conv{i}_bn")(x.reshape(b * f, -1))
            x = torch.relu(x).reshape(b, f, -1)
        return self.video_classifier(frame_pooling(x, "max", mask))
