"""NeXtVLAD (reference: the JAX package's models/nextvlad.py,
arXiv:1811.05014).

    xe     = x @ We                               [B, F, lambda*D]
    alpha  = sigmoid(xe @ Wa + b)                 [B, F, G]
    assign = softmax_K(xe @ Wc) * alpha * mask    [B, F, G, K]
    vlad   = sum_{f,g} assign (x) xg - colsum(assign) (x) centers   [B, K, P]
    intra-normalise over P, flatten, BN -> hidden FC -> BN -> ReLU ->
    context gating -> the video-level head.

Three aggregation paths, chosen by the JAX model's condition without its
TPU-only terms (yt8m_tpu/models/nextvlad.py: `kernel_ok` needs bf16): at
compute dtype bf16, in eval mode with --nextvlad_use_pallas the fused
aggregation (kernels/nextvlad.py, on the raw uint8 or float frames,
with its bf16 weight layout made once as a serving constant), and in
training with --nextvlad_train_fused (the default) the trainable
aggregation (kernels/nextvlad_train.py, gradients for the five weights
only); otherwise, and at float32 in both modes, the JAX model's plain
graph (under autograd in training), as the JAX model runs f32. Each product
is f32 on operands rounded to the compute dtype, as the JAX model's
products in that dtype with f32 accumulation. Parameter names, shapes
and initialisers are the JAX model's.
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.kernels.nextvlad import kernel_layout
from yt8m_tpu_torch.kernels.ops import nextvlad as nextvlad_aggregate
from yt8m_tpu_torch.kernels.nextvlad_train import nextvlad_aggregate_train
from yt8m_tpu_torch.models.frame_utils import (
    ensure_float,
    frame_mask,
    l2_normalize,
)
from yt8m_tpu_torch.models.heads import ContextGate, l2_loss, rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.norm import BatchNorm
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import make_classifier_head


@register("NeXtVladModel", frame_level=True)
class NeXtVladModel(ServingModule):
    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d = hp.feature_dim
        g, k = hp.nextvlad_groups, hp.nextvlad_cluster_size
        de = hp.nextvlad_expansion * d
        if de % g:
            raise ValueError(f"expansion dim {de} not divisible by groups {g}")
        p = de // g
        h = hp.nextvlad_hidden_size
        self.expand_weights = nn.Parameter(torch.empty(d, de))
        self.group_attention_weights = nn.Parameter(torch.empty(de, g))
        self.group_attention_bias = nn.Parameter(torch.zeros(g))
        self.cluster_weights = nn.Parameter(torch.empty(de, g * k))
        self.cluster_weights2 = nn.Parameter(torch.empty(k, p))
        self.vlad_bn = BatchNorm(k * p, axis=hp.bn_axis)
        self.hidden1_weights = nn.Parameter(torch.empty(k * p, h))
        self.hidden1_bn = BatchNorm(h, axis=hp.bn_axis)
        self.context_gate = ContextGate(h, True, hp.dtype, hp.bn_axis)
        self.video_classifier = make_classifier_head(hp, h)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        with torch.no_grad():
            for w in (self.expand_weights, self.group_attention_weights,
                      self.cluster_weights, self.hidden1_weights):
                w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
            self.group_attention_bias.zero_()
            self.cluster_weights2.normal_(
                0.0, self.cluster_weights.shape[0] ** -0.5,
                generator=generator)
        self.context_gate.reset_parameters(generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def _weights(self):
        return (self.expand_weights, self.group_attention_weights,
                self.group_attention_bias, self.cluster_weights,
                self.cluster_weights2)

    def make_serving_constants(self) -> dict:
        hp = self.hp
        layout = None
        if (hp.nextvlad_use_pallas and self.expand_weights.is_cuda
                and self.kernel_dtype()):
            layout = kernel_layout(*self._weights(), hp.nextvlad_groups)
        return {"layout": layout,
                "hidden1_weights": rounded(self.hidden1_weights, hp.dtype)}

    def kernel_dtype(self) -> bool:
        """The JAX model's dtype term of `kernel_ok`: the kernels run at
        compute dtype bf16 only."""
        return self.hp.dtype == torch.bfloat16

    def aggregate(self, features, num_frames):
        """The intra-normalised descriptors [B, K * P] f32."""
        hp = self.hp
        b = features.shape[0]
        g = hp.nextvlad_groups
        if not self.kernel_dtype():
            vlad = self._plain_aggregate(features, num_frames)
        elif self.training and hp.nextvlad_train_fused:
            vlad = nextvlad_aggregate_train(
                features, num_frames, *self._weights(), g, hp.dtype)
        elif not self.training and hp.nextvlad_use_pallas:
            layout = self.serving_constants()["layout"]
            vlad = nextvlad_aggregate(
                features.contiguous(), num_frames,
                *(w.detach() for w in self._weights()), g, hp.dtype,
                [] if layout is None else
                [layout["we"], layout["wc"], layout["wa"]])
        else:
            vlad = self._plain_aggregate(features, num_frames)
        return vlad.reshape(b, -1)

    def _plain_aggregate(self, features, num_frames):
        """The JAX model's _jnp_aggregate: the plain graph [B, K, P]."""
        hp = self.hp
        dtype = hp.dtype
        x = ensure_float(features)
        b, f, _ = x.shape
        g, k = hp.nextvlad_groups, hp.nextvlad_cluster_size
        p = self.cluster_weights2.shape[1]
        mask = frame_mask(num_frames, f)
        xe = torch.matmul(rounded(x, dtype),
                          rounded(self.expand_weights, dtype))
        alpha = torch.sigmoid(
            torch.matmul(rounded(xe, dtype),
                         rounded(self.group_attention_weights, dtype))
            + self.group_attention_bias)
        act = torch.matmul(rounded(xe, dtype),
                           rounded(self.cluster_weights, dtype))
        assign = torch.softmax(act.reshape(b, f, g, k), dim=-1)
        assign = assign * alpha[:, :, :, None]
        assign = assign * mask[:, :, None, None]
        xg = rounded(xe, dtype).reshape(b, f * g, p)
        vlad = torch.matmul(
            rounded(assign, dtype).reshape(b, f * g, k).transpose(1, 2), xg)
        a_sum = torch.sum(assign, dim=(1, 2))
        vlad = vlad - a_sum[:, :, None] * self.cluster_weights2
        return l2_normalize(vlad, dim=2)

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training
        "regularization_loss". Nothing is sampled."""
        hp = self.hp
        vlad = self.vlad_bn(self.aggregate(features, num_frames))
        w = (rounded(self.hidden1_weights, hp.dtype) if self.training
             else self.serving_constants()["hidden1_weights"])
        hidden = torch.matmul(rounded(vlad, hp.dtype), w)
        hidden = torch.relu(self.hidden1_bn(hidden))
        hidden = self.context_gate(hidden)
        out = self.video_classifier(hidden)
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"] + hp.l2_penalty * l2_loss(
                    self.expand_weights, self.cluster_weights,
                    self.hidden1_weights))
        return out
