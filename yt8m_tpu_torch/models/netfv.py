"""NetFV, learnable Fisher-vector aggregation (reference: the JAX
package's models/netfv.py :: NetFVModel).

    assign = softmax(frames @ W_c [+BN]) * mask              [B, F, K]
    fv1[k] = (sum_f a x - a_sum mu_k) / sigma_k              [B, K, D]
    fv2[k] = (sum_f a x^2 - 2 mu_k sum_f a x + a_sum mu_k^2) / sigma_k^2
             - a_sum
    each intra-normalised over D, flattened and L2-normalised, concat
    -> [B, 2*K*D], FC + BN + ReLU -> the video-level head

sigma = max(softplus(covar_weights), 1e-3). The products take operands
rounded to the compute dtype (f32 sums), the second-order one bf16(x*x)
as the JAX model rounds it; `cluster_bn` (with --netvlad_add_batch_norm)
is flax's BatchNorm on the [B*F, K] view, padded frames included, and
`hidden1_bn` is always there. The JAX package computes all of it outside
Pallas, so the port runs it in plain PyTorch, on the card too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from yt8m_tpu_torch.models.frame_utils import (
    ensure_float,
    frame_mask,
    l2_normalize,
)
from yt8m_tpu_torch.models.heads import l2_loss, rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.norm import BatchNorm
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import make_classifier_head

SIGMA_FLOOR = 1e-3


def netfv_sigma(covar_weights):
    """The diagonal deviations: max(softplus(covar_weights), 1e-3)."""
    return torch.clamp_min(F.softplus(covar_weights), SIGMA_FLOOR)


@register("NetFVModel", frame_level=True)
class NetFVModel(ServingModule):
    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d, k = hp.feature_dim, hp.netvlad_cluster_size
        self.cluster_weights = nn.Parameter(torch.empty(d, k))
        self.cluster_centers = nn.Parameter(torch.empty(k, d))
        self.covar_weights = nn.Parameter(torch.ones(k, d))
        if hp.netvlad_add_batch_norm:
            self.cluster_bn = BatchNorm(k, axis=hp.bn_axis)
        self.hidden1_weights = nn.Parameter(
            torch.empty(2 * k * d, hp.netvlad_hidden_size))
        self.hidden1_bn = BatchNorm(hp.netvlad_hidden_size, axis=hp.bn_axis)
        self.video_classifier = make_classifier_head(
            hp, hp.netvlad_hidden_size)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        d, k = self.hp.feature_dim, self.hp.netvlad_cluster_size
        with torch.no_grad():
            self.cluster_weights.normal_(0.0, d ** -0.5, generator=generator)
            self.cluster_centers.normal_(0.0, d ** -0.5, generator=generator)
            self.covar_weights.fill_(1.0)
            self.hidden1_weights.normal_(0.0, k ** -0.5, generator=generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def make_serving_constants(self) -> dict:
        dtype = self.hp.dtype
        return {"cluster_weights": rounded(self.cluster_weights, dtype),
                "hidden1_weights": rounded(self.hidden1_weights, dtype)}

    def _weights(self):
        if self.training:
            dtype = self.hp.dtype
            return (rounded(self.cluster_weights, dtype),
                    rounded(self.hidden1_weights, dtype))
        c = self.serving_constants()
        return c["cluster_weights"], c["hidden1_weights"]

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training
        "regularization_loss". Nothing is sampled."""
        hp = self.hp
        dtype = hp.dtype
        x = ensure_float(features)
        b, f, d = x.shape
        k = hp.netvlad_cluster_size
        mask = frame_mask(num_frames, f)
        cluster_w, hidden_w = self._weights()
        act = torch.matmul(rounded(x, dtype), cluster_w)
        if hp.netvlad_add_batch_norm:
            act = self.cluster_bn(act.reshape(b * f, k)).reshape(b, f, k)
        assign = torch.softmax(act, dim=-1) * mask[:, :, None]
        a_sum = torch.sum(assign, dim=1)[:, :, None]  # [B, K, 1]
        at = rounded(assign, dtype).transpose(1, 2)
        sx = torch.matmul(at, rounded(x, dtype))
        sx2 = torch.matmul(at, rounded(x * x, dtype))
        mu = self.cluster_centers
        sigma = netfv_sigma(self.covar_weights)
        fv1 = (sx - a_sum * mu) / sigma
        fv2 = (sx2 - 2.0 * mu * sx + a_sum * mu ** 2) / sigma ** 2 - a_sum

        def normed(v):
            v = l2_normalize(v, dim=2).reshape(b, k * d)
            return l2_normalize(v, dim=1)

        fv = torch.cat([normed(fv1), normed(fv2)], dim=1)
        hidden = self.hidden1_bn(torch.matmul(rounded(fv, dtype), hidden_w))
        out = self.video_classifier(torch.relu(hidden))
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"] + hp.l2_penalty * l2_loss(
                    self.cluster_weights, self.hidden1_weights))
        return out
