"""NetVLAD and gated NetVLAD (reference: the JAX package's
models/netvlad.py).

    assign = softmax(frames @ W_c [+ BN])        [B, F, K], masked frames 0
    vlad   = assign^T @ frames - colsum(assign) * centers       [B, K, D]
    intra-normalise over D, flatten (index k*D + d), L2 normalise
    FC -> hidden (+BN), optional context gating, then the MoE head.

Serving runs the fused kernel (kernels/netvlad.py) with the assignment
BatchNorm folded into its per-cluster affine, as the JAX model folds it
for its kernel. Training computes the assignment product and its
BatchNorm on batch moments over every frame row in plain PyTorch; then,
with --netvlad_fused_train (and --netvlad_use_pallas, as the JAX model's
condition has it), the trainable core kernels/netvlad_train.py ::
netvlad_core (the masked softmax, `a_sum` and the residual product, the
assignment recomputed in the backward), else the JAX model's plain graph
for the same steps. Every BatchNorm after it runs in training mode.
Parameter names are the JAX model's.
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.kernels.netvlad import netvlad_aggregate
from yt8m_tpu_torch.kernels.netvlad_train import netvlad_core
from yt8m_tpu_torch.models.frame_utils import (
    ensure_float,
    frame_mask,
    l2_normalize,
    sample_random_frames,
)
from yt8m_tpu_torch.models.heads import ContextGate, l2_loss, rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.norm import BN_EPS, BatchNorm, bn_fold, inline_bn
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import make_classifier_head


class NetVladAggregation(ServingModule):
    """frames [B, F, D] (uint8 or float) + num_frames -> VLAD [B, K*D].

    `cluster_weights2` keeps the JAX shape [1, D, K]; the kernel takes
    its transpose [K, D] as the cluster centers.
    """

    def __init__(self, feature_dim: int, cluster_size: int,
                 add_batch_norm: bool = True, dtype=torch.float32,
                 fused_train: bool = False):
        super().__init__()
        d, k = feature_dim, cluster_size
        self.dtype = dtype
        self.fused_train = fused_train
        self.add_batch_norm = add_batch_norm
        self.cluster_weights = nn.Parameter(torch.empty(d, k))
        self.cluster_weights2 = nn.Parameter(torch.empty(1, d, k))
        if add_batch_norm:
            self.cluster_bn_scale = nn.Parameter(torch.ones(k))
            self.cluster_bn_bias = nn.Parameter(torch.zeros(k))
            self.register_buffer("cluster_bn_mean", torch.zeros(k))
            self.register_buffer("cluster_bn_var", torch.ones(k))
        else:
            self.cluster_biases = nn.Parameter(torch.empty(k))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        std = self.cluster_weights.shape[0] ** -0.5
        with torch.no_grad():
            self.cluster_weights.normal_(0.0, std, generator=generator)
            self.cluster_weights2.normal_(0.0, std, generator=generator)
            if not self.add_batch_norm:
                self.cluster_biases.normal_(0.0, std, generator=generator)
        self._serving = None

    def make_serving_constants(self) -> dict:
        k = self.cluster_weights.shape[1]
        if self.add_batch_norm:
            scale, bias = bn_fold(self.cluster_bn_scale, self.cluster_bn_bias,
                                  self.cluster_bn_mean, self.cluster_bn_var,
                                  BN_EPS)
        else:
            scale = torch.ones(k, device=self.cluster_weights.device)
            bias = self.cluster_biases.detach().clone()
        return {
            "cluster_w": self.cluster_weights.to(self.dtype).contiguous(),
            "act_scale": scale.contiguous(),
            "act_bias": bias.contiguous(),
            "centers": self.cluster_weights2[0].t().contiguous(),
        }

    def forward(self, frames, num_frames):
        if self.training:
            return self._train_forward(frames, num_frames)
        c = self.serving_constants()
        vlad = netvlad_aggregate(
            frames.contiguous(), num_frames.to(torch.int32).contiguous(),
            c["cluster_w"], c["act_scale"], c["act_bias"], c["centers"],
        )
        return vlad.reshape(frames.shape[0], -1)

    def _train_forward(self, frames, num_frames):
        """The JAX model's training graph (models/netvlad.py:132-197): the
        fused core with `fused_train`, else the plain steps."""
        b, f, d = frames.shape
        k = self.cluster_weights.shape[1]
        x = ensure_float(frames)
        act = torch.matmul(rounded(x.reshape(b * f, d), self.dtype),
                           rounded(self.cluster_weights, self.dtype))
        if self.add_batch_norm:
            act = inline_bn(act, self.cluster_bn_scale, self.cluster_bn_bias,
                            self.cluster_bn_mean, self.cluster_bn_var, True)
        else:
            act = act + self.cluster_biases
        mask = frame_mask(num_frames, f)
        centers = self.cluster_weights2[0].t()
        if self.fused_train:
            num_frames_eff = torch.sum(mask, dim=1).to(torch.int32)
            vlad = netvlad_core(act.reshape(b, f, k), x, num_frames_eff,
                                centers)
        else:
            assign = torch.softmax(act, dim=-1).reshape(b, f, k)
            assign = assign * mask[:, :, None]
            a_sum = torch.sum(assign, dim=1)
            vlad = torch.matmul(rounded(assign, self.dtype).transpose(1, 2),
                                rounded(x, self.dtype))
            vlad = vlad - a_sum[:, :, None] * centers
        vlad = l2_normalize(vlad, dim=2)
        return l2_normalize(vlad.reshape(b, k * d), dim=1)


def fused_train(hp: ModelHParams) -> bool:
    """Whether training runs the fused core (the JAX model's condition,
    models/netvlad.py:156-164, without its TPU-only terms)."""
    return hp.netvlad_use_pallas and hp.netvlad_fused_train


def hidden_fc(model, prefix: str, x, add_batch_norm: bool):
    """relu(BN(x @ W)) (or + biases) with W = model.<prefix>_weights, the
    JAX model's hidden FC of the VLAD branch. The product is f32 on
    operands rounded to the compute dtype (its bf16 product with f32
    accumulation); `model.serving_constants()` holds the rounded W, which
    a training forward rounds anew from the parameter."""
    dtype = model.hp.dtype
    w = (rounded(getattr(model, f"{prefix}_weights"), dtype) if model.training
         else model.serving_constants()[f"{prefix}_weights"])
    hidden = torch.matmul(rounded(x, dtype), w)
    if add_batch_norm:
        hidden = getattr(model, f"{prefix}_bn")(hidden)
    else:
        hidden = hidden + getattr(model, f"{prefix}_biases")
    return torch.relu(hidden)


def add_hidden_fc(model, prefix: str, in_features: int, hidden: int,
                  add_batch_norm: bool) -> None:
    """Register `<prefix>_weights` and its BN (or biases) on `model`."""
    setattr(model, f"{prefix}_weights",
            nn.Parameter(torch.empty(in_features, hidden)))
    if add_batch_norm:
        setattr(model, f"{prefix}_bn", BatchNorm(hidden))
    else:
        setattr(model, f"{prefix}_biases", nn.Parameter(torch.empty(hidden)))


def reset_hidden_fc(model, prefix: str, std: float, generator=None) -> None:
    """normal(std) weights and normal(0.01) biases, as the JAX model."""
    with torch.no_grad():
        getattr(model, f"{prefix}_weights").normal_(0.0, std,
                                                   generator=generator)
        biases = getattr(model, f"{prefix}_biases", None)
        if biases is not None:
            biases.normal_(0.0, 0.01, generator=generator)


class _NetVladBase(ServingModule):
    """Reference: the JAX package's `_NetVladBase`. With
    `--netvlad_sample_frames` > 0 the frames are sampled first (uniform
    with replacement) and every sampled frame counts; otherwise all
    frames up to num_frames count. The raw (uint8) frames go to the
    kernel, which dequantizes them."""

    gating = False

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d, k = hp.feature_dim, hp.netvlad_cluster_size
        h = hp.netvlad_hidden_size
        self.vlad = NetVladAggregation(d, k, hp.netvlad_add_batch_norm,
                                       hp.dtype, fused_train(hp))
        add_hidden_fc(self, "hidden1", k * d, h, hp.netvlad_add_batch_norm)
        if self.gating:
            self.context_gate = ContextGate(h, hp.netvlad_add_batch_norm,
                                            hp.dtype)
        self.video_classifier = make_classifier_head(hp, h)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        hp = self.hp
        self.vlad.reset_parameters(generator)
        reset_hidden_fc(self, "hidden1", hp.netvlad_cluster_size ** -0.5,
                        generator)
        if self.gating:
            self.context_gate.reset_parameters(generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def make_serving_constants(self) -> dict:
        return {"hidden1_weights": rounded(self.hidden1_weights,
                                           self.hp.dtype)}

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training
        "regularization_loss". `generator` or the uniforms `u` [B, S]
        drive --netvlad_sample_frames."""
        hp = self.hp
        if hp.netvlad_sample_frames > 0:
            s = hp.netvlad_sample_frames
            features = sample_random_frames(features, num_frames, s,
                                            generator=generator, u=u)
            num_frames = torch.full((features.shape[0],), s,
                                    dtype=torch.int32, device=features.device)
        vlad = self.vlad(features, num_frames)
        hidden = hidden_fc(self, "hidden1", vlad, hp.netvlad_add_batch_norm)
        if self.gating:
            hidden = self.context_gate(hidden)
        out = self.video_classifier(hidden)
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"] + hp.l2_penalty * l2_loss(
                    self.vlad.cluster_weights, self.hidden1_weights))
        return out


@register("NetVladModel")
class NetVladModel(_NetVladBase):
    gating = False


@register("GatedNetVladModel")
class GatedNetVladModel(_NetVladBase):
    gating = True
