"""Attention-pooling frame models (reference: the JAX package's
models/attention.py :: _AttentionPool, AttentionPoolingModel,
MultiHeadAttentionModel).

AttentionPoolingModel: learned per-head frame scores x @ Q, a softmax over
the video's frames (masked past num_frames), each head's weighted sum of
the frames, concatenated [B, H * D] -> FC (proj_weights) + BN + ReLU ->
the video-level head. In eval mode the pooling is the fused kernel
(kernels/attention_pool.py: the CUDA kernel on the card, its plain
version on the CPU) at either compute dtype, as the JAX package's TPU
path takes its kernel with dtype=hp.dtype: the bf16 kernel, or at
float32 the f32 one (the query, a serving constant in the compute dtype,
selects it). Both take the uint8 frames as they are and dequantize them
themselves. In training the pooling is the JAX model's graph in plain
PyTorch on the dequantized frames (the JAX kernel is serving-only). The
products are f32 on operands rounded to the compute dtype, as the JAX
model's products in that dtype with f32 accumulation.

MultiHeadAttentionModel: projected keys and values, learned queries,
scaled scores and the same masked softmax over time; plain PyTorch, with
no kernel (the JAX package has none for it).

Parameter and buffer names are the JAX model's (`convert.py` carries them
over).
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.kernels.ops import attention_pool
from yt8m_tpu_torch.models.frame_utils import ensure_float, frame_mask
from yt8m_tpu_torch.models.heads import l2_loss, rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.norm import BatchNorm
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import make_classifier_head


def masked_softmax_over_time(scores, num_frames):
    """softmax over F of scores [B, F, H], -1e9 at t >= num_frames."""
    mask = frame_mask(num_frames, scores.shape[1])
    return torch.softmax(torch.where(mask[:, :, None] > 0, scores, -1e9),
                         dim=1)


class AttentionPool(ServingModule):
    """`attention_query` [D, H]: frames [B, F, D] -> [B, H * D]."""

    def __init__(self, dim: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.attention_query = nn.Parameter(torch.empty(dim, heads))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """normal(1/sqrt(D)), as the JAX layer."""
        with torch.no_grad():
            self.attention_query.normal_(
                0.0, self.attention_query.shape[0] ** -0.5,
                generator=generator)
        self._serving = None

    def make_serving_constants(self) -> dict:
        # The kernel's route follows the query's dtype (bf16 or f32).
        return {"query": self.attention_query.detach().to(self.dtype)}

    def forward(self, frames, num_frames):
        b = frames.shape[0]
        if not self.training:
            pooled = attention_pool(frames.contiguous(),
                                    num_frames.to(torch.int32).contiguous(),
                                    self.serving_constants()["query"])
            return pooled.reshape(b, -1)
        x = ensure_float(frames)
        scores = torch.matmul(rounded(x, self.dtype),
                              rounded(self.attention_query, self.dtype))
        attn = masked_softmax_over_time(scores, num_frames)
        pooled = torch.matmul(rounded(attn, self.dtype).transpose(1, 2),
                              rounded(x, self.dtype))  # [B, H, D]
        return pooled.reshape(b, -1)


@register("AttentionPoolingModel", frame_level=True)
class AttentionPoolingModel(ServingModule):
    """Reference: the JAX package's AttentionPoolingModel (the fork's
    attention pooling): pooled [B, H * D] -> FC --attention_hidden_size
    + BN + ReLU -> the video-level head; in training the output adds
    l2_penalty * (l2_loss(Q) + l2_loss(proj_weights)) to the head's
    regularization_loss."""

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d, h = hp.feature_dim, hp.attention_heads
        self.attention = AttentionPool(d, h, hp.dtype)
        self.proj_weights = nn.Parameter(
            torch.empty(h * d, hp.attention_hidden_size))
        self.proj_bn = BatchNorm(hp.attention_hidden_size, axis=hp.bn_axis)
        self.video_classifier = make_classifier_head(
            hp, hp.attention_hidden_size)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        self.attention.reset_parameters(generator)
        with torch.no_grad():
            self.proj_weights.normal_(0.0, self.proj_weights.shape[0] ** -0.5,
                                      generator=generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def make_serving_constants(self) -> dict:
        return {"proj": rounded(self.proj_weights, self.hp.dtype)}

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training
        "regularization_loss". Nothing is sampled."""
        hp = self.hp
        pooled = self.attention(features, num_frames)
        proj = (rounded(self.proj_weights, hp.dtype) if self.training
                else self.serving_constants()["proj"])
        hidden = torch.relu(self.proj_bn(torch.matmul(
            rounded(pooled, hp.dtype), proj)))
        out = self.video_classifier(hidden)
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"] + hp.l2_penalty * (
                    l2_loss(self.attention.attention_query)
                    + l2_loss(self.proj_weights)))
        return out


@register("MultiHeadAttentionModel", frame_level=True)
class MultiHeadAttentionModel(ServingModule):
    """Reference: the JAX package's MultiHeadAttentionModel: k = x @ W_k,
    v = x @ W_v, score_h = <k, q_h> / sqrt(dk), a masked softmax over
    time, each head's pooled values concatenated [B, H * dk] -> the
    video-level head; in training l2_penalty * l2_loss(W_k, W_v, queries)
    is added to its regularization_loss. Its only serving constants are
    the head's."""

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d, h, dk = hp.feature_dim, hp.attention_heads, hp.attention_hidden_size
        self.key_weights = nn.Parameter(torch.empty(d, dk))
        self.value_weights = nn.Parameter(torch.empty(d, dk))
        self.queries = nn.Parameter(torch.empty(h, dk))
        self.video_classifier = make_classifier_head(hp, h * dk)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        with torch.no_grad():
            for w in (self.key_weights, self.value_weights):
                w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
            self.queries.normal_(0.0, 1.0, generator=generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training
        "regularization_loss". Nothing is sampled."""
        hp = self.hp
        x = rounded(ensure_float(features), hp.dtype)
        b = x.shape[0]
        keys = torch.matmul(x, rounded(self.key_weights, hp.dtype))
        values = torch.matmul(x, rounded(self.value_weights, hp.dtype))
        dk = torch.sqrt(torch.tensor(float(keys.shape[-1]),
                                     device=keys.device))
        scores = torch.matmul(keys, self.queries.t()) / dk  # [B, F, H]
        attn = masked_softmax_over_time(scores, num_frames)
        pooled = torch.matmul(rounded(attn, hp.dtype).transpose(1, 2),
                              rounded(values, hp.dtype)).reshape(b, -1)
        out = self.video_classifier(pooled)
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"] + hp.l2_penalty * l2_loss(
                    self.key_weights, self.value_weights, self.queries))
        return out
