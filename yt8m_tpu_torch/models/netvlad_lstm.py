"""NetVLAD-LSTM, the flagship (reference: the JAX package's
models/netvlad_lstm.py), serving and training forwards.

Two branches over the same masked frames, fused before the head:

  * VLAD: the fused aggregation -> FC + BN + ReLU          [B, Hv]
  * temporal: stacked (optionally bidirectional) LSTM, pooled per
    --lstm_pooling                                       [B, H * dirs]
  concat -> optional context gate -> MoE head.

The frames are dequantized once and both branches take the float view,
as in the JAX model, so the VLAD kernel gets float32 frames here. In
training each branch runs its training graph (models/netvlad.py,
models/rnn.py: the trainable recurrence kernel at bf16, and the
trainable VLAD core with --netvlad_fused_train) and the output
carries `regularization_loss`.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.models.frame_utils import ensure_float
from yt8m_tpu_torch.models.heads import ContextGate, l2_loss, rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.netvlad import (
    NetVladAggregation,
    add_hidden_fc,
    fused_train,
    hidden_fc,
    reset_hidden_fc,
)
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.rnn import add_lstm_stack, run_rnn
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import make_classifier_head


class _NetVladLstmBase(ServingModule):
    bidirectional = False

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d, k = hp.feature_dim, hp.netvlad_cluster_size
        bn = hp.netvlad_add_batch_norm
        self.vlad = NetVladAggregation(d, k, bn, hp.dtype, fused_train(hp),
                                       hp.bn_axis)
        add_hidden_fc(self, "vlad_hidden", k * d, hp.netvlad_hidden_size, bn)
        rnn_width = add_lstm_stack(self, d, hp.lstm_cells, hp.lstm_layers,
                                   hp.dtype, self.bidirectional,
                                   hp.lstm_layer_norm)
        fused = hp.netvlad_hidden_size + rnn_width
        if hp.netvlad_gating:
            self.context_gate = ContextGate(fused, bn, hp.dtype, hp.bn_axis)
        self.video_classifier = make_classifier_head(hp, fused)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        hp = self.hp
        self.vlad.reset_parameters(generator)
        reset_hidden_fc(self, "vlad_hidden", hp.netvlad_cluster_size ** -0.5,
                        generator)
        for name, module in self.named_children():
            if name.startswith(("fw_layer", "bw_layer")):
                module.reset_parameters(generator)
        if hp.netvlad_gating:
            self.context_gate.reset_parameters(generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def make_serving_constants(self) -> dict:
        return {"vlad_hidden_weights": rounded(self.vlad_hidden_weights,
                                               self.hp.dtype)}

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training
        "regularization_loss". Nothing is sampled: `generator` and `u`
        are accepted for the serving step's signature."""
        hp = self.hp
        x = ensure_float(features)
        vlad = self.vlad(x, num_frames)
        vh = hidden_fc(self, "vlad_hidden", vlad, hp.netvlad_add_batch_norm)
        del vlad
        rh = run_rnn(self, x, num_frames, hp.lstm_layers, self.bidirectional,
                     hp.lstm_pooling, hp.rnn_residual)
        fused = torch.cat([vh, rh], dim=-1)
        if hp.netvlad_gating:
            fused = self.context_gate(fused)
        out = self.video_classifier(fused)
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"] + hp.l2_penalty * l2_loss(
                    self.vlad.cluster_weights, self.vlad_hidden_weights))
        return out


@register("NetVladLstmModel", frame_level=True)
class NetVladLstmModel(_NetVladLstmBase):
    bidirectional = False


@register("NetVladBiLstmModel", frame_level=True)
class NetVladBiLstmModel(_NetVladLstmBase):
    bidirectional = True
