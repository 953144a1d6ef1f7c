"""Chaining models (reference: the JAX package's models/chain.py): a
cascade of MoE heads where stage i > 0 reads the input concatenated with
relu(pred_{i-1} @ chain_proj{i}); the earlier stages' predictions come
back as `aux_predictions`, which the train step weighs by
--chain_aux_loss_weight.

In serving each stage's head is the MoE kernel (kernels/moe_head.py),
and its probabilities feed the next stage's projection, so a batch
launches it --chain_stages times. Parameter names are the JAX model's:
`chain.chain_proj{i}` [vocab, chain_hidden], `chain.stage{i}.*`.
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.models.frame_utils import masked_mean
from yt8m_tpu_torch.models.heads import l2_loss, rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.netvlad import NetVladAggregation, fused_train
from yt8m_tpu_torch.models.norm import BatchNorm
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import moe_head


class ChainStack(ServingModule):
    """`chain_stages` MoE heads; stage i > 0 sees [x, relu(pred @ proj)]."""

    def __init__(self, hp: ModelHParams, in_features: int):
        super().__init__()
        self.hp = hp
        h = hp.chain_hidden_size
        for i in range(hp.chain_stages):
            if i > 0:
                setattr(self, f"chain_proj{i}", nn.Parameter(
                    torch.empty(hp.vocab_size, h)))
            setattr(self, f"stage{i}",
                    moe_head(hp, in_features + (h if i > 0 else 0)))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        hp = self.hp
        with torch.no_grad():
            for i in range(1, hp.chain_stages):
                getattr(self, f"chain_proj{i}").normal_(
                    0.0, hp.vocab_size ** -0.5, generator=generator)
        for i in range(hp.chain_stages):
            getattr(self, f"stage{i}").reset_parameters(generator)
        self._serving = None

    def make_serving_constants(self) -> dict:
        return {i: rounded(getattr(self, f"chain_proj{i}"), self.hp.dtype)
                for i in range(1, self.hp.chain_stages)}

    def forward(self, x):
        hp = self.hp
        preds = None
        aux = []
        reg = torch.zeros((), device=x.device)
        for i in range(hp.chain_stages):
            stage_in = x
            if preds is not None:
                proj = getattr(self, f"chain_proj{i}")
                w = (rounded(proj, hp.dtype) if self.training
                     else self.serving_constants()[i])
                proj_pred = torch.relu(torch.matmul(rounded(preds, hp.dtype),
                                                    w))
                stage_in = torch.cat([x, proj_pred], dim=-1)
                if self.training:
                    reg = reg + hp.l2_penalty * l2_loss(proj)
                aux.append(preds)
            out = getattr(self, f"stage{i}")(stage_in)
            preds = out["predictions"]
            if self.training:
                reg = reg + out["regularization_loss"]
        out = {"predictions": preds, "aux_predictions": aux}
        if self.training:
            out["regularization_loss"] = reg
        return out


class _ChainModel(ServingModule):
    def reset_parameters(self, generator=None):
        self.chain.reset_parameters(generator)
        self.invalidate_serving()


@register("ChainMoeModel", frame_level=False)
class ChainMoeModel(_ChainModel):
    """Video-level chain of MoE heads over the mean features."""

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        self.chain = ChainStack(hp, hp.feature_dim)

    def forward(self, features, num_frames=None, generator=None, u=None):
        return self.chain(features.float())


@register("ChainFrameModel", frame_level=True)
class ChainFrameModel(_ChainModel):
    """Frame-level chain over the masked mean of the frames."""

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        self.chain = ChainStack(hp, hp.feature_dim)

    def forward(self, features, num_frames, generator=None, u=None):
        return self.chain(masked_mean(features, num_frames))


@register("ChainNetVladModel", frame_level=True)
class ChainNetVladModel(_ChainModel):
    """NetVLAD aggregation (`vlad`: netvlad_aggregate in serving, the
    trainable core with --netvlad_fused_train), hidden1 FC + BN + ReLU,
    then the chain. No frame sampling, and `hidden1_bn` whatever
    --netvlad_add_batch_norm says, as in the JAX model."""

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d, k = hp.feature_dim, hp.netvlad_cluster_size
        self.vlad = NetVladAggregation(d, k, hp.netvlad_add_batch_norm,
                                       hp.dtype, fused_train(hp), hp.bn_axis)
        self.hidden1_weights = nn.Parameter(
            torch.empty(k * d, hp.netvlad_hidden_size))
        self.hidden1_bn = BatchNorm(hp.netvlad_hidden_size, axis=hp.bn_axis)
        self.chain = ChainStack(hp, hp.netvlad_hidden_size)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        self.vlad.reset_parameters(generator)
        with torch.no_grad():
            self.hidden1_weights.normal_(
                0.0, self.hp.netvlad_cluster_size ** -0.5,
                generator=generator)
        super().reset_parameters(generator)

    def make_serving_constants(self) -> dict:
        return {"hidden1_weights": rounded(self.hidden1_weights,
                                           self.hp.dtype)}

    def forward(self, features, num_frames, generator=None, u=None):
        hp = self.hp
        vlad = self.vlad(features, num_frames)
        w = (rounded(self.hidden1_weights, hp.dtype) if self.training
             else self.serving_constants()["hidden1_weights"])
        hidden = self.hidden1_bn(torch.matmul(rounded(vlad, hp.dtype), w))
        del vlad
        out = self.chain(torch.relu(hidden))
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"] + hp.l2_penalty * (
                    l2_loss(self.vlad.cluster_weights)
                    + l2_loss(self.hidden1_weights)))
        return out
