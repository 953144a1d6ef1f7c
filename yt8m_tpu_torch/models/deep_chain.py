"""Deep-combine chaining model (reference: the JAX package's
models/deep_chain.py :: DeepCombineChainModel).

    s_0 = relu(BN(W_0 [x]))
    s_i = relu(BN(W_i [x ; s_{i-1} ; relu(p_{i-1} @ pred_proj{i})]))
    p_i = MoE(s_i)

over x, the masked mean of the frames. The earlier stages' p_i come back
as `aux_predictions`. Each stage's MoE head runs the MoE kernel in
serving, so a batch launches it --chain_stages times. Parameter names
are the JAX model's (`pred_proj{i}`, `mix{i}_weights`, `mix{i}_bn`,
`stage{i}`).
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.models.frame_utils import masked_mean
from yt8m_tpu_torch.models.heads import l2_loss, rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.norm import BatchNorm
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import moe_head


@register("DeepCombineChainModel", frame_level=True)
class DeepCombineChainModel(ServingModule):
    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        h, half = hp.chain_hidden_size, hp.chain_hidden_size // 2
        for i in range(hp.chain_stages):
            width = hp.feature_dim
            if i > 0:
                setattr(self, f"pred_proj{i}", nn.Parameter(
                    torch.empty(hp.vocab_size, half)))
                width += h + half
            setattr(self, f"mix{i}_weights",
                    nn.Parameter(torch.empty(width, h)))
            setattr(self, f"mix{i}_bn", BatchNorm(h, axis=hp.bn_axis))
            setattr(self, f"stage{i}", moe_head(hp, h))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        hp = self.hp
        with torch.no_grad():
            for i in range(hp.chain_stages):
                if i > 0:
                    getattr(self, f"pred_proj{i}").normal_(
                        0.0, hp.vocab_size ** -0.5, generator=generator)
                mix = getattr(self, f"mix{i}_weights")
                mix.normal_(0.0, mix.shape[0] ** -0.5, generator=generator)
        for i in range(hp.chain_stages):
            getattr(self, f"stage{i}").reset_parameters(generator)
        self.invalidate_serving()

    def make_serving_constants(self) -> dict:
        return {name: rounded(p, self.hp.dtype)
                for name, p in self.named_parameters(recurse=False)}

    def forward(self, features, num_frames, generator=None, u=None):
        hp = self.hp
        dtype = hp.dtype

        def weight(name):
            if self.training:
                return rounded(getattr(self, name), dtype)
            return self.serving_constants()[name]

        pooled = masked_mean(features, num_frames)
        preds = state = None
        aux = []
        reg = torch.zeros((), device=pooled.device)
        for i in range(hp.chain_stages):
            parts = [pooled]
            if state is not None:
                parts.append(state)
            if preds is not None:
                parts.append(torch.relu(torch.matmul(
                    rounded(preds, dtype), weight(f"pred_proj{i}"))))
                if self.training:
                    reg = reg + hp.l2_penalty * l2_loss(
                        getattr(self, f"pred_proj{i}"))
            inp = torch.cat(parts, dim=-1)
            state = getattr(self, f"mix{i}_bn")(torch.matmul(
                rounded(inp, dtype), weight(f"mix{i}_weights")))
            state = torch.relu(state)
            if self.training:
                reg = reg + hp.l2_penalty * l2_loss(
                    getattr(self, f"mix{i}_weights"))
            out = getattr(self, f"stage{i}")(state)
            if preds is not None:
                aux.append(preds)
            preds = out["predictions"]
            if self.training:
                reg = reg + out["regularization_loss"]
        out = {"predictions": preds, "aux_predictions": aux}
        if self.training:
            out["regularization_loss"] = reg
        return out
