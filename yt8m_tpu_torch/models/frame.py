"""Frame-level models: the masked-mean logistic model and DBoF with its
gated and soft variants (reference: frame_level_models.py ::
FrameLevelLogisticModel, DbofModel; the JAX package's models/frame.py).

Input: uint8 (or float) frame features [B, F, D] plus num_frames [B].
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels.dbof import int8_serving_constants
from yt8m_tpu_torch.kernels.ops import dbof_maxpool as dbof_cluster_maxpool_v2
from yt8m_tpu_torch.kernels.ops import (
    dbof_maxpool_int8 as dbof_cluster_maxpool_int8,
)
from yt8m_tpu_torch.kernels.tf32 import split_weights
from yt8m_tpu_torch.models.frame_utils import (
    ensure_float,
    frame_pooling,
    masked_mean,
    sample_random_frames,
    sample_random_sequence,
)
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.heads import ContextGate, l2_loss, rounded
from yt8m_tpu_torch.models.norm import BN_EPS, BatchNorm, bn_fold, inline_bn
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.parallel import tensor
from yt8m_tpu_torch.parallel.distributed import all_reduce_, model_group
from yt8m_tpu_torch.models.video import logistic_head, make_classifier_head


@register("FrameLevelLogisticModel", frame_level=True)
class FrameLevelLogisticModel(ServingModule):
    """Mask-weighted mean over frames, then a logistic head named `tower`
    (reference: frame_level_models.py :: FrameLevelLogisticModel)."""

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        self.tower = logistic_head(hp, hp.feature_dim)

    def reset_parameters(self, generator=None):
        self.tower.reset_parameters(generator)
        self.invalidate_serving()

    def forward(self, features, num_frames, generator=None, u=None):
        return self.tower(masked_mean(features, num_frames))


def soft_pooling(act, block=None):
    """SoftDBoF's pooling (the JAX package's models/frame.py): a softmax
    over clusters for each frame, summed over the sampled frames. With a
    tensor-parallel `block`, act holds that block's clusters: the
    softmax's max and denominator meet over the model group."""
    if block is None:
        return torch.sum(torch.softmax(act, dim=-1), dim=1)
    top = torch.amax(act.detach(), dim=-1, keepdim=True)
    all_reduce_(top, op=torch.distributed.ReduceOp.MAX, group=model_group())
    e = torch.exp(act - top)
    return torch.sum(e / tensor.sum_over_model(
        torch.sum(e, dim=-1, keepdim=True)), dim=1)


@register("DbofModel", frame_level=True)
class DbofModel(ServingModule):
    """Deep Bag-of-Frames.

    Reference: frame_level_models.py :: DbofModel.create_model —
      1. sample `--iterations` frames (SampleRandomFrames when
         --sample_random_frames else SampleRandomSequence);
      2. FC frames -> --dbof_cluster_size (+BN or bias, ReLU);
      3. max/average pool over sampled frames (--dbof_pooling_method);
      4. FC -> --dbof_hidden_size (+BN or bias, ReLU), and in
         GatedDbofModel a context gate (`context_gate`);
      5. video-level classifier (--dbof_video_level_classifier_model).

    `pooling_override` (SoftDbofModel's "soft") takes the place of
    --dbof_pooling_method; soft pooling (`soft_pooling`) runs the unfused
    graph, as the JAX model fuses max pooling only.

    With max pooling (the reference default) steps 2-3 are one fused
    kernel (kernels/dbof.py) with dequantization and both BatchNorms
    folded into its two affines, as the JAX model folds them (its cluster
    weights in the compute dtype: the bf16 kernel, or at float32 the f32
    one, as the JAX model passes dtype=hp.dtype, which reads the cluster
    weights' TF32 split copy, a serving constant); with
    --dbof_int8_serving (and --dbof_use_pallas, as in the JAX model) and
    uint8 frames the kernel is the int8 one, its
    weights quantized from the f32 cluster kernel and the folded affines
    (float frames keep the bf16 kernel, as in the JAX model); average
    pooling runs the JAX model's unfused graph in plain PyTorch. Training
    runs that graph for either pooling, as the JAX model does (its
    kernel is serving-only), with both inline BatchNorms on batch
    moments, and adds `regularization_loss`. Parameter and buffer names
    are the JAX model's (`convert.py` carries them over).

    In a tensor-parallel run `cluster_kernel` may be one rank's block of
    clusters (parallel/tensor.py): the training graph multiplies by it,
    runs the cluster BN (its moments over the data group), the ReLU and
    the pooling on the block with this rank's slice of the per-cluster
    parameters, and gathers the pooled [B, K] over the model group
    before the hidden FC, never the [B x frames, K] activations.
    """

    gated = False
    pooling_override = ""

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        d, k, h = hp.feature_dim, hp.dbof_cluster_size, hp.dbof_hidden_size
        self.cluster_kernel = nn.Parameter(torch.empty(d, k))
        if hp.dbof_add_batch_norm:
            self.input_bn_scale = nn.Parameter(torch.ones(d))
            self.input_bn_bias = nn.Parameter(torch.zeros(d))
            self.register_buffer("input_bn_mean", torch.zeros(d))
            self.register_buffer("input_bn_var", torch.ones(d))
            self.cluster_bn_scale = nn.Parameter(torch.ones(k))
            self.cluster_bn_bias = nn.Parameter(torch.zeros(k))
            self.register_buffer("cluster_bn_mean", torch.zeros(k))
            self.register_buffer("cluster_bn_var", torch.ones(k))
        else:
            self.cluster_bias = nn.Parameter(torch.zeros(k))
        self.hidden_kernel = nn.Parameter(torch.empty(k, h))
        if hp.dbof_add_batch_norm:
            self.hidden_bn = BatchNorm(h, axis=hp.bn_axis)
        else:
            self.hidden_bias = nn.Parameter(torch.zeros(h))
        if self.gated:
            self.context_gate = ContextGate(h, hp.dbof_add_batch_norm,
                                            hp.dtype, hp.bn_axis)
        self.video_classifier = make_classifier_head(hp, h)
        self.reset_parameters()

    @property
    def pooling(self) -> str:
        return self.pooling_override or self.hp.dbof_pooling_method

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        hp = self.hp
        with torch.no_grad():
            self.cluster_kernel.normal_(
                0.0, hp.feature_dim ** -0.5, generator=generator)
            self.hidden_kernel.normal_(
                0.0, hp.dbof_cluster_size ** -0.5, generator=generator)
            if not hp.dbof_add_batch_norm:
                self.cluster_bias.normal_(0.0, 0.01, generator=generator)
                self.hidden_bias.normal_(0.0, 0.01, generator=generator)
        if self.gated:
            self.context_gate.reset_parameters(generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def make_serving_constants(self) -> dict:
        hp = self.hp
        d, k = hp.feature_dim, hp.dbof_cluster_size
        dev = self.cluster_kernel.device
        if hp.dbof_add_batch_norm:
            s_in, b_in = bn_fold(self.input_bn_scale, self.input_bn_bias,
                                 self.input_bn_mean, self.input_bn_var,
                                 BN_EPS)
            s_act, b_act = bn_fold(self.cluster_bn_scale,
                                   self.cluster_bn_bias,
                                   self.cluster_bn_mean,
                                   self.cluster_bn_var, BN_EPS)
        else:
            s_in = torch.ones(d, device=dev)
            b_in = torch.zeros(d, device=dev)
            s_act = torch.ones(k, device=dev)
            b_act = self.cluster_bias.detach().clone()
        c = {
            "cluster_w": self.cluster_kernel.to(hp.dtype).contiguous(),
            # The f32 kernel reads W's TF32 split copy, made once here.
            "cluster_w_split": ([split_weights(self.cluster_kernel)]
                                if hp.dtype == torch.float32
                                and self.pooling == "max" else []),
            # uint8 input: dequantize folded into the input affine
            "affine_u8": ((DEQUANT_SCALE * s_in).contiguous(),
                          (DEQUANT_BIAS * s_in + b_in).contiguous()),
            "affine_float": (s_in.contiguous(), b_in.contiguous()),
            "act_affine": (s_act.contiguous(), b_act.contiguous()),
            "hidden_w": rounded(self.hidden_kernel, hp.dtype),
        }
        if hp.dbof_int8_serving and hp.dbof_use_pallas:
            # From the f32 cluster kernel, not its bf16 copy.
            c["int8"] = int8_serving_constants(
                self.cluster_kernel, *c["affine_u8"], *c["act_affine"])
            # w8's cluster-major storage [K, D] as a plain tensor (what an
            # exported program carries; the forward transposes the view).
            c["int8_w8t"] = c["int8"][0].t()
        return c

    def _cluster_pool_plain(self, x_raw):
        """Steps 2-3 as the JAX model's unfused graph (BN unfolded; batch
        moments in training)."""
        hp = self.hp
        b, s, d = x_raw.shape
        x = ensure_float(x_raw).reshape(b * s, d)
        if hp.dbof_add_batch_norm:
            x = inline_bn(x, self.input_bn_scale, self.input_bn_bias,
                          self.input_bn_mean, self.input_bn_var,
                          self.training, hp.bn_axis)
        blk = tensor.block_of(self.cluster_kernel)
        x = rounded(x, hp.dtype)
        if blk is not None:
            x = tensor.copy_to_model(x)
        act = torch.matmul(x, rounded(self.cluster_kernel, hp.dtype))
        if hp.dbof_add_batch_norm:
            act = inline_bn(act, tensor.take_columns(self.cluster_bn_scale,
                                                     blk),
                            tensor.take_columns(self.cluster_bn_bias, blk),
                            self.cluster_bn_mean, self.cluster_bn_var,
                            self.training, hp.bn_axis, blk)
        else:
            act = act + tensor.take_columns(self.cluster_bias, blk)
        act = torch.relu(act).reshape(b, s, -1)
        if self.pooling == "soft":
            return tensor.gather_columns(soft_pooling(act, blk), blk)
        return tensor.gather_columns(frame_pooling(act, self.pooling), blk)

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training
        "regularization_loss".

        `generator` drives the frame sampling; `u` (the uniforms, [B, S]
        for random frames or [B, 1] for a random sequence) overrides it.
        """
        hp = self.hp
        sampler = (sample_random_frames if hp.sample_random_frames
                   else sample_random_sequence)
        x_raw = sampler(features, num_frames, hp.iterations,
                        generator=generator, u=u)
        fused = self.pooling == "max" and not self.training
        # The JAX model takes the int8 kernel only with --dbof_use_pallas;
        # without it, its unfused graph computes v2's function.
        if (fused and hp.dbof_int8_serving and hp.dbof_use_pallas
                and x_raw.dtype == torch.uint8):
            c = self.serving_constants()
            pooled = dbof_cluster_maxpool_int8(
                x_raw.contiguous(), c["int8_w8t"].t(), *c["int8"][1:])
        elif fused:
            c = self.serving_constants()
            s_in, b_in = c["affine_u8" if x_raw.dtype == torch.uint8
                           else "affine_float"]
            if x_raw.dtype not in (torch.uint8, torch.float32):
                x_raw = x_raw.to(torch.float32)
            pooled = dbof_cluster_maxpool_v2(
                x_raw.contiguous(), c["cluster_w"], s_in, b_in,
                *c["act_affine"], c["cluster_w_split"],
            )
        else:
            if not self.training:
                tensor.refuse_blocks(self)
            pooled = self._cluster_pool_plain(x_raw)

        hidden_w = (rounded(self.hidden_kernel, hp.dtype) if self.training
                    else self.serving_constants()["hidden_w"])
        hidden = torch.matmul(rounded(pooled, hp.dtype), hidden_w)
        if hp.dbof_add_batch_norm:
            hidden = self.hidden_bn(hidden)
        else:
            hidden = hidden + self.hidden_bias
        hidden = torch.relu(hidden)
        if self.gated:
            hidden = self.context_gate(hidden)
        out = self.video_classifier(hidden)
        if self.training:
            out["regularization_loss"] = (
                out["regularization_loss"]
                + hp.l2_penalty * l2_loss(self.cluster_kernel,
                                          self.hidden_kernel))
        return out


@register("GatedDbofModel", frame_level=True)
class GatedDbofModel(DbofModel):
    """DBoF with a context gate on the hidden representation; serves on
    the DBoF kernels as DbofModel does."""

    gated = True


@register("SoftDbofModel", frame_level=True)
class SoftDbofModel(DbofModel):
    """DBoF with softmax-normalised (soft-count) pooling."""

    pooling_override = "soft"
