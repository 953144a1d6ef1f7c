"""Video-level classifier heads (reference: video_level_models.py).

Weights keep the JAX package's names and its [in, out] layout. In a
tensor-parallel run (--model_parallel) a head kernel or bias may be one
rank's block of columns (parallel/tensor.py): the training forward
multiplies by the block and gathers the logits' columns over the model
group, then runs the rest of the head replicated. The logits, not the
probabilities, are gathered, so any split that JAX's policy allows is
right, a block edge inside a class's mixtures too.
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.kernels.moe_head import pitched_buffer
from yt8m_tpu_torch.kernels.ops import moe_head as moe_head_serving
from yt8m_tpu_torch.kernels.tf32 import split_weights
from yt8m_tpu_torch.models.norm import BatchNorm
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.parallel import tensor


def l2_loss(*kernels) -> torch.Tensor:
    """tf.nn.l2_loss semantics: sum(w**2) / 2, summed over kernels (a
    tensor-parallel block's summed over its model group)."""
    total = 0
    for k in kernels:
        part = torch.sum(torch.square(k.to(torch.float32))) / 2.0
        total = total + (part if tensor.block_of(k) is None
                         else tensor.sum_to_model(part))
    return total


def rounded(w: torch.Tensor, dtype) -> torch.Tensor:
    """w rounded to the compute dtype and widened to f32: an f32 product
    of rounded operands is the JAX model's product in `dtype` with f32
    accumulation. Differentiable (the casts pass the gradient through)."""
    return w.to(dtype).to(torch.float32)


def lecun_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Normal with std 1/sqrt(fan_in) for an [in, out] kernel."""
    with torch.no_grad():
        return w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)


class LogisticHead(ServingModule):
    """Single sigmoid FC over the vocabulary.

    Reference: video_level_models.py :: LogisticModel.create_model (the
    JAX package's heads.py :: LogisticHead): `logistic_kernel` [in,
    vocab] and `logistic_bias`, the product f32 on operands rounded to
    the compute dtype. The JAX package has no kernel for it, so on the
    card too it is one torch.matmul. Training adds
    `regularization_loss` = l2_penalty * l2_loss(kernel).
    """

    def __init__(self, in_features: int, vocab_size: int = 4716,
                 dtype=torch.float32, l2_penalty: float = 1e-8):
        super().__init__()
        self.dtype = dtype
        self.l2_penalty = l2_penalty
        self.logistic_kernel = nn.Parameter(
            torch.empty(in_features, vocab_size))
        self.logistic_bias = nn.Parameter(torch.zeros(vocab_size))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_normal_(self.logistic_kernel, generator)
        with torch.no_grad():
            self.logistic_bias.zero_()
        self._serving = None

    def make_serving_constants(self) -> dict:
        return {"kernel": rounded(self.logistic_kernel, self.dtype)}

    def forward(self, x):
        kernel = (rounded(self.logistic_kernel, self.dtype) if self.training
                  else self.serving_constants()["kernel"])
        logits, = tensor.column_products(rounded(x, self.dtype), [kernel],
                                         [self.logistic_kernel])
        out = {"predictions": torch.sigmoid(
            logits + tensor.whole(self.logistic_bias))}
        if self.training:
            out["regularization_loss"] = self.l2_penalty * l2_loss(
                self.logistic_kernel)
        return out


class MoeHead(ServingModule):
    """Per-class mixture-of-experts logistic head.

    Reference: video_level_models.py :: MoeModel.create_model — a softmax
    over num_mixtures + 1 gate logits per class (the extra "dummy"
    expert lets the model abstain), sigmoid experts, and the gate-weighted
    sum over the real experts. Gate columns are class-major,
    c*(M+1)+m; expert columns c*M+m.

    Serving runs the fused head (kernels/moe_head.py): its ratio-form
    softmax with clamped logits is the TPU kernel's, and its weights in
    the compute dtype select the bf16 or the f32 kernel on the card, as
    the JAX head passes dtype=hp.dtype. The serving constants are the
    bf16 weights as pitched views or, at f32, the weights' TF32 split
    copies that the f32 kernel reads (kernels/tf32.py). With
    `use_pallas` off (--moe_head_pallas=false) serving runs the JAX
    head's plain graph instead, as the JAX model does: an exact f32
    softmax over the M + 1 gate logits, with no clamp, on the CPU and on
    the card alike. Training always runs that plain graph (the JAX kernel
    is serving-only) and adds `regularization_loss` = l2_penalty *
    l2_loss(gates, experts).
    """

    def __init__(self, in_features: int, vocab_size: int = 4716,
                 num_mixtures: int = 2, dtype=torch.float32,
                 l2_penalty: float = 1e-8, use_pallas: bool = True):
        super().__init__()
        m = num_mixtures
        self.vocab_size = vocab_size
        self.num_mixtures = m
        self.dtype = dtype
        self.l2_penalty = l2_penalty
        self.use_pallas = use_pallas
        self.gates_kernel = nn.Parameter(
            torch.empty(in_features, vocab_size * (m + 1)))
        self.experts_kernel = nn.Parameter(
            torch.empty(in_features, vocab_size * m))
        self.experts_bias = nn.Parameter(torch.zeros(vocab_size * m))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_normal_(self.gates_kernel, generator)
        lecun_normal_(self.experts_kernel, generator)
        with torch.no_grad():
            self.experts_bias.zero_()
        self._serving = None

    def make_serving_constants(self) -> dict:
        if not self.use_pallas:
            return {"gates": rounded(self.gates_kernel, self.dtype),
                    "experts": rounded(self.experts_kernel, self.dtype)}
        if self.dtype == torch.float32:
            # The f32 kernel reads the weights' split copies, made once per
            # weight version; the weights themselves serve the CPU.
            return {"split": [split_weights(self.gates_kernel),
                              split_weights(self.experts_kernel)]}
        # The kernel reads rows at a stride that is a multiple of 8: views
        # of padded buffers, which the forward slices itself, so that an
        # exported program carries the plain buffers.
        buffers = (pitched_buffer(self.gates_kernel.to(self.dtype)),
                   pitched_buffer(self.experts_kernel.to(self.dtype)))
        m, c = self.num_mixtures, self.vocab_size
        return {"gates": buffers[0][:, :c * (m + 1)],
                "experts": buffers[1][:, :c * m], "buffers": buffers}

    def forward(self, x):
        if self.training:
            return {
                "predictions": self._plain(x, rounded(
                    self.gates_kernel, self.dtype), rounded(
                        self.experts_kernel, self.dtype)),
                "regularization_loss": self.l2_penalty * l2_loss(
                    self.gates_kernel, self.experts_kernel),
            }
        c = self.serving_constants()
        if not self.use_pallas:
            return {"predictions": self._plain(x, c["gates"], c["experts"])}
        m, v = self.num_mixtures, self.vocab_size
        if self.dtype == torch.float32:
            gates, experts = (self.gates_kernel.detach(),
                              self.experts_kernel.detach())
        else:
            gates, experts = c["buffers"]
        probs = moe_head_serving(
            x.to(torch.float32).contiguous(), gates[:, :v * (m + 1)],
            experts[:, :v * m],
            self.experts_bias.detach(), self.num_mixtures,
            c.get("split", []),
        )
        return {"predictions": probs}

    def _plain(self, x, gates, experts):
        """The JAX head's plain graph on the kernels rounded to the compute
        dtype (f32 products of rounded operands, an exact f32 softmax);
        a tensor-parallel block's logits gathered whole."""
        m, c = self.num_mixtures, self.vocab_size
        b = x.shape[0]
        gate_logits, expert_logits = tensor.column_products(
            rounded(x, self.dtype), [gates, experts],
            [self.gates_kernel, self.experts_kernel])
        expert_logits = expert_logits + tensor.whole(self.experts_bias)
        gating = torch.softmax(gate_logits.reshape(b, c, m + 1), dim=-1)
        experts = torch.sigmoid(expert_logits.reshape(b, c, m))
        return torch.sum(gating[..., :m] * experts, dim=-1)


class ContextGate(ServingModule):
    """Context gating of the gated-NetVLAD family.

    Reference: the JAX package's heads.py :: ContextGate (WILLOW /
    monkeytyping): y = x * sigmoid(BN(x @ W)), or x * sigmoid(x @ W + b)
    without BatchNorm. The product is f32 on operands rounded to the
    compute dtype, as the JAX model's bf16 product with f32 accumulation.
    """

    def __init__(self, dim: int, add_batch_norm: bool = True,
                 dtype=torch.float32, bn_axis: str = ""):
        super().__init__()
        self.dtype = dtype
        self.gating_kernel = nn.Parameter(torch.empty(dim, dim))
        if add_batch_norm:
            self.gating_bn = BatchNorm(dim, axis=bn_axis)
        else:
            self.gating_bias = nn.Parameter(torch.zeros(dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        lecun_normal_(self.gating_kernel, generator)
        if hasattr(self, "gating_bias"):
            with torch.no_grad():
                self.gating_bias.zero_()
        self._serving = None

    def make_serving_constants(self) -> dict:
        return {"kernel": rounded(self.gating_kernel, self.dtype)}

    def forward(self, x):
        kernel = (rounded(self.gating_kernel, self.dtype) if self.training
                  else self.serving_constants()["kernel"])
        gates = torch.matmul(rounded(x, self.dtype), kernel)
        if hasattr(self, "gating_bn"):
            gates = self.gating_bn(gates)
        else:
            gates = gates + self.gating_bias
        return x * torch.sigmoid(gates)
