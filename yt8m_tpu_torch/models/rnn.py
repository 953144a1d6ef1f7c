"""Stacked LSTM and GRU, uni- and bidirectional (reference: the JAX
package's models/rnn.py :: _LstmLayer, _GruLayer, _run_rnn, LstmModel,
BiLstmModel, GruModel, BiGruModel).

dynamic_rnn(sequence_length) semantics: for t >= num_frames the carry
passes through unchanged, so the final state is the state at the last
real frame; the backward direction runs reversed time with the same
freeze, so its final state has consumed exactly the valid prefix. Cells
are TF1 BasicLSTMCell (gate order i, j, f, o; forget bias 1.0) and TF1
GRUCell (gates r, u with bias 1.0 in the parameters; the candidate reads
r * h).

Dispatch follows the JAX package: at compute dtype bf16 a layer runs a
recurrence kernel after its bf16 input projections (X @ W_x for the
LSTM; X @ W_xg and X @ W_xc for the GRU), the serving one
(kernels/lstm.py, kernels/gru.py) in eval mode and the trainable one
(kernels/lstm_train.py, kernels/gru_train.py, torch.autograd.Functions
whose backward is a kernel too) in training, each the CUDA kernel on the
card and its plain version on the CPU; at float32 it runs the scan
graph, concat([x, h]) @ kernel per step in float32 (the GRU's candidate
concat([x, r * h]) @ candidate_kernel), under autograd in training, on
the CPU and on the card alike (the JAX model runs its scan graph at
float32 too; the recurrence kernels are bf16).

The layer-norm LSTM (--lstm_layer_norm, LayerNormLstmModel) is TF1's
LayerNormBasicLSTMCell and runs the JAX layer's scan graph at either
dtype, serving and training, on the card too: the JAX package never
sends it to its recurrence kernel (`use_pallas=hp.lstm_use_pallas and
not layer_norm`).
"""

from __future__ import annotations

import torch
from torch import nn

from yt8m_tpu_torch.kernels.gru_train import gru_recurrence_trainable
from yt8m_tpu_torch.kernels.lstm_train import lstm_recurrence_trainable
from yt8m_tpu_torch.kernels.ops import gru as gru_recurrence
from yt8m_tpu_torch.kernels.ops import lstm as lstm_recurrence
from yt8m_tpu_torch.models.frame_utils import (
    ensure_float,
    frame_mask,
    frame_pooling,
)
from yt8m_tpu_torch.models.heads import rounded
from yt8m_tpu_torch.models.hparams import ModelHParams
from yt8m_tpu_torch.models.registry import register
from yt8m_tpu_torch.models.serving import ServingModule
from yt8m_tpu_torch.models.video import make_classifier_head


LN_EPS = 1e-6


def layer_norm(x, scale, bias, eps: float = LN_EPS):
    """Layer norm over the last axis with the population variance, in the
    JAX layer's order: (x - mean) * rsqrt(var + eps) * scale + bias."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


class LstmLayer(ServingModule):
    """One LSTM layer: `kernel` [D+H, 4H] (rows :D act on x, D: on h) and
    `bias` [4H], as the JAX layer holds them. With `layer_norm` there is
    no `bias`: `ln_scale` and `ln_bias` [5, H] normalise the four gate
    pre-activations and the new cell state."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32,
                 reverse: bool = False, layer_norm: bool = False):
        super().__init__()
        self.in_features = in_features
        self.hidden = hidden
        self.dtype = dtype
        self.reverse = reverse
        self.layer_norm = layer_norm
        self.kernel = nn.Parameter(torch.empty(in_features + hidden,
                                               4 * hidden))
        if layer_norm:
            self.ln_scale = nn.Parameter(torch.ones(5, hidden))
            self.ln_bias = nn.Parameter(torch.zeros(5, hidden))
        else:
            self.bias = nn.Parameter(torch.zeros(4 * hidden))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """glorot_uniform kernel, zero bias (ones and zeros for the layer
        norms), as the JAX layer."""
        fan_in, fan_out = self.kernel.shape
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        with torch.no_grad():
            self.kernel.uniform_(-limit, limit, generator=generator)
            if self.layer_norm:
                self.ln_scale.fill_(1.0)
                self.ln_bias.zero_()
            else:
                self.bias.zero_()
        self._serving = None

    def make_serving_constants(self) -> dict:
        d = self.in_features
        return {
            "wx": self.kernel[:d].to(torch.bfloat16).contiguous(),
            "wh": self.kernel[d:].to(torch.bfloat16).contiguous(),
        }

    def forward(self, xs, num_frames):
        """xs [F, B, D] float, time-major -> (outputs [F, B, H] f32,
        (final_c, final_h) [B, H] f32)."""
        if self.layer_norm:
            return self._ln_scan(xs, num_frames)
        if self.dtype == torch.bfloat16:
            return self._recurrence(xs, num_frames)
        return self._scan(xs, num_frames)

    def _recurrence(self, xs, num_frames):
        d = self.in_features
        nf = num_frames.to(torch.int32).contiguous()
        if self.training:
            # Gradients reach kernel[:D] through the projection, kernel[D:]
            # and bias through the trainable recurrence.
            xp = torch.matmul(xs.to(torch.bfloat16),
                              self.kernel[:d].to(torch.bfloat16))
            if self.reverse:
                xp = torch.flip(xp, dims=(0,))
            outputs, state = lstm_recurrence_trainable(
                xp.contiguous(), nf, self.kernel[d:], self.bias,
                reverse=self.reverse)
        else:
            c = self.serving_constants()
            xp = torch.matmul(xs.to(torch.bfloat16), c["wx"])  # [F, B, 4H]
            if self.reverse:
                xp = torch.flip(xp, dims=(0,))
            outputs, *state = lstm_recurrence(
                xp.contiguous(), nf, c["wh"], self.bias.detach(),
                self.reverse)
            state = tuple(state)
        if self.reverse:
            outputs = torch.flip(outputs, dims=(0,))
        return outputs, state

    def _scan(self, xs, num_frames):
        """The JAX layer's scan graph at float32."""
        f, b, _ = xs.shape
        nf = num_frames.to(torch.int64)[:, None]
        h = torch.zeros((b, self.hidden), dtype=torch.float32,
                        device=xs.device)
        c = torch.zeros_like(h)
        outputs = [None] * f
        for t in (reversed(range(f)) if self.reverse else range(f)):
            z = torch.matmul(torch.cat([xs[t], h], dim=-1), self.kernel)
            z = z + self.bias
            zi, zj, zf, zo = torch.split(z, self.hidden, dim=-1)
            c1 = (c * torch.sigmoid(zf + 1.0)
                  + torch.sigmoid(zi) * torch.tanh(zj))
            h1 = torch.tanh(c1) * torch.sigmoid(zo)
            live = nf > t
            c = torch.where(live, c1, c)
            h = torch.where(live, h1, h)
            outputs[t] = h
        return torch.stack(outputs), (c, h)

    def _ln_scan(self, xs, num_frames):
        """The JAX layer's layer-norm scan: concat([x, h]) @ kernel on
        operands rounded to the compute dtype (f32 sums), each gate
        layer-normed, the forget gate's +1, the new cell state
        layer-normed before its tanh; masked steps carry (c, h). The
        product is split as x @ kernel[:D], for all steps at once, plus
        h @ kernel[D:] a step (the same sums in another order), and the
        four gates are normalised as one [B, 4, H] tensor, so that a step
        makes ~30 launches (the step is bound by them on the card)."""
        f, b, _ = xs.shape
        d, hid = self.in_features, self.hidden
        nf = num_frames.to(torch.int64)[:, None]
        kernel = rounded(self.kernel, self.dtype)
        xp = torch.matmul(rounded(xs, self.dtype), kernel[:d])  # [F, B, 4H]
        kh = kernel[d:]
        gate_scale, gate_bias = self.ln_scale[:4], self.ln_bias[:4]
        h = torch.zeros((b, hid), dtype=torch.float32, device=xs.device)
        c = torch.zeros_like(h)
        outputs = [None] * f
        for t in (reversed(range(f)) if self.reverse else range(f)):
            z = xp[t] + torch.matmul(rounded(h, self.dtype), kh)
            zi, zj, zf, zo = layer_norm(z.view(b, 4, hid), gate_scale,
                                        gate_bias).unbind(1)
            c1 = (c * torch.sigmoid(zf + 1.0)
                  + torch.sigmoid(zi) * torch.tanh(zj))
            h1 = torch.tanh(layer_norm(c1, self.ln_scale[4],
                                       self.ln_bias[4])) * torch.sigmoid(zo)
            live = nf > t
            c = torch.where(live, c1, c)
            h = torch.where(live, h1, h)
            outputs[t] = h
        return torch.stack(outputs), (c, h)


def add_lstm_stack(model: nn.Module, in_features: int, hidden: int,
                   layers: int, dtype, bidirectional: bool,
                   layer_norm: bool = False) -> int:
    """Register `fw_layer{i}` (and `bw_layer{i}`) on `model`, the JAX
    names; returns the width of the pooled output."""
    tags = (("fw", False), ("bw", True)) if bidirectional else (("fw", False),)
    for tag, reverse in tags:
        for i in range(layers):
            setattr(model, f"{tag}_layer{i}", LstmLayer(
                in_features if i == 0 else hidden, hidden, dtype,
                reverse=reverse, layer_norm=layer_norm))
    return hidden * len(tags)


class GruLayer(ServingModule):
    """One GRU layer: `gate_kernel` [D+H, 2H] (r and u columns),
    `gate_bias` [2H], `candidate_kernel` [D+H, H] and `candidate_bias`
    [H], as the JAX layer holds them (rows :D act on x, D: on h)."""

    def __init__(self, in_features: int, hidden: int, dtype=torch.float32,
                 reverse: bool = False):
        super().__init__()
        self.in_features = in_features
        self.hidden = hidden
        self.dtype = dtype
        self.reverse = reverse
        self.gate_kernel = nn.Parameter(torch.empty(in_features + hidden,
                                                    2 * hidden))
        self.gate_bias = nn.Parameter(torch.ones(2 * hidden))
        self.candidate_kernel = nn.Parameter(torch.empty(in_features + hidden,
                                                         hidden))
        self.candidate_bias = nn.Parameter(torch.zeros(hidden))
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """glorot_uniform kernels, gate bias 1 and candidate bias 0, as the
        JAX layer."""
        with torch.no_grad():
            for w in (self.gate_kernel, self.candidate_kernel):
                limit = (6.0 / sum(w.shape)) ** 0.5
                w.uniform_(-limit, limit, generator=generator)
            self.gate_bias.fill_(1.0)
            self.candidate_bias.zero_()
        self._serving = None

    def make_serving_constants(self) -> dict:
        d = self.in_features
        return {name: w.to(torch.bfloat16).contiguous() for name, w in (
            ("wxg", self.gate_kernel[:d]), ("whg", self.gate_kernel[d:]),
            ("wxc", self.candidate_kernel[:d]),
            ("whc", self.candidate_kernel[d:]))}

    def forward(self, xs, num_frames):
        """xs [F, B, D] float, time-major -> (outputs [F, B, H] f32,
        (final_h, final_h) [B, H] f32)."""
        if self.dtype == torch.bfloat16:
            outputs, h = self._recurrence(xs, num_frames)
        else:
            outputs, h = self._scan(xs, num_frames)
        return outputs, (h, h)

    def _recurrence(self, xs, num_frames):
        d = self.in_features
        nf = num_frames.to(torch.int32).contiguous()
        xb = xs.to(torch.bfloat16)
        if self.training:
            # Gradients reach the kernels' rows :D through the
            # projections, their rows D: and the biases through the
            # trainable recurrence.
            xg = torch.matmul(xb, self.gate_kernel[:d].to(torch.bfloat16))
            xc = torch.matmul(xb, self.candidate_kernel[:d].to(
                torch.bfloat16))
            if self.reverse:
                xg, xc = torch.flip(xg, dims=(0,)), torch.flip(xc, dims=(0,))
            outputs, h = gru_recurrence_trainable(
                xg.contiguous(), xc.contiguous(), nf, self.gate_kernel[d:],
                self.candidate_kernel[d:], self.gate_bias,
                self.candidate_bias, reverse=self.reverse)
        else:
            c = self.serving_constants()
            xg = torch.matmul(xb, c["wxg"])  # [F, B, 2H]
            xc = torch.matmul(xb, c["wxc"])  # [F, B, H]
            if self.reverse:
                xg, xc = torch.flip(xg, dims=(0,)), torch.flip(xc, dims=(0,))
            outputs, h = gru_recurrence(
                xg.contiguous(), xc.contiguous(), nf, c["whg"], c["whc"],
                self.gate_bias.detach(), self.candidate_bias.detach(),
                self.reverse)
        if self.reverse:
            outputs = torch.flip(outputs, dims=(0,))
        return outputs, h

    def _scan(self, xs, num_frames):
        """The JAX layer's scan graph at float32."""
        f, b, _ = xs.shape
        nf = num_frames.to(torch.int64)[:, None]
        h = torch.zeros((b, self.hidden), dtype=torch.float32,
                        device=xs.device)
        outputs = [None] * f
        for t in (reversed(range(f)) if self.reverse else range(f)):
            gates = torch.sigmoid(torch.matmul(
                torch.cat([xs[t], h], dim=-1), self.gate_kernel)
                + self.gate_bias)
            r, u = torch.split(gates, self.hidden, dim=-1)
            cand = torch.tanh(torch.matmul(
                torch.cat([xs[t], r * h], dim=-1), self.candidate_kernel)
                + self.candidate_bias)
            h = torch.where(nf > t, u * h + (1.0 - u) * cand, h)
            outputs[t] = h
        return torch.stack(outputs), h


def add_gru_stack(model: nn.Module, in_features: int, hidden: int,
                  layers: int, dtype, bidirectional: bool) -> int:
    """Register `fw_layer{i}` (and `bw_layer{i}`) GRU layers on `model`,
    the JAX names; returns the width of the pooled output."""
    tags = (("fw", False), ("bw", True)) if bidirectional else (("fw", False),)
    for tag, reverse in tags:
        for i in range(layers):
            setattr(model, f"{tag}_layer{i}", GruLayer(
                in_features if i == 0 else hidden, hidden, dtype,
                reverse=reverse))
    return hidden * len(tags)


def run_rnn(model: nn.Module, features, num_frames, layers: int,
            bidirectional: bool, pooling: str, residual: bool = False):
    """features [B, F, D] -> pooled [B, H * directions], through the
    layers `add_lstm_stack` or `add_gru_stack` registered on `model`.

    `residual` adds each layer's input to its output from layer 1 on
    (layer 0 changes the width), and "last" pooling then takes the
    residual-summed output at the boundary frame.
    """
    features = ensure_float(features)
    f = features.shape[1]
    xs = features.transpose(0, 1)  # time-major
    mask = frame_mask(num_frames, f)

    def stack(tag: str, reverse: bool):
        h_in = xs
        final_h = None
        for i in range(layers):
            outputs, (_, final_h) = getattr(model, f"{tag}_layer{i}")(
                h_in, num_frames)
            if residual and i > 0:
                outputs = outputs + h_in
            h_in = outputs
        if residual:
            final_h = h_in[0] if reverse else h_in[-1]
        return h_in, final_h

    outputs, last = stack("fw", False)
    if bidirectional:
        outs_bw, last_bw = stack("bw", True)
        outputs = torch.cat([outputs, outs_bw], dim=-1)
        last = torch.cat([last, last_bw], dim=-1)
    if pooling == "last":
        return last
    return frame_pooling(outputs.transpose(0, 1), pooling, mask)


class _RnnModelBase(ServingModule):
    """Reference: the JAX package's _RnnModelBase: the stacked LSTM
    (--lstm_cells, --lstm_layers) or GRU (--gru_cells, --gru_layers)
    pooled per --lstm_pooling, then the video-level head."""

    cell = "lstm"
    bidirectional = False
    force_layer_norm = False  # LayerNormLstmModel: whatever the flag says

    def __init__(self, hp: ModelHParams):
        super().__init__()
        self.hp = hp
        if self.cell == "lstm":
            self.layers = hp.lstm_layers
            width = add_lstm_stack(
                self, hp.feature_dim, hp.lstm_cells, hp.lstm_layers,
                hp.dtype, self.bidirectional,
                self.force_layer_norm or hp.lstm_layer_norm)
        else:
            self.layers = hp.gru_layers
            width = add_gru_stack(self, hp.feature_dim, hp.gru_cells,
                                  hp.gru_layers, hp.dtype, self.bidirectional)
        self.video_classifier = make_classifier_head(hp, width)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """The JAX model's initialisers, drawn from `generator`."""
        for name, module in self.named_children():
            if name.startswith(("fw_layer", "bw_layer")):
                module.reset_parameters(generator)
        self.video_classifier.reset_parameters(generator)
        self.invalidate_serving()

    def forward(self, features, num_frames, generator=None, u=None):
        """{"predictions": [B, vocab] f32}, and in training the head's
        "regularization_loss". Nothing is sampled."""
        hp = self.hp
        pooled = run_rnn(self, features, num_frames, self.layers,
                         self.bidirectional, hp.lstm_pooling,
                         hp.rnn_residual)
        return self.video_classifier(pooled)


@register("LstmModel", frame_level=True)
class LstmModel(_RnnModelBase):
    cell = "lstm"
    bidirectional = False


@register("BiLstmModel", frame_level=True)
class BiLstmModel(_RnnModelBase):
    cell = "lstm"
    bidirectional = True


@register("GruModel", frame_level=True)
class GruModel(_RnnModelBase):
    cell = "gru"
    bidirectional = False


@register("BiGruModel", frame_level=True)
class BiGruModel(_RnnModelBase):
    cell = "gru"
    bidirectional = True


@register("LayerNormLstmModel", frame_level=True)
class LayerNormLstmModel(_RnnModelBase):
    """Stacked layer-norm LSTM (also reachable as --model=LstmModel
    --lstm_layer_norm)."""

    cell = "lstm"
    bidirectional = False
    force_layer_norm = True
