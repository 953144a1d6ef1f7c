"""The optimizers of the JAX package's zoo that torch.optim does not match
(reference: yt8m_tpu/train/state.py :: make_optimizer, optax 0.2.6).

Each is a torch.optim.Optimizer, so a checkpoint saves and restores its
state with `state_dict()`, and each follows optax's update in its
arithmetic order, dtypes and constants, not torch.optim's defaults:

  * AdamBf16Mu: optax.adam(lr, eps=1e-8, mu_dtype=bfloat16). The update
    comes from the f32 first moment; only then is the stored moment cast
    to bf16, and the next step reads it back. optax multiplies the bf16
    moment by b1 in bf16 (the Python scalar takes the moment's dtype,
    bf16(0.9) = 0.8984375), then adds (1 - b1) g in f32. torch.optim's
    fused Adam keeps its moments in the parameters' dtype, so it cannot.
  * Adafactor: optax.adafactor(learning_rate=lr) at its defaults:
    factored second moments for a parameter whose two largest dimensions
    reach 128 (decay 1 - (t + 1)^-0.8, eps 1e-30 added to g^2), the
    update clipped to an RMS of 1, times lr, times the parameter's RMS
    (floored at 1e-3), negated; no momentum, no weight decay.
  * RMSProp: optax.rmsprop(lr): nu = 0.9 nu + 0.1 g^2 from nu = 0, the
    update g / sqrt(nu + 1e-8) (eps inside the root; torch.optim.RMSprop
    puts it outside).
  * Adagrad: optax.adagrad(lr): the sum of squares from 0.1, the update g
    / sqrt(sum + 1e-7) where the sum is positive.

Adafactor also steps a tensor-parallel block (parallel/tensor.py) as
the JAX package's GSPMD step steps the sharded leaf: whether it factors
is decided on the whole variable's shape, and its means over the
sharded dim (a factored statistic, the update's RMS, the parameter's
RMS) sum the blocks over the model group.

The learning rate is the group's "lr", which the train state sets each
step from the schedule (optax reads the same schedule at its own count).
The per-variable gradient clip runs before, as in the JAX chain. The
updates use torch._foreach_* ops where one op serves every parameter
(Adam, RMSProp, Adagrad) and a loop over parameters where the shapes
differ (Adafactor's factored moments). Plain PyTorch: the JAX package
has no kernel for any optimizer.
"""

from __future__ import annotations

import numpy as np
import torch

from yt8m_tpu_torch.parallel import tensor
from yt8m_tpu_torch.parallel.distributed import all_reduce_, model_group

F32 = torch.float32

# optax 0.2.6's defaults, the only values make_optimizer uses.
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
ADAFACTOR_DECAY_RATE = 0.8
ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR = 128
ADAFACTOR_EPS = 1e-30
ADAFACTOR_CLIPPING_THRESHOLD = 1.0
ADAFACTOR_MIN_SCALE = 1e-3
RMSPROP_DECAY, RMSPROP_EPS, RMSPROP_INITIAL_SCALE = 0.9, 1e-8, 0.0
ADAGRAD_INITIAL_ACCUMULATOR, ADAGRAD_EPS = 0.1, 1e-7


def _f32(x: float) -> float:
    """x rounded to f32, as optax's f32 scalar arithmetic gives it."""
    return torch.tensor(x, dtype=F32).item()


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in f32 (optax.tree.bias_correction)."""
    t = torch.tensor(decay, dtype=F32) ** torch.tensor(float(count),
                                                       dtype=F32)
    return (1.0 - t).item()


class _Optax(torch.optim.Optimizer):
    """The shared step: each group's parameters that have gradients, their
    state made on first use, one step count a parameter (optax keeps one
    for the whole tree; every parameter steps together here too). The
    only hyperparameter is the learning rate."""

    def __init__(self, params, lr: float = 0.0):
        super().__init__(params, dict(lr=lr))

    def _init_state(self, p, group) -> dict:
        raise NotImplementedError

    def _update(self, group, params, grads, states, count: int) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = []
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.int64)
                    st.update(self._init_state(p, group))
                states.append(st)
            count = int(states[0]["step"])  # optax's count before this step
            self._update(group, params, [p.grad for p in params], states,
                         count)
            for st in states:
                st["step"] += 1
        return loss


class AdamBf16Mu(_Optax):
    """optax.adam(lr, eps=1e-8, mu_dtype=jnp.bfloat16)."""

    def load_state_dict(self, state_dict) -> None:
        """torch.optim casts a loaded state to its parameter's dtype: the
        first moment is bf16 again after it."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "mu" in st:
                st["mu"] = st["mu"].to(torch.bfloat16)

    def _init_state(self, p, group):
        return {"mu": torch.zeros_like(p, dtype=torch.bfloat16,
                                       memory_format=torch.preserve_format),
                "nu": torch.zeros_like(p, memory_format=torch.preserve_format)}

    def _update(self, group, params, grads, states, count):
        b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
        mus = [s["mu"] for s in states]
        nus = [s["nu"] for s in states]
        # mu = (1 - b1) g + b1 mu: the product in bf16, with b1 in bf16.
        b1_bf16 = torch.tensor(b1, dtype=torch.bfloat16).item()
        decayed = torch._foreach_mul(mus, b1_bf16)
        mu = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mu, [d.to(F32) for d in decayed])
        # nu = (1 - b2) g^2 + b2 nu, in f32.
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - b2)
        torch._foreach_mul_(nus, b2)
        torch._foreach_add_(nus, g2)
        # The update from the f32 moment: mu_hat / (sqrt(nu_hat) + eps).
        mu_hat = torch._foreach_div(mu, _bias_correction(b1, count + 1))
        den = torch._foreach_div(nus, _bias_correction(b2, count + 1))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(mu_hat, den)
        torch._foreach_mul_(mu_hat, -_f32(group["lr"]))
        torch._foreach_add_(params, mu_hat)
        # Only now is the stored moment rounded to bf16.
        torch._foreach_copy_(mus, mu)


def factored_dims(shape):
    """optax's _factored_dims: (d1, d0), the second largest and the largest
    dimension, where the second largest reaches the threshold; else
    None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < ADAFACTOR_MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


def factored_state_is_block(key: str, p) -> bool:
    """Whether Adafactor's statistic `key` of the tensor-parallel block p
    is a block too, on its last dim (v is; v_row and v_col are unless
    they average over the sharded dim)."""
    if key not in ("v_row", "v_col"):
        return True
    d1, d0 = factored_dims(tensor.whole_shape(p))
    return (d0 if key == "v_row" else d1) != p.dim() - 1


def _mean(t, dim, sharded, blk, keepdim: bool = False):
    """The whole variable's mean of t over `dim` (None: every element):
    where t's dim `sharded` holds a tensor-parallel block's columns and
    the mean runs over it, the blocks' sums meet over the model group."""
    if sharded is None or (dim is not None and dim != sharded):
        return t.mean() if dim is None else t.mean(dim=dim, keepdim=keepdim)
    total = t.sum() if dim is None else t.sum(dim=dim, keepdim=keepdim)
    count = t.numel() if dim is None else t.shape[dim]
    return all_reduce_(total, group=model_group()) / (count * blk.parts)


class Adafactor(_Optax):
    """optax.adafactor(learning_rate=lr) at optax 0.2.6's defaults."""

    def _init_state(self, p, group):
        dims = factored_dims(tensor.whole_shape(p))
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": torch.zeros(np.delete(p.shape, d0).tolist(),
                                     dtype=p.dtype, device=p.device),
                "v_col": torch.zeros(np.delete(p.shape, d1).tolist(),
                                     dtype=p.dtype, device=p.device)}

    def _update(self, group, params, grads, states, count):
        # decay_t = 1 - (t + 1)^-0.8 in f32 (_decay_rate_pow).
        t = torch.tensor(float(count + 1), dtype=F32)
        decay = (1.0 - t ** (-ADAFACTOR_DECAY_RATE)).item()
        keep = _f32(1.0 - decay)
        lr = _f32(group["lr"])
        for p, g, st in zip(params, grads, states):
            # A block's sharded dim (its last), or None for a whole tensor.
            blk = tensor.block_of(p)
            last = None if blk is None else p.dim() - 1
            g2 = g * g + ADAFACTOR_EPS
            if "v" in st:
                v = st["v"]
                v.copy_(decay * v + keep * g2)
                u = g * v ** -0.5
            else:
                d1, d0 = factored_dims(tensor.whole_shape(p))
                v_row, v_col = st["v_row"], st["v_col"]
                v_row.copy_(decay * v_row + keep * _mean(g2, d0, last, blk))
                v_col.copy_(decay * v_col + keep * _mean(g2, d1, last, blk))
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_last = None if last in (None, d0) else last - 1
                row_col_mean = _mean(v_row, reduced_d1, row_last, blk,
                                     keepdim=True)
                row_factor = (v_row / row_col_mean) ** -0.5
                col_factor = v_col ** -0.5
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            # clip_by_block_rms, then lr, then the parameter's RMS.
            rms = torch.sqrt(_mean(u * u, None, last, blk))
            u = u / torch.clamp_min(rms / ADAFACTOR_CLIPPING_THRESHOLD, 1.0)
            u = u * lr
            p_rms = torch.sqrt(_mean(p * p, None, last, blk))
            scale = torch.where(p_rms <= ADAFACTOR_MIN_SCALE,
                                torch.full_like(p_rms, ADAFACTOR_MIN_SCALE),
                                p_rms)
            p.add_(u * scale * -1.0)


class RMSProp(_Optax):
    """optax.rmsprop(lr): decay 0.9, eps 1e-8 inside the square root, the
    second moment from 0."""

    def _init_state(self, p, group):
        return {"nu": torch.full_like(p, RMSPROP_INITIAL_SCALE)}

    def _update(self, group, params, grads, states, count):
        nus = [s["nu"] for s in states]
        g2 = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(g2, 1.0 - RMSPROP_DECAY)
        torch._foreach_mul_(nus, RMSPROP_DECAY)
        torch._foreach_add_(nus, g2)
        scaling = torch._foreach_add(nus, RMSPROP_EPS)
        torch._foreach_rsqrt_(scaling)
        torch._foreach_mul_(scaling, grads)
        torch._foreach_mul_(scaling, -_f32(group["lr"]))
        torch._foreach_add_(params, scaling)


class Adagrad(_Optax):
    """optax.adagrad(lr): the sum of squared gradients from 0.1, eps 1e-7
    inside the square root."""

    def _init_state(self, p, group):
        return {"sum_of_squares": torch.full_like(
            p, ADAGRAD_INITIAL_ACCUMULATOR)}

    def _update(self, group, params, grads, states, count):
        sums = [s["sum_of_squares"] for s in states]
        torch._foreach_add_(sums, torch._foreach_mul(grads, grads))
        for p, g, s in zip(params, grads, sums):
            inv = torch.where(s > 0, torch.rsqrt(s + ADAGRAD_EPS),
                              torch.zeros_like(s))
            p.add_(inv * g * -_f32(group["lr"]))
