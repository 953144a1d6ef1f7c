"""Train state and optimizer (reference: the JAX package's
train/state.py).

The reference trains with Adam (eps 1e-8) under an exponential learning
rate decay staircased on examples seen, after clipping each gradient by
its own norm (utils.py :: clip_gradient_norms, not a global-norm clip).
optax's Adam and torch.optim.Adam place eps the same way, outside the
square root of the bias-corrected second moment. The JAX package's other
optimizers, and Adam with a bf16 first moment (--adam_mu_dtype), follow
optax in train/optimizers.py. An optional EMA keeps a Polyak average of
the parameters.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from yt8m_tpu_torch.train.optimizers import (
    Adafactor,
    Adagrad,
    AdamBf16Mu,
    RMSProp,
)

OPTIMIZERS = ("AdamOptimizer", "AdafactorOptimizer", "SgdOptimizer",
              "GradientDescentOptimizer", "RMSPropOptimizer",
              "AdagradOptimizer")
ADAM_MU_DTYPES = ("float32", "bfloat16")


def make_lr_schedule(base_learning_rate: float, learning_rate_decay: float,
                     learning_rate_decay_examples: int,
                     global_batch_size: int) -> Callable[[int], float]:
    """lr(step) = base * decay ** floor(step / transition), transition =
    max(decay_examples // batch, 1) (optax.exponential_decay, staircase)."""
    transition = max(learning_rate_decay_examples // global_batch_size, 1)

    def schedule(step: int) -> float:
        return base_learning_rate * learning_rate_decay ** math.floor(
            step / transition)

    return schedule


def clip_gradient_norms(params, max_norm: float) -> None:
    """Scale each gradient in place by min(1, max_norm / max(||g||,
    1e-12)), its own norm. The norm is summed in float64 on either
    device: the CPU's float32 reduction drifts by percents over the 3e8
    elements of the flagship's VLAD hidden FC."""
    for p in params:
        if p.grad is None:
            continue
        norm = torch.linalg.vector_norm(p.grad, dtype=torch.float64)
        scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
        p.grad.mul_(scale.to(p.grad.dtype))


def make_optimizer(params, optimizer: str = "AdamOptimizer",
                   fused: Optional[bool] = None,
                   adam_mu_dtype: str = "float32") -> torch.optim.Optimizer:
    """The optimizer with a placeholder learning rate (the train state
    sets each step's from the schedule), as the JAX package's
    make_optimizer builds it with optax."""
    if adam_mu_dtype not in ADAM_MU_DTYPES:
        raise ValueError(f"--adam_mu_dtype={adam_mu_dtype!r}; available "
                         f"{list(ADAM_MU_DTYPES)}")
    if optimizer == "AdamOptimizer":
        if adam_mu_dtype == "bfloat16":
            return AdamBf16Mu(params, lr=0.0)
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                fused=fused)
    if optimizer in ("SgdOptimizer", "GradientDescentOptimizer"):
        return torch.optim.SGD(params, lr=0.0)
    makers = {"AdafactorOptimizer": Adafactor, "RMSPropOptimizer": RMSProp,
              "AdagradOptimizer": Adagrad}
    if optimizer in makers:
        return makers[optimizer](params, lr=0.0)
    raise ValueError(f"unknown optimizer {optimizer!r}; "
                     f"available {sorted(OPTIMIZERS)}")


class TrainState:
    """The model, its optimizer and schedule, the step count and the
    optional EMA of the parameters ({name: f32 tensor}, or None)."""

    def __init__(self, model: torch.nn.Module, optimizer: str = "AdamOptimizer",
                 base_learning_rate: float = 0.01,
                 learning_rate_decay: float = 0.95,
                 learning_rate_decay_examples: int = 4_000_000,
                 global_batch_size: int = 1024,
                 clip_gradient_norm: float = 1.0, ema: bool = False,
                 adam_mu_dtype: str = "float32"):
        self.model = model
        self.params = [p for p in model.parameters() if p.requires_grad]
        on_card = all(p.is_cuda for p in self.params)
        self.optimizer = make_optimizer(
            self.params, optimizer,
            fused=True if on_card and optimizer == "AdamOptimizer" else None,
            adam_mu_dtype=adam_mu_dtype)
        self.schedule = make_lr_schedule(base_learning_rate,
                                         learning_rate_decay,
                                         learning_rate_decay_examples,
                                         global_batch_size)
        self.clip_gradient_norm = clip_gradient_norm
        self.step = 0
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().to(torch.float32).clone()
             for n, p in model.named_parameters()} if ema else None)

    def apply_gradients(self) -> None:
        """Clip, then one optimizer update at this step's learning rate.
        A parameter without a gradient takes a zero one, as optax does."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip_gradient_norm > 0:
            clip_gradient_norms(self.params, self.clip_gradient_norm)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1
        self.model.invalidate_serving()

    def update_ema(self, decay: float) -> None:
        """ema = decay * ema + (1 - decay) * params."""
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                e = self.ema[n]
                e.copy_(decay * e + (1.0 - decay) * p.to(torch.float32))
