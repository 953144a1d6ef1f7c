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

ParallelTrainState is one rank's state in a multi-GPU run (the JAX
package's manual train step's state, train/step.py:210): every rank
holds the whole model, and a parameter that the FSDP policy shards
(parallel/mesh.py :: param_spec) is stepped as this rank's dim-0 block,
its optimizer state and EMA sharded alike. Its gradient arrives
reduce-scattered, its clip factor is the whole variable's (the float64
sums of squares of the blocks, summed over the ranks), and after the
update the blocks are gathered back into the model's full tensor, the
one the next forward and every kernel-ready copy read. Elementwise
optimizers step a block as they step a tensor. Adafactor steps the block
as optax does a sharded leaf under shard_map: its second moment and the
two RMS factors (the update clip and the parameter scale) are the
block's own, and whether it factors is decided on the block's shape (the
JAX manual step fails on a block that factors, and so does this one).
A checkpoint holds the gathered tensors, the one-card format.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional

import torch

from yt8m_tpu_torch.parallel import distributed
from yt8m_tpu_torch.parallel.mesh import is_sharded, param_specs, shard_rows
from yt8m_tpu_torch.train.optimizers import (
    Adafactor,
    Adagrad,
    AdamBf16Mu,
    RMSProp,
    factored_dims,
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


def clip_gradient_norms(params, max_norm: float,
                        sharded: Iterable[torch.Tensor] = ()) -> None:
    """Scale each gradient in place by min(1, max_norm / max(||g||,
    1e-12)), its own norm. The norm is summed in float64 on either
    device: the CPU's float32 reduction drifts by percents over the 3e8
    elements of the flagship's VLAD hidden FC. A tensor in `sharded` is
    one rank's block of a variable: its norm is the whole variable's, the
    blocks' sums of squares summed over the ranks (the JAX package's
    train/state.py :: _leaf_sumsq)."""
    sharded_ids = {id(p) for p in sharded}
    for p in params:
        if p.grad is None:
            continue
        if id(p) in sharded_ids:
            sumsq = torch.sum(torch.square(p.grad.to(torch.float64)))
            norm = torch.sqrt(distributed.all_reduce_(sumsq))
        else:
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
            self.stepped(), optimizer,
            fused=True if on_card and optimizer == "AdamOptimizer" else None,
            adam_mu_dtype=adam_mu_dtype)
        self.schedule = make_lr_schedule(base_learning_rate,
                                         learning_rate_decay,
                                         learning_rate_decay_examples,
                                         global_batch_size)
        self.clip_gradient_norm = clip_gradient_norm
        self.step = 0
        self.ema: Optional[Dict[str, torch.Tensor]] = (
            self.fresh_ema() if ema else None)

    def stepped(self) -> list:
        """The tensors the optimizer steps, in the order of `params`."""
        return self.params

    def fresh_ema(self) -> Dict[str, torch.Tensor]:
        """An EMA seeded from the current parameters."""
        return {n: p.detach().to(torch.float32).clone()
                for n, p in self.model.named_parameters()}

    # The checkpoint's view of the state (train/checkpoint.py): the
    # one-card format, which a ParallelTrainState gathers and re-shards.

    def optimizer_state(self) -> dict:
        return self.optimizer.state_dict()

    def load_optimizer_state(self, saved: dict) -> None:
        # Which implementation runs the update (fused on the card) is the
        # live optimizer's, not part of the saved state.
        for group, live in zip(saved["param_groups"],
                               self.optimizer.param_groups):
            for key in ("fused", "foreach", "capturable"):
                if key in live:
                    group[key] = live[key]
        self.optimizer.load_state_dict(saved)

    def ema_state(self) -> Optional[Dict[str, torch.Tensor]]:
        return self.ema

    def load_ema(self, saved: Dict[str, torch.Tensor]) -> None:
        for name, value in saved.items():
            self.ema[name].copy_(value.to(self.ema[name].device))

    def model_loaded(self) -> None:
        """Called after the model's weights were replaced (a restore)."""

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


class ParallelTrainState(TrainState):
    """One rank's TrainState in a multi-GPU run (see the module's
    docstring). `shards` holds this rank's blocks of the sharded
    parameters, by name."""

    def __init__(self, model: torch.nn.Module, fsdp_min_size: int = 0,
                 optimizer: str = "AdamOptimizer", **kw):
        self.world = distributed.process_count()
        self.rank = distributed.process_index()
        specs = param_specs(model, self.world, fsdp_min_size)
        self.shards: Dict[str, torch.nn.Parameter] = {}
        self._rows = {}
        for name, p in model.named_parameters():
            if not is_sharded(specs.get(name, ())):
                continue
            rows = shard_rows(p.shape[0], self.rank, self.world)
            shard = torch.nn.Parameter(p.detach()[rows].clone())
            if (optimizer == "AdafactorOptimizer"
                    and factored_dims(tuple(shard.shape)) is not None):
                raise ValueError(
                    f"AdafactorOptimizer would factor the block "
                    f"{tuple(shard.shape)} of the sharded {name}: the JAX "
                    f"manual step fails on such a leaf; raise "
                    f"--fsdp_min_size above {p.numel()} to replicate it")
            self.shards[name] = shard
            self._rows[name] = rows
        trainable = [(n, p) for n, p in model.named_parameters()
                     if p.requires_grad]
        self._names = [n for n, _ in trainable]
        self._stepped = [self.shards.get(n, p) for n, p in trainable]
        super().__init__(model, optimizer=optimizer, **kw)

    def stepped(self) -> list:
        return self._stepped

    def fresh_ema(self) -> Dict[str, torch.Tensor]:
        return {n: self.shards.get(n, p).detach().to(torch.float32).clone()
                for n, p in self.model.named_parameters()}

    def reduce_gradients(self, extra: torch.Tensor) -> torch.Tensor:
        """Sum the replicated parameters' gradients and `extra` (a 1-d
        tensor: the step's loss contributions) over the ranks, in one
        flat all-reduce a dtype (the 1M-element and larger gradients each
        in place), and reduce-scatter each sharded parameter's into its
        block's. Returns the summed `extra`."""
        flat: Dict[torch.dtype, list] = {}
        for name, p in zip(self._names, self.params):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if name in self.shards:
                shard = self.shards[name]
                shard.grad = distributed.reduce_scatter_rows(p.grad)
                p.grad = None
            elif p.grad.numel() >= 1 << 20:
                distributed.all_reduce_(p.grad)
            else:
                flat.setdefault(p.grad.dtype, []).append(p.grad)
        flat.setdefault(extra.dtype, []).append(extra)
        for tensors in flat.values():
            buf = torch.cat([t.reshape(-1) for t in tensors])
            distributed.all_reduce_(buf)
            for t, part in zip(tensors, torch.split(
                    buf, [t.numel() for t in tensors])):
                t.copy_(part.view_as(t))
        return extra

    def apply_gradients(self) -> None:
        """Clip (a sharded variable by its whole norm), one optimizer
        update of the replicated parameters and this rank's blocks, then
        the blocks gathered into the model's full parameters."""
        if self.clip_gradient_norm > 0:
            clip_gradient_norms(self._stepped, self.clip_gradient_norm,
                                sharded=self.shards.values())
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, shard in self.shards.items():
                distributed.all_gather_rows(shard, out=params[name].data)
        self.step += 1
        self.model.invalidate_serving()

    def update_ema(self, decay: float) -> None:
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                e = self.ema[n]
                src = self.shards.get(n, p)
                e.copy_(decay * e + (1.0 - decay) * src.to(torch.float32))

    # -- the checkpoint's one-card format ---------------------------------

    def _gather(self, name: str, t):
        """A sharded variable's per-row tensor `t` (this rank's block)
        gathered whole; other values as they are."""
        shard = self.shards[name]
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        if tuple(t.shape) != tuple(shard.shape):
            raise ValueError(f"{name}: optimizer state of shape "
                             f"{tuple(t.shape)} is not per-row of its block "
                             f"{tuple(shard.shape)}")
        return distributed.all_gather_rows(t)

    def _slice(self, name: str, t):
        rows = self._rows[name]
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        full = tuple(self.model.get_parameter(name).shape)
        if tuple(t.shape) != full:
            raise ValueError(f"{name}: saved optimizer state of shape "
                             f"{tuple(t.shape)} cannot be sharded like the "
                             f"parameter {full}")
        return t[rows].clone()

    def optimizer_state(self) -> dict:
        saved = self.optimizer.state_dict()
        for i, name in enumerate(self._names):
            if name in self.shards and i in saved["state"]:
                saved["state"][i] = {k: self._gather(name, v) for k, v in
                                     saved["state"][i].items()}
        return saved

    def load_optimizer_state(self, saved: dict) -> None:
        saved = dict(saved, state=dict(saved["state"]))
        for i, name in enumerate(self._names):
            if name in self.shards and i in saved["state"]:
                saved["state"][i] = {k: self._slice(name, v) for k, v in
                                     saved["state"][i].items()}
        super().load_optimizer_state(saved)

    def ema_state(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.ema is None:
            return None
        return {n: self._gather(n, e) if n in self.shards else e
                for n, e in self.ema.items()}

    def load_ema(self, saved: Dict[str, torch.Tensor]) -> None:
        super().load_ema({n: self._slice(n, v) if n in self.shards else v
                          for n, v in saved.items()})

    def model_loaded(self) -> None:
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, shard in self.shards.items():
                shard.copy_(params[name][self._rows[name]])
