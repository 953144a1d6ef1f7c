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

With --model_parallel=mp the ranks form a (data, model) grid
(parallel/distributed.py :: use_grid) and the state is the JAX package's
GSPMD step's: a parameter that the TP policy shards on its last dim is,
in the model itself, this rank's block of columns (parallel/tensor.py),
and so are its gradient, optimizer state and EMA: no rank holds the
whole variable. The models multiply by the block and gather what they
need; a block's gradient is complete on its rank once the data group
has summed it, its clip norm sums the blocks' squares over the model
group, and Adafactor decides on the whole variable's shape and sums its
means over the model group (train/optimizers.py). Every gradient is
reduced over the data group only (the model group's ranks hold the same
rows); FSDP blocks are the data group's. `model_state` gathers the
blocks into the one-card state_dict and `load_model_state` cuts them
again, so a checkpoint moves between grids.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from yt8m_tpu_torch.parallel import distributed, tensor
from yt8m_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    param_specs,
    shard_rows,
)
from yt8m_tpu_torch.train.optimizers import (
    Adafactor,
    Adagrad,
    AdamBf16Mu,
    RMSProp,
    factored_dims,
    factored_state_is_block,
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
                        groups: Optional[Dict[int, object]] = None) -> None:
    """Scale each gradient in place by min(1, max_norm / max(||g||,
    1e-12)), its own norm. The norm is summed in float64 on either
    device: the CPU's float32 reduction drifts by percents over the 3e8
    elements of the flagship's VLAD hidden FC. A tensor whose id is in
    `groups` is one rank's block of a variable: its norm is the whole
    variable's, the blocks' sums of squares summed over the group given
    (the JAX package's train/state.py :: _leaf_sumsq)."""
    groups = groups or {}
    for p in params:
        if p.grad is None:
            continue
        if id(p) in groups:
            sumsq = torch.sum(torch.square(p.grad.to(torch.float64)))
            norm = torch.sqrt(distributed.all_reduce_(sumsq,
                                                      group=groups[id(p)]))
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

    def model_state(self) -> dict:
        """The model's state_dict, whole."""
        return self.model.state_dict()

    def load_model_state(self, saved: dict) -> None:
        """Load a whole state_dict into the model."""
        self.model.load_state_dict(saved)
        self.model_loaded()

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
    docstring). `shards` holds this rank's dim-0 blocks of the FSDP
    variables, by name (the model holds them whole); `blocks` the
    tensor-parallel variables' Blocks, by name (the model holds only
    this rank's columns)."""

    def __init__(self, model: torch.nn.Module, fsdp_min_size: int = 0,
                 optimizer: str = "AdamOptimizer", model_parallel: int = 1,
                 **kw):
        self.grid = distributed.use_grid(model_parallel)
        self.world = distributed.process_count()
        self.rank = distributed.process_index()
        g = self.grid
        specs = param_specs(model, self.world, fsdp_min_size, g.model)
        self.shards: Dict[str, torch.nn.Parameter] = {}
        self.blocks: Dict[str, tensor.Block] = {}
        self._rows = {}
        for name, p in list(model.named_parameters()):
            spec = specs.get(name, ())
            if MODEL_AXIS in spec:
                blk = tensor.Block(p.shape[-1], g.model_index, g.model)
                block = torch.nn.Parameter(
                    tensor.columns(p.detach(), blk).clone(),
                    requires_grad=p.requires_grad)
                block.tp = blk
                owner, _, leaf = name.rpartition(".")
                setattr(model.get_submodule(owner), leaf, block)
                self.blocks[name] = blk
                continue
            if DATA_AXIS not in spec:
                continue
            rows = shard_rows(p.shape[0], g.data_index, g.data)
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
        groups = {}
        for n, p in zip(self._names, self._stepped):
            if n in self.blocks:
                groups[id(p)] = distributed.model_group()
            elif n in self.shards:
                groups[id(p)] = distributed.data_group()
        self._clip_groups = groups
        super().__init__(model, optimizer=optimizer, **kw)

    def stepped(self) -> list:
        return self._stepped

    def fresh_ema(self) -> Dict[str, torch.Tensor]:
        return {n: self.shards.get(n, p).detach().to(torch.float32).clone()
                for n, p in self.model.named_parameters()}

    def reduce_gradients(self, extra: torch.Tensor) -> torch.Tensor:
        """Sum the gradients of the replicated parameters and of this
        rank's tensor-parallel blocks, and `extra` (a 1-d tensor: the
        step's loss contributions), over the data group, in one flat
        all-reduce a dtype (the 1M-element and larger gradients each in
        place), and reduce-scatter each FSDP parameter's into its
        block's. Returns the summed `extra`."""
        group = distributed.data_group()
        flat: Dict[torch.dtype, list] = {}
        for name, p in zip(self._names, self.params):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if name in self.shards:
                shard = self.shards[name]
                shard.grad = distributed.reduce_scatter_rows(p.grad, group)
                p.grad = None
            elif p.grad.numel() >= 1 << 20:
                distributed.all_reduce_(p.grad, group=group)
            else:
                flat.setdefault(p.grad.dtype, []).append(p.grad)
        flat.setdefault(extra.dtype, []).append(extra)
        for tensors in flat.values():
            buf = torch.cat([t.reshape(-1) for t in tensors])
            distributed.all_reduce_(buf, group=group)
            for t, part in zip(tensors, torch.split(
                    buf, [t.numel() for t in tensors])):
                t.copy_(part.view_as(t))
        return extra

    def apply_gradients(self) -> None:
        """Clip (a sharded variable by its whole norm), one optimizer
        update of the replicated parameters and this rank's blocks, then
        the FSDP blocks gathered into the model's full parameters."""
        if self.clip_gradient_norm > 0:
            clip_gradient_norms(self._stepped, self.clip_gradient_norm,
                                self._clip_groups)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, shard in self.shards.items():
                distributed.all_gather_rows(shard, out=params[name].data,
                                            group=distributed.data_group())
        self.step += 1
        self.model.invalidate_serving()

    def update_ema(self, decay: float) -> None:
        with torch.no_grad():
            for n, p in self.model.named_parameters():
                e = self.ema[n]
                src = self.shards.get(n, p)
                e.copy_(decay * e + (1.0 - decay) * src.to(torch.float32))

    # -- the checkpoint's one-card format ---------------------------------

    def _is_block(self, name: str, key: str, t) -> bool:
        """Whether `t` (an optimizer statistic `key`, or the EMA, of the
        sharded variable `name`) is this rank's block of its whole."""
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return False
        if name in self.blocks:
            return factored_state_is_block(
                key, self.model.get_parameter(name))
        return True

    def _gather(self, name: str, t, key: str = ""):
        """A sharded variable's tensor `t` (this rank's block) gathered
        whole; other values as they are."""
        if not self._is_block(name, key, t):
            return t
        if name in self.blocks:
            return distributed.all_gather_rows(
                t, group=distributed.model_group(), dim=-1)
        shard = self.shards[name]
        if tuple(t.shape) != tuple(shard.shape):
            raise ValueError(f"{name}: optimizer state of shape "
                             f"{tuple(t.shape)} is not per-row of its block "
                             f"{tuple(shard.shape)}")
        return distributed.all_gather_rows(t, group=distributed.data_group())

    def _slice(self, name: str, t, key: str = ""):
        """This rank's block of a sharded variable's whole tensor `t`."""
        if name in self.blocks:
            if not isinstance(t, torch.Tensor) or t.dim() == 0:
                return t
            p = self.model.get_parameter(name)
            if not factored_state_is_block(key, p):
                return t
            return tensor.columns(t, self.blocks[name]).clone()
        rows = self._rows[name]
        if not isinstance(t, torch.Tensor) or t.dim() == 0:
            return t
        full = tuple(self.model.get_parameter(name).shape)
        if tuple(t.shape) != full:
            raise ValueError(f"{name}: saved optimizer state of shape "
                             f"{tuple(t.shape)} cannot be sharded like the "
                             f"parameter {full}")
        return t[rows].clone()

    def _sharded(self, name: str) -> bool:
        return name in self.shards or name in self.blocks

    def model_state(self) -> dict:
        """The model's state_dict with the blocks gathered whole (every
        rank takes part)."""
        return {k: self._gather(k, v) if k in self.blocks else v
                for k, v in self.model.state_dict().items()}

    def load_model_state(self, saved: dict) -> None:
        self.model.load_state_dict(
            {k: self._slice(k, v) if k in self.blocks else v
             for k, v in saved.items()})
        self.model_loaded()

    def optimizer_state(self) -> dict:
        saved = self.optimizer.state_dict()
        for i, name in enumerate(self._names):
            if self._sharded(name) and i in saved["state"]:
                saved["state"][i] = {k: self._gather(name, v, k) for k, v in
                                     saved["state"][i].items()}
        return saved

    def load_optimizer_state(self, saved: dict) -> None:
        saved = dict(saved, state=dict(saved["state"]))
        for i, name in enumerate(self._names):
            if self._sharded(name) and i in saved["state"]:
                saved["state"][i] = {k: self._slice(name, v, k) for k, v in
                                     saved["state"][i].items()}
        super().load_optimizer_state(saved)

    def ema_state(self) -> Optional[Dict[str, torch.Tensor]]:
        if self.ema is None:
            return None
        return {n: self._gather(n, e) if self._sharded(n) else e
                for n, e in self.ema.items()}

    def load_ema(self, saved: Dict[str, torch.Tensor]) -> None:
        super().load_ema({n: self._slice(n, v) if self._sharded(n) else v
                          for n, v in saved.items()})

    def model_loaded(self) -> None:
        params = dict(self.model.named_parameters())
        with torch.no_grad():
            for name, shard in self.shards.items():
                shard.copy_(params[name][self._rows[name]])
