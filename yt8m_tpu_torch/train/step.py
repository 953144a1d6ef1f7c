"""The train step (reference: the JAX package's train/step.py ::
make_train_step, single device).

One step: the model's training forward (BatchNorm running statistics
move once), the label loss as a masked mean over `batch_mask` (times
`example_weights` when the batch has them), aux losses times
`aux_loss_weight`, `regularization_penalty` times the model's
regularization loss, the backward, the per-variable clip and the
optimizer update, then the EMA.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.train.losses import BaseLoss
from yt8m_tpu_torch.train.state import TrainState


def masked_mean(per_example, mask):
    return torch.sum(per_example * mask) / torch.clamp_min(torch.sum(mask),
                                                          1.0)


def compute_loss(model, batch: dict, loss_obj: BaseLoss,
                 regularization_penalty: float = 1.0,
                 aux_loss_weight: float = 0.5, generator=None, u=None):
    """The model's forward on `batch` in its current mode and the step's
    objective: (total, label_loss, regularization_loss, model outputs)."""
    labels = batch["labels"]
    mask = batch["batch_mask"].to(torch.float32)
    teacher = batch.get("teacher")
    weights = batch.get("example_weights")
    if weights is not None:
        mask = mask * weights
    out = model(batch["features"], batch["num_frames"], generator=generator,
                u=u)
    label_loss = masked_mean(
        loss_obj.calculate_loss(out["predictions"], labels, teacher=teacher),
        mask)
    total = label_loss
    for aux in out.get("aux_predictions", []):
        total = total + aux_loss_weight * masked_mean(
            loss_obj.calculate_loss(aux, labels, teacher=teacher), mask)
    reg = out.get("regularization_loss",
                  torch.zeros((), device=label_loss.device))
    return total + regularization_penalty * reg, label_loss, reg, out


def make_train_step(loss_obj: BaseLoss, regularization_penalty: float = 1.0,
                    aux_loss_weight: float = 0.5, ema_decay: float = 0.0):
    """train_step(state, batch, generator=None, u=None) -> (state, metrics).

    `batch` holds tensors on the model's device: features, labels,
    num_frames, batch_mask, and optionally example_weights and teacher.
    `generator` or the uniforms `u` drive the model's frame sampling.
    Metrics: loss, label_loss, reg_loss (0-d tensors) and predictions.
    """

    def train_step(state: TrainState, batch: dict, generator=None, u=None):
        state.model.train()
        total, label_loss, reg, out = compute_loss(
            state.model, batch, loss_obj, regularization_penalty,
            aux_loss_weight, generator, u)
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        state.apply_gradients()
        if ema_decay > 0.0 and state.ema is not None:
            state.update_ema(ema_decay)
        metrics = {
            "loss": total.detach(),
            "label_loss": label_loss.detach(),
            "reg_loss": torch.as_tensor(reg).detach(),
            "predictions": out["predictions"].detach(),
        }
        return state, metrics

    return train_step
