"""The train and eval steps (reference: the JAX package's train/step.py
:: make_train_step, make_eval_step, make_sparse_eval_step; single
device).

One step: the model's training forward (BatchNorm running statistics
move once), the label loss as a masked mean over `batch_mask` (times
`example_weights` when the batch has them), aux losses times
`aux_loss_weight`, `regularization_penalty` times the model's
regularization loss, the backward, the per-variable clip and the
optimizer update, then the EMA.

An eval step runs the model in eval mode (its serving kernels on the
card) and the label loss per example. The sparse eval step returns, in
place of the dense [B, C] predictions, each video's top-K (value, class,
label) triplets through sorted_topk, its count of positive labels, the
batch's positives per class over real rows and the count of non-finite
predictions over real rows: all that EvaluationMetrics.accumulate_topk
needs, and all that crosses to the host.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels.topk import sorted_topk
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


def make_eval_step(model, loss_obj: BaseLoss):
    """eval_step(batch, generator=None) -> (predictions [B, C] f32,
    per-example loss [B]), on the model's device."""

    @torch.inference_mode()
    def eval_step(batch: dict, generator=None):
        model.eval()
        out = model(batch["features"], batch["num_frames"],
                    generator=generator)
        return out["predictions"], loss_obj.calculate_loss(
            out["predictions"], batch["labels"])

    return eval_step


def make_sparse_eval_step(model, loss_obj: BaseLoss, k: int):
    """eval_step(batch, generator=None) -> {"loss", "topk_values",
    "topk_indices", "topk_labels", "labels_per_video", "class_positives",
    "nonfinite_predictions"}, on the model's device."""
    dense = make_eval_step(model, loss_obj)

    @torch.inference_mode()
    def eval_step(batch: dict, generator=None):
        preds, per_ex = dense(batch, generator)
        labels = batch["labels"]
        vals, idx = sorted_topk(preds, min(k, preds.shape[-1]))
        pos = labels > 0
        row_keep = (batch["batch_mask"] > 0)[:, None]
        return {
            "loss": per_ex,
            "topk_values": vals,
            "topk_indices": idx,
            "topk_labels": torch.gather(labels, 1, idx.long()).to(
                torch.float32),
            "labels_per_video": pos.sum(dim=1).to(torch.int32),
            "class_positives": (pos & row_keep).sum(dim=0).to(torch.int32),
            "nonfinite_predictions": ((~torch.isfinite(preds)) & row_keep)
            .sum().to(torch.int32),
        }

    return eval_step
