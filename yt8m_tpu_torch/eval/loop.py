"""Evaluation loop (reference: eval.py :: evaluation_loop; the JAX
package's eval/loop.py), on one device.

Streams the eval split through the model's serving forward, accumulates
GAP@20, Hit@1, PERR, mAP and the average loss, writes them as epoch
summaries under train_dir/eval, and logs the reference's line. With
--device_metric_topk=K > 0 (the default 64) only each video's top-K
triplets cross to the host (make_sparse_eval_step); 0 is the dense path.
Modes: one checkpoint (--run_once, or --checkpoint_step), polling for
new checkpoints, or a sweep of every existing one (--max_evaluations=-1).
Ensemble evaluation is not ported.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from yt8m_tpu_torch.config import EvalConfig
from yt8m_tpu_torch.convert import load_model
from yt8m_tpu_torch.data.readers import BatchIterator
from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.metrics import EvaluationMetrics
from yt8m_tpu_torch.train import losses as losses_lib
from yt8m_tpu_torch.train.checkpoint import step_dirs
from yt8m_tpu_torch.train.loop import reader_config_from, to_device
from yt8m_tpu_torch.train.step import make_eval_step, make_sparse_eval_step
from yt8m_tpu_torch.utils.summary import SummaryWriter

log = logging.getLogger("yt8m_tpu_torch.eval")
POLL_SECONDS = 10.0  # the reference eval.py's wait between polls


def evaluate_checkpoint(config: EvalConfig,
                        step: Optional[int] = None) -> Dict:
    """Evaluate one checkpoint of config.train_dir (`step`, else
    --checkpoint_step, else the latest); the metric dict of
    EvaluationMetrics.get() plus videos_per_sec, step and
    nonfinite_predictions."""
    cfg = config
    device = resolve_device(cfg.device)
    model = load_model(
        cfg.train_dir, cfg.model, cfg.resolved_hparams(), device,
        checkpoint_step=step if step is not None else cfg.checkpoint_step,
        use_ema_weights=cfg.use_ema_weights)
    step = model.checkpoint_step
    loss_obj = losses_lib.get_loss(cfg.label_loss)
    it = BatchIterator(cfg.eval_data_pattern, reader_config_from(cfg),
                       batch_size=cfg.batch_size, shuffle=False, num_epochs=1,
                       pad_final_batch=True)
    sparse_k = int(cfg.device_metric_topk or 0)
    if sparse_k > 0:
        sparse_k = max(sparse_k, cfg.top_k)
        eval_step = make_sparse_eval_step(model, loss_obj, sparse_k)
    else:
        eval_step = make_eval_step(model, loss_obj)
    metrics = EvaluationMetrics(cfg.num_classes, top_k=cfg.top_k)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)

    n_videos = 0
    nonfinite = 0
    t0 = time.time()
    for batch in it:
        mask = batch["batch_mask"]
        outs = eval_step(to_device(batch, device), generator)
        if sparse_k > 0:
            h = {k: v.cpu().numpy() for k, v in outs.items()}
            nonfinite += int(h["nonfinite_predictions"])
            metrics.accumulate_topk(
                h["topk_values"], h["topk_indices"], h["topk_labels"],
                h["labels_per_video"], h["class_positives"], h["loss"], mask)
        else:
            preds = outs[0].cpu().numpy()
            nonfinite += int(np.sum(~np.isfinite(preds[mask > 0])))
            metrics.accumulate(preds, batch["labels"], outs[1].cpu().numpy(),
                               mask)
        n_videos += int(mask.sum())

    out = metrics.get()
    out["videos_per_sec"] = n_videos / max(time.time() - t0, 1e-9)
    out["step"] = step
    out["nonfinite_predictions"] = nonfinite
    if nonfinite:
        log.warning(
            "%d non-finite prediction values encountered during this "
            "evaluation — the checkpoint has likely diverged and the "
            "metrics are not meaningful", nonfinite,
        )
    mean_ap = float(np.mean(out["aps"])) if out["aps"] else 0.0
    if cfg.train_dir:
        sw = SummaryWriter(cfg.train_dir + "/eval")
        sw.add_epoch_summary(step or 0, {
            "Avg_Hit@1": out["avg_hit_at_one"],
            "Avg_PERR": out["avg_perr"],
            "MAP": mean_ap,
            "GAP": out["gap"],
            "Avg_Loss": out["avg_loss"],
        })
        sw.close()
    log.info(
        "epoch/eval number %s | Avg_Hit@1: %.5f | Avg_PERR: %.5f | "
        "MAP: %.5f | GAP: %.5f | Avg_Loss: %.5f",
        step, out["avg_hit_at_one"], out["avg_perr"], mean_ap,
        out["gap"], out["avg_loss"],
    )
    return out


def evaluation_loop(config: EvalConfig,
                    max_evaluations: Optional[int] = None) -> Dict:
    """--run_once (or --checkpoint_step): one evaluation. Otherwise poll
    train_dir and evaluate each new checkpoint once, ascending, stopping
    after max_evaluations (the argument, else --max_evaluations; None or
    0 polls forever, as the reference eval.py; -1 evaluates every existing
    checkpoint and exits, also when there is none). Returns the last
    metric dict ({} when nothing was evaluated)."""
    if config.run_once or config.checkpoint_step is not None:
        return evaluate_checkpoint(config, step=config.checkpoint_step)
    if max_evaluations is None:
        max_evaluations = config.max_evaluations or None
    sweep_only = max_evaluations == -1
    if sweep_only:
        max_evaluations = None
    seen = set()
    last: Dict = {}
    while True:
        steps = [s for s in step_dirs(config.train_dir) if s not in seen]
        if not steps:
            if sweep_only:
                if not seen:
                    log.warning(
                        "--max_evaluations=-1: no checkpoints found in %s — "
                        "nothing evaluated", config.train_dir)
                return last
            if max_evaluations is not None and len(seen) >= max_evaluations:
                return last
            time.sleep(POLL_SECONDS)
            continue
        for s in steps:
            last = evaluate_checkpoint(config, step=s)
            seen.add(s)
            if max_evaluations is not None and len(seen) >= max_evaluations:
                return last
