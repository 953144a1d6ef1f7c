"""Inference loop (reference: inference.py :: inference, format_lines).

Writes the Kaggle submission CSV — `VideoId,LabelConfidencePairs` with
top-k `class score` pairs. The forward and the top-k run on the device,
so only [B, 2k] numbers cross back to the host per batch.
"""

from __future__ import annotations

import gzip
import logging
import time

import numpy as np
import torch

from yt8m_tpu_torch.config import InferenceConfig
from yt8m_tpu_torch.convert import load_model
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.kernels.topk import TOPK_NEG, serving_topk

log = logging.getLogger("yt8m_tpu_torch.infer")


def format_lines(video_ids, top_values, top_indices):
    """One CSV line per video: `vid,cls1 p1 cls2 p2 ...` sorted desc.

    Reference inference.py :: format_lines ("%i %g" pairs).
    """
    lines = []
    for vid, vals, idxs in zip(video_ids, top_values, top_indices):
        order = np.argsort(-vals, kind="stable")
        pairs = " ".join(
            "%i %g" % (int(idxs[j]), float(vals[j])) for j in order
        )
        vid_str = vid.decode() if isinstance(vid, bytes) else str(vid)
        lines.append(f"{vid_str},{pairs}\n")
    return lines


def make_topk_predict_step(model, top_k: int = 20):
    """(features, num_frames, generator) -> (values [B,k] f32, indices
    [B,k] int32), both on the model's device."""

    @torch.inference_mode()
    def step(features, num_frames, generator=None):
        out = model(features, num_frames, generator=generator)
        k = min(top_k, out["predictions"].shape[-1])
        return serving_topk(out["predictions"], k)

    return step


def inference(cfg: InferenceConfig, model=None) -> dict:
    """Top-k CSV for every video matched by cfg.input_data_pattern.

    Runs on cfg.device ("cuda" unless the caller asks for "cpu"); loads
    the model from cfg.train_dir unless one is given.
    """
    device = resolve_device(cfg.device)
    if model is None:
        model = load_model(cfg.train_dir, cfg.model,
                           cfg.resolved_hparams(), device)
    step = make_topk_predict_step(model, cfg.top_k)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    reader = ReaderConfig(
        feature_names=cfg.feature_names,
        feature_sizes=cfg.feature_sizes,
        frame_features=cfg.frame_features,
        num_classes=cfg.num_classes,
        max_frames=cfg.max_frames,
    )
    it = BatchIterator(cfg.input_data_pattern, reader,
                       batch_size=cfg.batch_size)
    opener = gzip.open if cfg.output_file.endswith(".gz") else open
    n_videos = 0
    nonfinite = 0
    t0 = time.perf_counter()
    with opener(cfg.output_file, "wt") as f:
        f.write("VideoId,LabelConfidencePairs\n")
        for batch in it:
            keep = batch["batch_mask"] > 0
            features = torch.from_numpy(batch["features"]).to(device)
            num_frames = torch.from_numpy(batch["num_frames"]).to(device)
            values, indices = step(features, num_frames, generator)
            values = values.cpu().numpy()[keep]
            indices = indices.cpu().numpy()[keep]
            ids = [v for v, m in zip(batch["id"], keep) if m]
            # Diverged-checkpoint tripwire: NaN/inf confidences, or the
            # top-k sanitisation value, must not ship silently.
            nonfinite += int(np.sum(~(np.isfinite(values)
                                      & (values > TOPK_NEG))))
            f.writelines(format_lines(ids, values, indices))
            n_videos += int(keep.sum())
    dt = max(time.perf_counter() - t0, 1e-9)
    stats = {
        "num_videos": n_videos,
        "videos_per_sec": n_videos / dt,
        "nonfinite_predictions": nonfinite,
        "device": str(device),
    }
    if nonfinite:
        log.warning(
            "%d non-finite prediction values written — the checkpoint has "
            "likely diverged and the output is not meaningful", nonfinite,
        )
    log.info("inference done: %d videos at %.1f videos/sec -> %s",
             n_videos, stats["videos_per_sec"], cfg.output_file)
    return stats
