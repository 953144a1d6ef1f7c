"""Inference loop (reference: inference.py :: inference, format_lines;
inference-pre-ensemble.py for the dumps; the JAX package's
infer/predict.py).

Writes the Kaggle submission CSV — `VideoId,LabelConfidencePairs` with
top-k `class score` pairs, formatted by the native formatter — and,
with --output_probabilities_dir, each batch's probabilities for the
ensembling stage: dense `predictions-%05d.npz` chunks (ids,
predictions in --output_probabilities_dtype), or with
--output_probabilities_topk=N each video's top N (values, indices,
num_classes), which ensemble/average.py densifies with zeros. One
forward a batch feeds both; top-k runs on the device, so the CSV needs
only [B, 2k] numbers from it.

One-deep pipeline: batch n is launched and its outputs' copies to the
host queued before batch n-1 is written out, so the host formats and
compresses while the device computes; the reader parses ahead in its own
thread.

Data-parallel (--num_devices, or torchrun; the JAX package's shard_map
serving wrapper): every rank reads the whole stream and serves its dim-0
block of each padded global batch; the outputs are gathered in rank
order and rank 0 alone writes the CSV and the dumps, in the one-card
run's order.
"""

from __future__ import annotations

import gzip
import logging
import os
import time

import numpy as np
import torch

from yt8m_tpu_torch.config import InferenceConfig
from yt8m_tpu_torch.convert import load_model
from yt8m_tpu_torch.data.pipeline import (  # noqa: F401  (format_lines)
    format_lines,
    format_lines_text,
    make_batch_iterator,
    reader_kind,
)
from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.kernels.ops import topk as serving_topk
from yt8m_tpu_torch.kernels.topk import TOPK_NEG
from yt8m_tpu_torch.parallel import distributed
from yt8m_tpu_torch.parallel.mesh import shard_rows
from yt8m_tpu_torch.train.loop import reader_config_from

log = logging.getLogger("yt8m_tpu_torch.infer")


def make_serving_step(model, csv_top_k: int = 0, dump_top_k: int = 0,
                      dense: bool = False):
    """(features, num_frames, generator) -> {"csv": (values, indices),
    "sparse": (values, indices), "dense": predictions}, each present when
    asked for, from one forward on the model's device."""

    @torch.inference_mode()
    def step(features, num_frames, generator=None):
        preds = model(features, num_frames, generator=generator)[
            "predictions"]
        out = {}
        for key, k in (("csv", csv_top_k), ("sparse", dump_top_k)):
            if k > 0:
                out[key] = serving_topk(preds, min(k, preds.shape[-1]))
        if dense:
            out["dense"] = preds.to(torch.float32)
        return out

    return step


def make_topk_predict_step(model, top_k: int = 20):
    """(features, num_frames, generator) -> (values [B,k] f32, indices
    [B,k] int32), both on the model's device."""
    step = make_serving_step(model, csv_top_k=top_k)
    return lambda features, num_frames, generator=None: step(
        features, num_frames, generator)["csv"]


def count_nonfinite(arr) -> int:
    """Diverged-checkpoint tripwire: NaN/inf values, or the top-k
    sanitisation value (exact_topk reports TOPK_NEG for NaN and -inf)."""
    return int(np.sum(~(np.isfinite(arr) & (arr > TOPK_NEG))))


class _HostCopy:
    """Outputs copied to the host behind the device's queue: `wait`
    returns them as numpy once the copies have landed."""

    def __init__(self, outs: dict, device):
        self.outs = {k: tuple(t.to("cpu", non_blocking=True) for t in v)
                     if isinstance(v, tuple)
                     else v.to("cpu", non_blocking=True)
                     for k, v in outs.items()}
        self.event = None
        if device.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        return {k: tuple(t.numpy() for t in v) if isinstance(v, tuple)
                else v.numpy() for k, v in self.outs.items()}


def inference(cfg: InferenceConfig, model=None) -> dict:
    """The CSV (--output_file) and/or the probability dumps
    (--output_probabilities_dir) for every video matched by
    cfg.input_data_pattern.

    Runs on cfg.device ("cuda" unless the caller asks for "cpu"); serves
    `model` if given, else the ensemble of --ensemble_train_dirs, else
    the model of cfg.train_dir: the checkpoint at --checkpoint_step,
    else the latest (else a flat model.pt), its EMA parameters with
    --use_ema_weights. Returns num_videos, videos_per_sec,
    nonfinite_predictions, device and reader (the reader that ran).
    """
    device = distributed.rank_device(resolve_device(cfg.device))
    world, rank = distributed.process_count(), distributed.process_index()
    distributed.per_host_batch(cfg.batch_size)  # divides over the ranks
    if model is None and cfg.ensemble_train_dirs:
        from yt8m_tpu_torch.infer.ensemble_serve import build_ensemble

        model = build_ensemble(cfg, device, step=cfg.checkpoint_step)
    elif model is None:
        model = load_model(cfg.train_dir, cfg.model,
                           cfg.resolved_hparams(), device,
                           checkpoint_step=cfg.checkpoint_step,
                           use_ema_weights=cfg.use_ema_weights)
    dump_dir = cfg.output_probabilities_dir
    dump_topk = int(cfg.output_probabilities_topk or 0) if dump_dir else 0
    if dump_dir:
        if rank == 0:
            os.makedirs(dump_dir, exist_ok=True)
        try:
            dump_dtype = np.dtype(cfg.output_probabilities_dtype)
        except TypeError:
            raise SystemExit(
                f"--output_probabilities_dtype="
                f"{cfg.output_probabilities_dtype!r} is not a valid numpy "
                f"dtype (try float32 or float16)")
    step = make_serving_step(
        model, csv_top_k=cfg.top_k if cfg.output_file else 0,
        dump_top_k=dump_topk, dense=bool(dump_dir) and dump_topk <= 0)
    generator = torch.Generator(device=device).manual_seed(cfg.seed)
    it = make_batch_iterator(
        cfg.input_data_pattern, reader_config_from(cfg),
        batch_size=cfg.batch_size, num_readers=cfg.num_readers,
        reader_processes=cfg.reader_processes, shuffle=False, num_epochs=1,
        pad_final_batch=True)
    n_videos, n_chunks, nonfinite = 0, 0, 0

    def drain(pending, f):
        nonlocal n_chunks, nonfinite
        copy, ids_all, keep = pending
        outs = copy.wait()
        ids = [v for v, m in zip(ids_all, keep) if m]
        if "csv" in outs:
            values, indices = (a[keep] for a in outs["csv"])
            nonfinite += count_nonfinite(values)
            f.write(format_lines_text(ids, values, indices))
        if not dump_dir:
            return
        path = os.path.join(dump_dir, f"predictions-{n_chunks:05d}.npz")
        ids_arr = np.asarray([i.decode() if isinstance(i, bytes) else str(i)
                              for i in ids])
        if "dense" in outs:
            dense = outs["dense"][keep]
            nonfinite += count_nonfinite(dense)
            np.savez_compressed(path, ids=ids_arr,
                                predictions=dense.astype(dump_dtype))
        else:
            values, indices = (a[keep] for a in outs["sparse"])
            nonfinite += count_nonfinite(values)
            np.savez_compressed(path, ids=ids_arr,
                                values=values.astype(dump_dtype),
                                indices=indices.astype(np.int32),
                                num_classes=np.int32(cfg.num_classes))
        n_chunks += 1

    out_file = cfg.output_file
    opener = gzip.open if out_file.endswith(".gz") else open
    t0 = time.perf_counter()
    f = opener(out_file, "wt") if out_file and rank == 0 else None
    try:
        if f:
            f.write("VideoId,LabelConfidencePairs\n")
        pending = None
        for batch in it:
            keep = batch["batch_mask"] > 0
            rows = shard_rows(len(keep), rank, world)
            features = torch.from_numpy(batch["features"][rows]).to(device)
            num_frames = torch.from_numpy(batch["num_frames"][rows]).to(
                device)
            outs = step(features, num_frames, generator)
            if world > 1:
                outs = {k: tuple(map(distributed.all_gather_rows, v))
                        if isinstance(v, tuple)
                        else distributed.all_gather_rows(v)
                        for k, v in outs.items()}
            if rank != 0:
                continue
            copy = _HostCopy(outs, device)
            if pending is not None:
                drain(pending, f)
            pending = (copy, batch["id"], keep)
            n_videos += int(keep.sum())
        if pending is not None:
            drain(pending, f)
    finally:
        if f:
            f.close()
    dt = max(time.perf_counter() - t0, 1e-9)
    stats = {
        "num_videos": n_videos,
        "videos_per_sec": n_videos / dt,
        "nonfinite_predictions": nonfinite,
        "device": str(device),
        "reader": reader_kind(it),
    }
    if nonfinite:
        log.warning(
            "%d non-finite prediction values written (CSV and/or "
            "probability dumps) — the checkpoint has likely diverged and "
            "the output is not meaningful", nonfinite)
    log.info("inference done: %d videos at %.1f videos/sec (%s reader) -> "
             "%s", n_videos, stats["videos_per_sec"], stats["reader"],
             out_file or dump_dir)
    return stats
