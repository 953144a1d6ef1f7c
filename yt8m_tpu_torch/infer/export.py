"""Serving export (reference: export_model.py :: ModelExporter; the JAX
package's infer/export.py).

`export_model` traces the serving function `(features, num_frames) ->
(values, indices)` (the model's eval forward, then the top-k) with
`torch.export.export` and writes `program.pt2` (`torch.export.save`: the
graph, the weights, the BatchNorm statistics and the serving constants)
and `meta.json` (the JAX export's keys, plus `device`). `load_serving`
reads them back into a callable.

The kernels run in the program as the operators of kernels/ops.py, whose
fake implementations trace under a symbolic batch: a program exported
with `batch_size=0` keeps its kernels at any batch (the JAX package's
dynamic-batch export drops its Pallas kernels for the XLA graph). The
frame samplers draw through `ops.frame_uniform` with the baked seed 0,
so the program draws the same frames on every call, those of the eager
model called with `torch.Generator(device).manual_seed(0)` (the JAX
export's `PRNGKey(0)`).

The serving constants (models/serving.py: the pitched, bf16, int8 and
layout copies of the weights) are made from the weights anew for each
export and carried by the program as lifted constants, so an export
never carries the constants of earlier weights; the program holds the
weights and those copies beside them.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

from yt8m_tpu_torch.device import resolve_device
from yt8m_tpu_torch.kernels import ops
from yt8m_tpu_torch.models.registry import is_frame_level_model
from yt8m_tpu_torch.models.serving import ServingModule

PROGRAM = "program.pt2"
META = "meta.json"
SAMPLE_SEED = 0  # the baked frame-sampling seed (JAX: PRNGKey(0))


class ServingFunction(nn.Module):
    """(features, num_frames) -> (values [B, k] f32, indices [B, k]
    int32): the model's eval forward with the frame draw of SAMPLE_SEED,
    then the serving top-k."""

    def __init__(self, model: nn.Module, top_k: int):
        super().__init__()
        self.model = model
        self.top_k = top_k

    def forward(self, features, num_frames):
        preds = self.model(features, num_frames,
                           generator=SAMPLE_SEED)["predictions"]
        return ops.topk(preds, self.top_k)


def _drop_serving_constants(model: nn.Module) -> None:
    for mod in model.modules():
        if isinstance(mod, ServingModule):
            mod._serving = None


def _inputs(hparams, frame_level: bool, b: int, device):
    if frame_level:
        features = torch.zeros((b, hparams.max_frames, hparams.feature_dim),
                               dtype=torch.uint8, device=device)
    else:
        features = torch.zeros((b, hparams.feature_dim), dtype=torch.float32,
                               device=device)
    return features, torch.ones((b,), dtype=torch.int32, device=device)


def export_model(export_dir: str, model_name: str, hparams, model: nn.Module,
                 batch_size: int = 0, top_k: int = 20,
                 ema: bool = False) -> str:
    """Write {program.pt2, meta.json} under export_dir and return it.

    `model` is exported on its own device, in eval mode. batch_size 0
    exports a symbolic batch dimension (one program serves any batch); a
    positive batch_size locks it. `ema` records that the model holds the
    EMA weights (the caller chooses them); meta.json also carries the
    full hparams and the device.
    """
    os.makedirs(export_dir, exist_ok=True)
    device = next(model.parameters()).device
    frame_level = is_frame_level_model(model_name)
    k = min(top_k, hparams.vocab_size)
    fn = ServingFunction(model.eval(), k)
    # Serving constants from the weights as they are now, made eagerly so
    # that the program lifts them as constants.
    _drop_serving_constants(model)
    b = batch_size if batch_size else 2
    args = _inputs(hparams, frame_level, b, device)
    try:
        with torch.no_grad():
            fn(*args)
            dynamic = None
            if not batch_size:
                batch = torch.export.Dim("batch", min=1)
                dynamic = {"features": {0: batch}, "num_frames": {0: batch}}
            program = torch.export.export(fn, args, dynamic_shapes=dynamic)
    finally:
        # Tracing may have cached constants made of fake tensors.
        _drop_serving_constants(model)
    torch.export.save(program, os.path.join(export_dir, PROGRAM))
    with open(os.path.join(export_dir, META), "w") as f:
        json.dump({
            "model": model_name,
            "top_k": k,
            "frame_level": frame_level,
            "batch_size": batch_size,  # 0: any batch size serves
            "max_frames": hparams.max_frames,
            "feature_dim": hparams.feature_dim,
            "vocab_size": hparams.vocab_size,
            "ema": bool(ema),
            "hparams": dataclasses.asdict(hparams),
            "device": str(device),
        }, f)
    return export_dir


def load_serving(export_dir: str, device="cuda"):
    """(serve, meta): `serve(features, num_frames)` takes tensors or numpy
    arrays and returns (values, indices) tensors on `device`, the card
    unless the caller asks for the CPU (with TF32 off, as every entry
    point of the port: a convolution in the program computes in f32)."""
    with open(os.path.join(export_dir, META)) as f:
        meta = json.load(f)
    device = resolve_device(device)
    program = torch.export.load(os.path.join(export_dir, PROGRAM))
    program = move_to_device_pass(program, device)
    module = program.module()
    feature_dtype = torch.uint8 if meta["frame_level"] else torch.float32

    def serve(features, num_frames):
        features = torch.as_tensor(np.asarray(features) if not isinstance(
            features, torch.Tensor) else features).to(device, feature_dtype)
        num_frames = torch.as_tensor(np.asarray(num_frames) if not isinstance(
            num_frames, torch.Tensor) else num_frames).to(device, torch.int32)
        with torch.no_grad():
            return module(features, num_frames)

    return serve, meta
