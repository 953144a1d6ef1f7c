"""Weights between the JAX package and the port, and the port's checkpoint.

The JAX package's variables are nested dicts, `{"params": {...},
"batch_stats": {...}}`. The port's modules use the same leaf names
(`cluster_kernel`, `input_bn_mean`, `hidden_bn/scale`,
`video_classifier/gates_kernel`, ...) and the same [in, out] layout of
every kernel, so the conversion only flattens the two trees into one
`state_dict` with "." for "/": no tensor is transposed. Gate columns
stay class-major, c*(M+1)+m. The layouts that are not [in, out]
matrices are kept as the JAX package holds them too: FrameCnnModel's
`conv{i}.kernel` is flax's nn.Conv kernel [k, in, out] (the model
permutes it to torch's [out, in, k] at use), the layer-norm LSTM's
`ln_scale` and `ln_bias` are [5, H] (and it has no `bias`), NetVLAD's
`cluster_weights2` is [1, D, K], NetFV's `cluster_centers` and
`covar_weights` are [K, D], and the chains' `chain_proj{i}` and
`pred_proj{i}` are [vocab, hidden]. `variables_from_model` goes back: the
port's parameters and buffers to the JAX package's `params` and
`batch_stats` trees of numpy arrays.

A run of the port is a directory holding `model_flags.json` (the JAX
trainer's format, so either package's recording rebuilds the model) and
the trainer's step directories (train/checkpoint.py), or a flat
`model.pt` (the `state_dict`, saved with `torch.save`) as
`save_checkpoint` writes it. An orbax checkpoint of the JAX package is
read with orbax outside the port and converted with
`state_dict_from_jax`.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train.checkpoint import MODEL_FILE, restore_model

FLAGS_FILE = "model_flags.json"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(value, Mapping):
            out.update(_flatten(value, name))
        else:
            out[name] = np.asarray(value)
    return out


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables (numpy leaves) -> the port's state_dict."""
    flat = _flatten(variables.get("params", {}))
    for name, value in _flatten(variables.get("batch_stats", {})).items():
        if name in flat:
            raise ValueError(f"{name!r} is both a param and a batch stat")
        flat[name] = value
    return {
        name: torch.from_numpy(np.array(value, dtype=np.float32))
        for name, value in flat.items()
    }


def _nest(flat: Mapping[str, np.ndarray]) -> dict:
    out: dict = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return out


def variables_from_model(model: torch.nn.Module) -> dict:
    """The port's model -> JAX-shaped variables {"params", "batch_stats"}
    with numpy f32 leaves (parameters, then buffers)."""
    def host(t):
        return t.detach().to("cpu", torch.float32).numpy()

    return {
        "params": _nest({n: host(p) for n, p in model.named_parameters()}),
        "batch_stats": _nest({n: host(b) for n, b in model.named_buffers()}),
    }


def save_checkpoint(train_dir: str, model, model_name: str,
                    hparams: ModelHParams, **config) -> None:
    """Write model_flags.json and model.pt into train_dir.

    `config` holds the recorded reader fields (feature_names,
    feature_sizes, frame_features, num_classes, max_frames, ...).
    """
    os.makedirs(train_dir, exist_ok=True)
    payload = {"model": model_name, **config,
               "hparams": dataclasses.asdict(hparams)}
    with open(os.path.join(train_dir, FLAGS_FILE), "w") as f:
        json.dump(payload, f, indent=1)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(train_dir, MODEL_FILE))


def load_model(train_dir: str, model_name: str, hparams: ModelHParams,
               device, checkpoint_step: Optional[int] = None,
               use_ema_weights: bool = False) -> torch.nn.Module:
    """Build `model_name` from hparams, load the weights of train_dir (the
    step directory `checkpoint_step`, else the latest, else a flat
    model.pt; the EMA parameters with `use_ema_weights`), move it to
    `device` and put it in eval mode. The step read is
    `model.checkpoint_step` (None for a flat model.pt)."""
    model = get_model(model_name, hparams)
    model.checkpoint_step = restore_model(model, train_dir, checkpoint_step,
                                          use_ema_weights)
    return model.to(device).eval()
