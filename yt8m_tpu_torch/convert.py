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
read with orbax outside the port (scripts/convert_jax_checkpoint.py) and
converted here: `write_step_from_jax` turns a JAX trainer's step (its
`params`, `batch_stats`, `ema_params` and `opt_state`, numpy leaves)
into a step directory of the port's trainer. Adam's state (optax's `mu`,
`nu` and `count`) becomes torch.optim.Adam's `exp_avg`, `exp_avg_sq` and
`step` (or, with a bf16 `mu`, the port's AdamBf16Mu state), so the run
resumes in the port's trainer; any other optimizer's state is not
converted, and the step then holds no optimizer.pt (the trainer refuses
to resume from it; eval and inference serve it).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train.checkpoint import (
    EMA_FILE,
    MODEL_FILE,
    OPTIMIZER_FILE,
    restore_model,
    write_step,
)

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


def _tensor(value) -> torch.Tensor:
    """A numpy leaf as a torch tensor of its float dtype (bf16 leaves,
    ml_dtypes' bfloat16, through f32, which holds them exactly)."""
    a = np.asarray(value)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, dtype=np.float32))


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


def _find_adam(tree):
    """optax's ScaleByAdamState ({"count", "mu", "nu"}) in an opt_state
    as orbax restores it without a target (lists and dicts), or None."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for node in tree:
            found = _find_adam(node)
            if found is not None:
                return found
    return None


def _adam_state(model, adam: Mapping) -> tuple:
    """(optimizer state_dict, adam_mu_dtype) of the port's Adam over
    `model`'s trainable parameters, from optax's Adam state."""
    from yt8m_tpu_torch.train.state import TrainState

    mu, nu = _flatten(adam["mu"]), _flatten(adam["nu"])
    mu_dtype = ("bfloat16" if str(np.asarray(next(iter(mu.values()))).dtype)
                == "bfloat16" else "float32")
    count = int(np.asarray(adam["count"]))
    optimizer = TrainState(model, optimizer="AdamOptimizer",
                           adam_mu_dtype=mu_dtype).optimizer
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    if set(names) != set(mu) or set(names) != set(nu):
        raise ValueError("Adam's moments do not name the model's parameters: "
                         f"{sorted(set(names) ^ set(mu))}")
    state = {}
    for i, name in enumerate(names):
        if mu_dtype == "bfloat16":  # train/optimizers.py :: AdamBf16Mu
            state[i] = {"step": torch.tensor(count, dtype=torch.int64),
                        "mu": _tensor(mu[name]).to(torch.bfloat16),
                        "nu": _tensor(nu[name])}
        else:  # torch.optim.Adam: optax's count is its step
            state[i] = {"step": torch.tensor(float(count)),
                        "exp_avg": _tensor(mu[name]),
                        "exp_avg_sq": _tensor(nu[name])}
    saved = optimizer.state_dict()
    saved["state"] = state
    optimizer.load_state_dict(saved)  # checks every shape
    return optimizer.state_dict(), mu_dtype


def write_step_from_jax(train_dir: str, restored: Mapping, flags: Mapping,
                        step: Optional[int] = None) -> dict:
    """Write a JAX trainer's step as the port's step directory.

    `restored` is the step as orbax restores it (numpy leaves): `params`,
    `batch_stats`, `opt_state`, `ema_params` (None without an EMA) and
    `step`; `flags` is the JAX run's model_flags.json, written into
    train_dir beside train_dir/<step>/ (model.pt, ema.pt with an EMA,
    optimizer.pt for Adam, step.json last). Returns what was written:
    {"step", "path", "optimizer" ("AdamOptimizer" or None),
    "adam_mu_dtype", "ema"}.
    """
    fields = {f.name for f in dataclasses.fields(ModelHParams)}
    hparams = ModelHParams(**{k: v for k, v in flags["hparams"].items()
                              if k in fields})
    model = get_model(flags["model"], hparams)
    model.load_state_dict(state_dict_from_jax(restored))
    step = int(np.asarray(restored["step"])) if step is None else int(step)
    files = {MODEL_FILE: {k: v.detach().clone()
                          for k, v in model.state_dict().items()}}
    ema = restored.get("ema_params")
    if ema:
        params = dict(model.named_parameters())
        flat = {name: _tensor(value) for name, value in _flatten(ema).items()}
        if set(flat) != set(params):
            raise ValueError("ema_params do not name the model's parameters")
        files[EMA_FILE] = {n: flat[n].to(torch.float32) for n in params}
    adam = _find_adam(restored.get("opt_state"))
    mu_dtype = None
    if adam is not None:
        files[OPTIMIZER_FILE], mu_dtype = _adam_state(model, adam)
    os.makedirs(train_dir, exist_ok=True)
    with open(os.path.join(train_dir, FLAGS_FILE), "w") as f:
        json.dump(dict(flags), f, indent=1)
    path = write_step(os.path.abspath(train_dir), step, files)
    return {"step": step, "path": path,
            "optimizer": "AdamOptimizer" if adam is not None else None,
            "adam_mu_dtype": mu_dtype, "ema": EMA_FILE in files}


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
