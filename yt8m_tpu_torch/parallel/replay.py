"""Replay given global batches through the data-parallel train step, on
every rank of a process group: the harness that holds N ranks against one
device or another implementation (the CPU tests run it on gloo ranks
against the JAX package's manual step; chip_smoke.py runs it on ranks
that share one card against the one-device step).

    from yt8m_tpu_torch.parallel.distributed import launch
    from yt8m_tpu_torch.parallel.replay import replay_steps
    results = launch(replay_steps, (spec,), nprocs=2, device="cpu")

`spec` (plain data, so it pickles to spawned ranks):
    model, hparams      the registry name and ModelHParams fields
    weights | seed      a state_dict of arrays, or the seed of
                        reset_parameters' draw on the rank's device
    batches             global batches (numpy dicts); each rank steps on
                        its dim-0 block
    optimizer, fsdp_min_size, ema_decay, loss, loss_kw,
    regularization_penalty, aux_loss_weight, device
    train               TrainState's schedule and clip arguments
                        (base_learning_rate, global_batch_size, ...)
    state_ranks         the ranks that send their state back (default
                        every rank; the state of a wide model is large)
    state_file          where those ranks write it instead (a path with
                        "{rank}"; torch.save of float32 tensors): the
                        launcher's queue carries ~0.2 GB/s

Each rank returns {"losses", "label_losses" (global, per step),
"seconds" (host seconds: "setup", each step's, "state"), "state"
(the model's state_dict, whole, as float32 numpy, or the path it was
written to; None on the ranks outside state_ranks), "digest" (sha256 of the state's bytes), "ema"
(gathered, or None), "sharded" (the names of the sharded parameters),
"rank", "world"}.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def replay_steps(spec: dict) -> dict:
    from yt8m_tpu_torch.device import resolve_device
    from yt8m_tpu_torch.models import ModelHParams, get_model
    from yt8m_tpu_torch.parallel import distributed
    from yt8m_tpu_torch.parallel.mesh import DATA_AXIS, shard_batch
    from yt8m_tpu_torch.train import losses
    from yt8m_tpu_torch.train.state import ParallelTrainState
    from yt8m_tpu_torch.train.step import make_parallel_train_step

    t0 = time.perf_counter()
    world, rank = distributed.process_count(), distributed.process_index()
    device = distributed.rank_device(resolve_device(spec.get("device",
                                                             "cpu")))
    hp = ModelHParams(**spec["hparams"])
    with torch.device(device):
        model = get_model(spec["model"], hp.replace(bn_axis=DATA_AXIS)
                          if world > 1 else hp)
    if spec.get("weights") is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in spec["weights"].items()})
    else:
        model.reset_parameters(torch.Generator(device=device).manual_seed(
            spec["seed"]))
    state = ParallelTrainState(
        model, fsdp_min_size=spec.get("fsdp_min_size", 0),
        optimizer=spec.get("optimizer", "SgdOptimizer"),
        ema=spec.get("ema_decay", 0.0) > 0, **spec.get("train", {}))
    step = make_parallel_train_step(
        losses.get_loss(spec.get("loss", "CrossEntropyLoss"),
                        **spec.get("loss_kw", {})),
        regularization_penalty=spec.get("regularization_penalty", 1.0),
        aux_loss_weight=spec.get("aux_loss_weight", 0.5),
        ema_decay=spec.get("ema_decay", 0.0))
    out = {"losses": [], "label_losses": [], "rank": rank, "world": world,
           "sharded": sorted(state.shards),
           "seconds": {"setup": time.perf_counter() - t0, "steps": []}}
    for batch in spec["batches"]:
        t0 = time.perf_counter()
        local = shard_batch(batch, rank, world)
        state, metrics = step(state, {
            k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in local.items() if k != "id"})
        out["losses"].append(float(metrics["loss"]))
        out["label_losses"].append(float(metrics["label_loss"]))
        out["seconds"]["steps"].append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    ema = state.ema_state()
    host = {k: _host(v) for k, v in model.state_dict().items()}
    digest = hashlib.sha256()
    for value in host.values():
        digest.update(value.tobytes())
    out["digest"] = digest.hexdigest()
    out["state"] = None
    if rank in spec.get("state_ranks", range(world)):
        out["state"] = host
        if spec.get("state_file"):
            out["state"] = spec["state_file"].format(rank=rank)
            torch.save({k: torch.from_numpy(v) for k, v in host.items()},
                       out["state"])
    out["ema"] = None if ema is None else {k: _host(v)
                                           for k, v in ema.items()}
    out["seconds"]["state"] = time.perf_counter() - t0
    return out


def replay_all(specs) -> list:
    """replay_steps of each spec in turn, in one process group."""
    return [replay_steps(spec) for spec in specs]
