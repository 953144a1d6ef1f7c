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
    optimizer, fsdp_min_size, model_parallel, ema_decay, loss, loss_kw,
    regularization_penalty, aux_loss_weight, device
    uniforms            the frame sampling's global uniforms a step (each
                        data block takes its rows), or none
    checkpoint_dir      where the state is saved after the steps, as the
                        trainer saves it (the one-card format)
    train               TrainState's schedule and clip arguments
                        (base_learning_rate, global_batch_size, ...)
    state_ranks         the ranks that send their state back (default
                        every rank; the state of a wide model is large)
    state_file          where those ranks write it instead (a path with
                        "{rank}"; torch.save of float32 tensors): the
                        launcher's queue carries ~0.2 GB/s

With model_parallel = mp > 1 the ranks form the (data, model) grid of
parallel/distributed.py :: use_grid, each data block of mp ranks stepping
on the same rows (the JAX package's GSPMD step).

Each rank returns {"losses", "label_losses" (global, per step),
"seconds" (host seconds: "setup", each step's, "state"), "state"
(the model's state_dict, whole, as float32 numpy, or the path it was
written to; None on the ranks outside state_ranks), "digest" (sha256 of
the state's bytes), "ema" (gathered, or None), "sharded" (the names of
the FSDP parameters), "blocks" (the tensor-parallel ones), "held" (the
shapes this rank holds of each parameter: itself, its gradient, its
optimizer state, its EMA), "rank", "world"}.

`resave(spec)` restores spec["src"]'s latest step into a
ParallelTrainState (model, hparams, seed, optimizer, ema_decay,
fsdp_min_size, model_parallel, device as above) and saves it into
spec["dst"] at the same step: a checkpoint moved across grids.
"""

from __future__ import annotations

import hashlib
import time

import numpy as np
import torch


def _host(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _state(spec: dict):
    """The spec's ParallelTrainState on this rank, and its device."""
    from yt8m_tpu_torch.device import resolve_device
    from yt8m_tpu_torch.models import ModelHParams, get_model
    from yt8m_tpu_torch.parallel import distributed
    from yt8m_tpu_torch.parallel.mesh import DATA_AXIS
    from yt8m_tpu_torch.train.state import ParallelTrainState

    device = distributed.rank_device(resolve_device(spec.get("device",
                                                             "cpu")))
    mp = spec.get("model_parallel", 1)
    g = distributed.use_grid(mp)
    hp = ModelHParams(**spec["hparams"])
    with torch.device(device):
        model = get_model(spec["model"], hp.replace(bn_axis=DATA_AXIS)
                          if g.data > 1 else hp)
    if spec.get("weights") is not None:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in spec["weights"].items()})
    else:
        model.reset_parameters(torch.Generator(device=device).manual_seed(
            spec["seed"]))
    state = ParallelTrainState(
        model, fsdp_min_size=spec.get("fsdp_min_size", 0),
        model_parallel=mp, optimizer=spec.get("optimizer", "SgdOptimizer"),
        ema=spec.get("ema_decay", 0.0) > 0, **spec.get("train", {}))
    return state, device


def _held(state) -> dict:
    """{name: {"param", "grad", "optimizer" (each statistic's), "ema"}:
    the shapes this rank holds}."""
    opt = state.optimizer.state

    def shape(t):
        return None if t is None else tuple(t.shape)

    return {n: {"param": shape(p), "grad": shape(p.grad),
                "optimizer": [shape(v) for _, v in sorted(
                    opt.get(p, {}).items())
                    if isinstance(v, torch.Tensor) and v.dim()],
                "ema": None if state.ema is None else shape(state.ema[n])}
            for n, p in zip(state._names, state.stepped())}


def replay_steps(spec: dict) -> dict:
    from yt8m_tpu_torch.parallel import distributed
    from yt8m_tpu_torch.parallel.mesh import shard_batch
    from yt8m_tpu_torch.train import losses
    from yt8m_tpu_torch.train.checkpoint import CheckpointManager
    from yt8m_tpu_torch.train.step import make_parallel_train_step

    t0 = time.perf_counter()
    world, rank = distributed.process_count(), distributed.process_index()
    state, device = _state(spec)
    g = state.grid
    model = state.model
    step = make_parallel_train_step(
        losses.get_loss(spec.get("loss", "CrossEntropyLoss"),
                        **spec.get("loss_kw", {})),
        regularization_penalty=spec.get("regularization_penalty", 1.0),
        aux_loss_weight=spec.get("aux_loss_weight", 0.5),
        ema_decay=spec.get("ema_decay", 0.0))
    out = {"losses": [], "label_losses": [], "rank": rank, "world": world,
           "sharded": sorted(state.shards), "blocks": sorted(state.blocks),
           "seconds": {"setup": time.perf_counter() - t0, "steps": []}}
    uniforms = spec.get("uniforms") or [None] * len(spec["batches"])
    for batch, u in zip(spec["batches"], uniforms):
        t0 = time.perf_counter()
        local = shard_batch(batch, g.data_index, g.data)
        if u is not None:
            u = torch.from_numpy(shard_batch(
                {"batch_mask": batch["batch_mask"], "u": np.asarray(u)},
                g.data_index, g.data)["u"]).to(device)
        state, metrics = step(state, {
            k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in local.items() if k != "id"}, u=u)
        out["losses"].append(float(metrics["loss"]))
        out["label_losses"].append(float(metrics["label_loss"]))
        out["seconds"]["steps"].append(time.perf_counter() - t0)
    out["held"] = _held(state)
    t0 = time.perf_counter()
    if spec.get("checkpoint_dir"):
        CheckpointManager(spec["checkpoint_dir"]).force_save(
            len(spec["batches"]), state)
    ema = state.ema_state()
    host = {k: _host(v) for k, v in state.model_state().items()}
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


def resave(spec: dict) -> int:
    from yt8m_tpu_torch.train.checkpoint import CheckpointManager

    state, _ = _state(spec)
    CheckpointManager(spec["src"]).restore(state)
    CheckpointManager(spec["dst"]).force_save(state.step, state)
    return state.step


def replay_all(specs) -> list:
    """replay_steps (or resave, where a spec has "dst") of each spec in
    turn, in one process group."""
    return [resave(spec) if "dst" in spec else replay_steps(spec)
            for spec in specs]
