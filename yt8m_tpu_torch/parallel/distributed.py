"""The process group of a multi-GPU run: one process a card (reference:
the JAX package's parallel/distributed.py, where every host runs the same
SPMD program).

torchrun's environment contract (torchrun --nproc_per_node=N -m
yt8m_tpu_torch.cli.train ...):

    RANK, WORLD_SIZE    this process's index and the number of processes
    LOCAL_RANK          its card on this host
    MASTER_ADDR, MASTER_PORT   the rendezvous of rank 0

`maybe_initialize` starts the group from it: NCCL on the card (each rank
on cuda:LOCAL_RANK), gloo on the CPU. Without it the CLIs start the ranks
themselves through `launch` (--num_devices=N): N spawned processes over a
store the caller picks, by default a file:// store in a new temporary
directory, so no port is ever chosen. The backend follows the ranks on
this host (LOCAL_WORLD_SIZE under torchrun, so hosts of 8 cards in a
group of 16 ranks run NCCL): where they outnumber its cards, NCCL
refuses two ranks on one card and the group is refused too, unless the
caller asks for gloo (launch(..., backend="gloo")), which shares the
cards round robin: for checks, not for speed.

A launched group has no wall-clock deadline unless the caller gives one
(the tests and the smoke script do): a training run, or an eval that
polls for checkpoints, runs as long as it runs.

A tensor-parallel run (--model_parallel=mp) arranges the ranks as the
JAX package's make_mesh arranges its devices: a (data, model) grid of
world // mp x mp, rank r at data index r // mp and model index r % mp
(`use_grid`). The mp ranks of one data index form its model group (they
hold the same rows and split the sharded variables' columns); the ranks
of one model index form its data group (they hold the same columns and
split the rows). Without model parallelism the data group is the world.

The collectives below (`all_reduce_`, `all_gather_rows`,
`reduce_scatter_rows`) run on the group's backend, over the world or the
group they are given, the last two on any dim; gloo carries card
tensors too (all_reduce, all_gather_into_tensor, reduce_scatter_tensor
and broadcast, read on the card with torch 2.11), through host memory.
Host-side decisions that every rank must take alike (whether any rank
still has data, whether a checkpoint is due) go through a second group
over gloo (the control group), which never waits for the card.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

log = logging.getLogger("yt8m_tpu_torch.distributed")

# The longest one collective waits for the other ranks (they wait at a
# barrier while rank 0 saves a checkpoint).
COLLECTIVE_TIMEOUT_S = 3600.0
# How long a rank that has sent its result may take to exit.
EXIT_GRACE_S = 60.0
LOG_FORMAT = "%(asctime)s %(name)s %(levelname)s: %(message)s"

_control = None
_local_rank = 0
# The (data, model) grid in use and its groups, by model_parallel.
_grid = None
_groups: dict = {}


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def per_host_batch(global_batch_size: int, parts: Optional[int] = None) -> int:
    """This rank's share of a global batch split in `parts` (default one
    a rank; a tensor-parallel run passes its data blocks)."""
    n = process_count() if parts is None else parts
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{n} processes")
    return global_batch_size // n


@dataclasses.dataclass(frozen=True)
class Grid:
    """The (data, model) grid: its shape and this rank's place in it."""
    data: int
    model: int
    data_index: int
    model_index: int


def grid_shape(world: int, model_parallel: int = 1) -> tuple:
    """(data, model): world ranks as make_mesh(world, model_parallel)
    arranges them, with its error where mp does not divide the world."""
    if model_parallel < 1:
        raise ValueError(f"--model_parallel={model_parallel}: at least 1")
    if world % model_parallel:
        raise ValueError(f"{world} devices not divisible by "
                         f"model_parallel={model_parallel}")
    return world // model_parallel, model_parallel


def use_grid(model_parallel: int = 1) -> Grid:
    """Arrange the ranks as a (data, model) grid and make it the one in
    use. Every rank calls it alike (the first use of an mp > 1 makes the
    groups, which is collective); it raises where mp does not divide the
    world."""
    global _grid
    world, rank = process_count(), process_index()
    dp, mp = grid_shape(world, model_parallel)
    if mp > 1 and mp not in _groups:
        model = [dist.new_group(list(range(i * mp, (i + 1) * mp)))
                 for i in range(dp)]
        data = [dist.new_group(list(range(j, world, mp))) for j in range(mp)]
        _groups[mp] = (data[rank % mp], model[rank // mp])
    _grid = Grid(dp, mp, rank // mp, rank % mp)
    return _grid


def grid() -> Grid:
    """The grid in use; every rank a data block where none was chosen."""
    if _grid is None:
        return Grid(process_count(), 1, process_index(), 0)
    return _grid


def data_group():
    """This rank's data group (None: the world)."""
    g = grid()
    return _groups[g.model][0] if g.model > 1 else None


def model_group():
    """This rank's model group (None where there is no model axis)."""
    g = grid()
    return _groups[g.model][1] if g.model > 1 else None


def group_size(group=None) -> int:
    """The number of ranks in `group` (None: the world)."""
    if not is_initialized():
        return 1
    return dist.get_world_size(group)


def backend_for(device_type: str, local_ranks: int,
                backend: Optional[str] = None) -> str:
    """The group's backend: gloo on the CPU; on the card NCCL, where each
    of the `local_ranks` ranks on this host has a card of its own, or the
    caller's `backend`. More ranks than cards without one are refused."""
    if device_type != "cuda":
        return backend or "gloo"
    if backend:
        return backend
    cards = torch.cuda.device_count()
    if local_ranks > cards:
        raise ValueError(
            f"{local_ranks} ranks on a host with {cards} card(s): NCCL "
            f"refuses two ranks on one card; run at most {cards}, or ask "
            f"for backend='gloo' (through host memory, for checks)")
    return "nccl"


def world_size_for(num_devices: Optional[int], device: str) -> int:
    """--num_devices as a number of ranks: None is every visible card on
    the card, one rank on the CPU."""
    if num_devices is not None:
        if num_devices < 1:
            raise ValueError(f"--num_devices={num_devices}: at least 1")
        return int(num_devices)
    if torch.device(device or "cuda").type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def rank_device(device) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK (round robin over the visible
    cards) in a group on the card, the CPU as asked otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and is_initialized() and dev.index is None:
        return torch.device("cuda", _local_rank % torch.cuda.device_count())
    return dev


def _init(backend: str, init_method: str, world: int, rank: int,
          local_rank: int) -> None:
    global _control, _local_rank, _grid
    _local_rank = local_rank
    _grid = None
    _groups.clear()
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    _control = (dist.group.WORLD if backend == "gloo"
                else dist.new_group(backend="gloo"))
    if rank:
        # Only rank 0 logs the run; the others say what goes wrong.
        logging.getLogger().setLevel(logging.WARNING)


def maybe_initialize(device="cuda") -> bool:
    """Start the group from torchrun's environment when it is there (a
    no-op without it, and when the group is already up); True when this
    process is one rank of a group."""
    if is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev = torch.device("cuda" if device is None else device)
    backend = backend_for(dev.type, local_ranks)
    _init(backend, "env://", world, rank, local_rank)
    log.info("process group up: rank %d/%d (%s)", rank, world, backend)
    return True


def _worker(rank: int, world: int, init_method: str, backend: str,
            fn: Callable, args: Sequence, results) -> None:
    """A spawned rank: join the group, run fn(*args), send back its
    pickled result (or the traceback), leave the group."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    logging.basicConfig(level=logging.INFO, format=LOG_FORMAT)
    try:
        _init(backend, init_method, world, rank, rank)
        out = fn(*args)
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, args: Sequence = (), nprocs: int = 1,
           device="cuda", init_method: Optional[str] = None,
           backend: Optional[str] = None,
           timeout_s: Optional[float] = None) -> List:
    """Run fn(*args) on `nprocs` spawned ranks of one process group and
    return their results, rank by rank.

    `fn` and `args` must pickle (fn a module-level function: the child
    imports its module). The store is `init_method` (a file:// path the
    caller owns, or tcp://host:port), else a file:// store in a new
    temporary directory, removed afterwards. `backend` is backend_for's
    (every rank runs on this host). A rank that raises, or dies, fails the
    launch with its traceback and the others are stopped; so is the whole
    group when it has not finished within `timeout_s`, where one is given
    (None: no deadline).
    """
    dev = torch.device("cuda" if device is None else device)
    backend = backend_for(dev.type, nprocs, backend)
    tmp = None
    if init_method is None:
        tmp = tempfile.mkdtemp(prefix="yt8m_group_")
        init_method = "file://" + os.path.join(tmp, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(
        rank, nprocs, init_method, backend, fn, tuple(args), results))
        for rank in range(nprocs)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out, errors = {}, {}
    try:
        for p in procs:
            p.start()
        while len(out) + len(errors) < nprocs and not errors:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and r not in out and r not in errors]
                if dead:
                    # A rank that died without a word (killed, or its
                    # interpreter failed to start).
                    errors.update({r: f"exit code {procs[r].exitcode}"
                                   for r in dead})
                elif deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{nprocs} ranks of {getattr(fn, '__name__', fn)} "
                        f"did not finish within {timeout_s:.0f} s")
                continue
            if ok:
                out[rank] = pickle.loads(payload)
            else:
                errors[rank] = payload
        if errors:
            rank = min(errors)
            raise RuntimeError(f"rank {rank} of {nprocs} failed:\n"
                               f"{errors[rank]}")
        for p in procs:
            # Each rank has sent its result: what is left is its exit.
            p.join(timeout=EXIT_GRACE_S if deadline is None
                   else max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(nprocs)]


def run_on_ranks(fn: Callable, args: Sequence, num_devices: Optional[int],
                 device, **launch_options):
    """fn(*args) on every rank of the run, and rank 0's result: in this
    process where torchrun started it as one rank, or where the run is
    one rank (--num_devices=1, or unset with one card or on the CPU);
    else on `launch`'s spawned ranks, with `launch_options` (init_method,
    backend, timeout_s; by default no deadline)."""
    if maybe_initialize(device):
        return fn(*args)
    world = world_size_for(num_devices, device)
    if world == 1:
        return fn(*args)
    return launch(fn, args, world, device, **launch_options)[0]


def agreed(decide: Callable):
    """decide() as rank 0 finds it, on every rank (host-side decisions
    that read the file system)."""
    if process_count() == 1:
        return decide()
    return broadcast_object(decide() if process_index() == 0 else None)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


# The names of the tensor collectives in this torch (the *_single names
# are the later ones; the older still exist and warn there).
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None):
    """In-place all-reduce of `t` over `group` (None: the world); `t`."""
    if group_size(group) > 1:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_rows(t: torch.Tensor, out: Optional[torch.Tensor] = None,
                    group=None, dim: int = 0):
    """The ranks' `t` of `group` (None: the world) concatenated on `dim`
    in rank order (into `out`, contiguous, when given)."""
    n = group_size(group)
    dim = dim % max(t.dim(), 1)
    t = t.detach().contiguous()
    if dim == 0:
        shape = (t.shape[0] * n,) + tuple(t.shape[1:])
        if out is None:
            out = torch.empty(shape, dtype=t.dtype, device=t.device)
        if n == 1:
            return out.copy_(t)
        _all_gather(out, t, group=group)
        return out
    parts = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]),
                        dtype=t.dtype, device=t.device)
    if n == 1:
        parts.copy_(t)
    else:
        _all_gather(parts, t, group=group)
    whole = parts.view((n,) + tuple(t.shape)).movedim(0, dim).flatten(
        dim, dim + 1)
    return whole if out is None else out.copy_(whole)


def reduce_scatter_rows(t: torch.Tensor, group=None,
                        dim: int = 0) -> torch.Tensor:
    """This rank's block on `dim` of the sum of `t` over `group` (None:
    the world)."""
    n = group_size(group)
    dim = dim % max(t.dim(), 1)
    src = t.detach().movedim(dim, 0).contiguous()
    if n == 1:
        return src.movedim(0, dim).clone()
    shape = (src.shape[0] // n,) + tuple(src.shape[1:])
    out = torch.empty(shape, dtype=t.dtype, device=t.device)
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, dim).contiguous()


def broadcast_(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """`t` of rank `src` (its rank in the world), in place on every rank
    of `group` (None: the world); `t`."""
    if group_size(group) > 1:
        dist.broadcast(t, src=src, group=group)
    return t


def host_all_reduce(values: Sequence[float], op=dist.ReduceOp.SUM) -> list:
    """Numbers reduced over the ranks through the control group (float64;
    returns them as floats)."""
    t = torch.tensor(list(values), dtype=torch.float64)
    dist.all_reduce(t, op=op, group=_control)
    return t.tolist()


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src`, on every rank (the control group)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_control)
    return box[0]


def barrier() -> None:
    """Every rank waits for the others (the control group)."""
    dist.barrier(group=_control)
