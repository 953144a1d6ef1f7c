"""The port's multi-GPU training (yt8m_tpu_torch/parallel,
train/state.py :: ParallelTrainState, train/step.py ::
make_parallel_train_step, models/norm.py's cross-replica moments) against
the JAX package's manual train step (train/step.py ::
_make_manual_train_step) on its virtual CPU mesh.

The port runs n gloo ranks spawned by parallel/distributed.py :: launch,
each on its dim-0 block of the same global batches, from the JAX model's
initial variables (convert.py carries them across); the JAX package runs
its manual step with bn_axis='data' on make_mesh(num_devices=n), as
tests/test_manual_train.py :: _run builds it, with its kernels off (its
own tests hold them equal to the plain paths); the port takes its kernel
paths (the fused NeXtVLAD core, the trainable LSTM), which run their
plain versions on the CPU. Three steps of SGD (trajectories: see _run's
comment on Adam), batch 16 with 3 padded rows. The fused VLAD core
(--netvlad_fused_train) rounds its operands to bf16 even at float32
compute, so it meets the JAX package's graph, and its kernel, only at
the bf16 level on one device already (tests/test_torch_netvlad_train.py);
its n ranks are held to the port's one-device step instead, which runs
the same arithmetic.

Tolerances (tests/test_manual_train.py :: _assert_trajectory_close):
losses rtol 2e-4; parameters, BatchNorm running statistics and the EMA
rtol 2e-4, atol 1e-5. Float32 sums in another order (the ranks' partial
sums, the cross-replica moments) are all that differ. The FSDP cases
shard exactly the variables that yt8m_tpu/parallel/mesh.py :: param_spec
shards. Every spawned group has a hard deadline that fails the test.
"""

import functools
import time

import jax
import numpy as np
import pytest
import torch

from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.parallel import mesh as jax_mesh
from yt8m_tpu.train import losses as jax_losses
from yt8m_tpu.train.state import init_train_state, make_optimizer
from yt8m_tpu.train.step import make_train_step as jax_make_train_step
from yt8m_tpu_torch.config import TrainConfig
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.models import ModelHParams, get_model, list_models
from yt8m_tpu_torch.models.netvlad import NetVladAggregation
from yt8m_tpu_torch.models.norm import BatchNorm, bn_moments, replica_moments
from yt8m_tpu_torch.parallel import distributed
from yt8m_tpu_torch.parallel.distributed import launch
from yt8m_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    param_spec,
    shard_batch,
    shard_rows,
)
from yt8m_tpu_torch.parallel.replay import replay_all
from yt8m_tpu_torch.train import losses as tlosses
from yt8m_tpu_torch.train.state import ParallelTrainState, TrainState
from yt8m_tpu_torch.train.step import make_train_step

C, D, F, B = 24, 16, 10, 16
N_STEPS = 3
LR = 0.05
RTOL, ATOL = 2e-4, 1e-5
DEADLINE_S = 240.0

NEXTVLAD = dict(nextvlad_groups=4, nextvlad_expansion=2,
                nextvlad_cluster_size=12, nextvlad_hidden_size=16,
                moe_num_mixtures=2)
VLAD = dict(netvlad_cluster_size=8, netvlad_hidden_size=16,
            moe_num_mixtures=2)
# name -> (model, shared hparams, the port's kernel flags, the JAX
# package's (off), run options)
CASES = {
    "nextvlad_fused": ("NeXtVladModel", NEXTVLAD,
                       dict(nextvlad_train_fused=True),
                       dict(nextvlad_train_fused=False), {}),
    "lstm_fused": ("LstmModel", dict(lstm_cells=16, lstm_layers=1,
                                     moe_num_mixtures=2),
                   dict(lstm_use_pallas=True), dict(lstm_use_pallas=False),
                   {}),
    "flagship_lstm": ("NetVladLstmModel", dict(VLAD, lstm_cells=16,
                                               lstm_layers=2),
                      dict(lstm_use_pallas=True),
                      dict(lstm_use_pallas=False), {}),
    "gated_netvlad_inline_bn": ("GatedNetVladModel", VLAD, {}, {}, {}),
    "chain_aux": ("ChainFrameModel", dict(chain_stages=2,
                                          chain_hidden_size=16,
                                          moe_num_mixtures=2), {}, {}, {}),
    "boost_distill": ("GatedNetVladModel", VLAD, {}, {},
                      dict(loss="MixedCrossEntropyDistillLoss",
                           loss_kw={"alpha": 0.5}, weights=True,
                           teacher=True)),
    "fsdp_ema": ("NeXtVladModel", NEXTVLAD, dict(nextvlad_train_fused=True),
                 dict(nextvlad_train_fused=False),
                 dict(fsdp_min_size=64, ema_decay=0.99)),
    "fsdp_adam": ("NeXtVladModel", NEXTVLAD, dict(nextvlad_train_fused=True),
                  dict(nextvlad_train_fused=False),
                  dict(fsdp_min_size=64, optimizer="AdamOptimizer")),
}
# Adafactor under FSDP: MoeModel over 128 video-level features into 64
# classes. The gates [128, 128] factor whole; each rank's block [64, 128]
# does not, and the JAX manual step keeps an unfactored second moment of
# the block, with the block's own RMS factors: the port must match that,
# not the one-device run.
ADAFACTOR = ("MoeModel", dict(moe_num_mixtures=1), {}, {},
             dict(fsdp_min_size=1000, optimizer="AdafactorOptimizer",
                  video=True))
# The fused VLAD core, against the port's one-device step.
VLAD_CORE = {
    "gated_vlad_core": ("GatedNetVladModel", VLAD,
                        dict(netvlad_fused_train=True), None, {}),
    "flagship_vlad_core": ("NetVladLstmModel", dict(VLAD, lstm_cells=16,
                                                    lstm_layers=2),
                           dict(netvlad_fused_train=True,
                                lstm_use_pallas=True), None,
                           dict(fsdp_min_size=64)),
}
AT_2 = list(CASES)
AT_4 = ["gated_netvlad_inline_bn", "fsdp_ema"]


def _batches(video=False, weights=False, teacher=False, c=C, d=D):
    out = []
    for i in range(N_STEPS):
        rng = np.random.default_rng(100 + i)
        mask = np.ones((B,), np.float32)
        mask[-3:] = 0.0
        b = {
            "features": (rng.normal(size=(B, d)).astype(np.float32) if video
                         else rng.integers(0, 256, size=(B, F, d),
                                           dtype=np.uint8)),
            "labels": (rng.random((B, c)) < 0.15).astype(np.float32),
            "num_frames": (np.ones((B,), np.int32) if video else
                           rng.integers(1, F + 1, size=(B,)).astype(np.int32)),
            "batch_mask": mask,
        }
        if weights:
            b["example_weights"] = rng.uniform(0.5, 2.0, (B,)).astype(
                np.float32)
        if teacher:
            b["teacher"] = rng.uniform(0.0, 1.0, (B, c)).astype(np.float32)
        out.append(b)
    return out


def _case(name):
    model, shared, port_kw, jax_kw, opts = (
        ADAFACTOR if name == "adafactor"
        else VLAD_CORE.get(name) or CASES[name])
    c, d = (64, 128) if name == "adafactor" else (C, D)
    base = dict(vocab_size=c, feature_dim=d, max_frames=F,
                compute_dtype="float32", **shared)
    batches = _batches(opts.get("video", False), opts.get("weights", False),
                       opts.get("teacher", False), c, d)
    return model, base, port_kw, jax_kw, opts, batches


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The JAX package's initial state of a case (as test_manual_train.py
    :: _run makes it), and its hparams."""
    model, base, _, jax_kw, opts, batches = _case(name)
    hp = JaxHParams(**base, **(jax_kw or {}))
    tx = make_optimizer(optimizer=opts.get("optimizer", "SgdOptimizer"),
                        global_batch_size=B, base_learning_rate=LR,
                        clip_gradient_norm=1.0)
    return init_train_state(jax_get_model(model, hp), jax.random.PRNGKey(0),
                            batches[0], tx,
                            frame_level=not opts.get("video", False),
                            ema=opts.get("ema_decay", 0.0) > 0), hp


def _jax_state(name, n):
    """The case's JAX state on make_mesh(n), placed by its policy (as the
    JAX Trainer and test_manual_train.py :: _run place it)."""
    mesh = jax_mesh.make_mesh(n)
    state, _ = _jax_init(name)
    fsdp = _case(name)[4].get("fsdp_min_size", 0)
    shardings = jax.tree_util.tree_map(lambda _: jax_mesh.replicated(mesh),
                                       state)
    param_sh = jax_mesh.tree_param_shardings(state.params, mesh,
                                             fsdp_min_size=fsdp)
    shardings = shardings.replace(params=param_sh)
    if fsdp:
        shardings = shardings.replace(opt_state=jax_mesh.tree_param_shardings(
            state.opt_state, mesh, fsdp_min_size=fsdp))
        if state.ema_params is not None:
            shardings = shardings.replace(ema_params=param_sh)
    return mesh, state, shardings


def _flat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out[".".join(str(getattr(k, "key", k)) for k in path)] = (
            np.asarray(leaf))
    return out


def _weights(name):
    """The JAX model's initial variables as the port's state_dict."""
    state, _ = _jax_init(name)
    variables = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
    return {k: v.numpy() for k, v in state_dict_from_jax(variables).items()}


def _spec(name):
    model, base, port_kw, _, opts, batches = _case(name)
    return dict(model=model, hparams=dict(base, **port_kw),
                weights=_weights(name), batches=batches,
                optimizer=opts.get("optimizer", "SgdOptimizer"),
                fsdp_min_size=opts.get("fsdp_min_size", 0),
                ema_decay=opts.get("ema_decay", 0.0),
                loss=opts.get("loss", "CrossEntropyLoss"),
                loss_kw=opts.get("loss_kw", {}), device="cpu",
                train=dict(base_learning_rate=LR, global_batch_size=B,
                           clip_gradient_norm=1.0))


def _jax_run(name, n):
    """The JAX manual step's trajectory at mesh size n: losses, the final
    variables and EMA (flat, the port's names), the sharded names."""
    model, _, _, _, opts, batches = _case(name)
    _, hp = _jax_init(name)
    mesh, state, shardings = _jax_state(name, n)
    specs = jax.tree_util.tree_map(lambda s: s.spec, shardings)
    state = jax.device_put(state, shardings)
    manual = n > 1  # one device: the single-program step
    step = jax_make_train_step(
        jax_get_model(model, hp.replace(bn_axis=jax_mesh.DATA_AXIS)
                      if manual else hp),
        jax_losses.get_loss(opts.get("loss", "CrossEntropyLoss"),
                            **opts.get("loss_kw", {})),
        ema_decay=opts.get("ema_decay", 0.0), mesh=mesh if manual else None,
        state_specs=specs if manual else None, donate=False)
    losses = []
    for i, b in enumerate(batches):
        state, metrics = step(state, jax_mesh.shard_batch(b, mesh),
                              jax.random.PRNGKey(7 + i))
        losses.append(float(jax.device_get(metrics["loss"])))
    state = jax.device_get(state)
    sharded = sorted(k for k, s in _flat_specs(specs.params).items()
                     if any(a is not None for a in s))
    variables = {**_flat(state.params), **_flat(state.batch_stats)}
    ema = None if state.ema_params is None else _flat(state.ema_params)
    return losses, variables, ema, sharded


def _flat_specs(tree):
    is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa
    return {".".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_spec)}


def _port(n, names):
    """{case: rank 0's result}, and every rank's results under "ranks"."""
    ranks = launch(replay_all, ([_spec(m) for m in names],), nprocs=n,
                   device="cpu", timeout_s=DEADLINE_S)
    return dict(zip(names, ranks[0]), ranks=ranks)


@pytest.fixture(scope="module")
def port_at_2():
    return _port(2, AT_2 + ["adafactor"] + list(VLAD_CORE))


@pytest.fixture(scope="module")
def port_at_4():
    return _port(4, AT_4)


def _assert_close(name, got, n):
    want_losses, want, want_ema, sharded = _jax_run(name, n)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=RTOL)
    assert set(got["state"]) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got["state"][key], value, rtol=RTOL,
                                   atol=ATOL, err_msg=key)
    assert got["sharded"] == sharded
    if want_ema is not None:
        assert set(got["ema"]) == set(want_ema)
        for key, value in want_ema.items():
            np.testing.assert_allclose(got["ema"][key], value, rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    return sharded


@pytest.mark.parametrize("name", [m for m in AT_2 if m != "fsdp_adam"])
def test_two_ranks_match_the_jax_manual_step(name, port_at_2):
    sharded = _assert_close(name, port_at_2[name], 2)
    assert bool(sharded) == name.startswith("fsdp")


def test_fsdp_adam_loss_trajectory_matches_the_jax_manual_step(port_at_2):
    """Adam + FSDP: the loss trajectory (parameters whose true gradient is
    0 move by lr * sign(noise) under Adam; tests/test_manual_train.py
    :265), with the moments sharded as JAX shards them."""
    want, _, _, sharded = _jax_run("fsdp_adam", 2)
    got = port_at_2["fsdp_adam"]
    np.testing.assert_allclose(got["losses"], want, rtol=RTOL)
    assert got["sharded"] == sharded and sharded


def test_fsdp_adafactor_matches_the_jax_manual_step(port_at_2):
    got = port_at_2["adafactor"]
    _assert_close("adafactor", got, 2)
    assert got["sharded"] == ["tower.experts_kernel", "tower.gates_kernel"]


@pytest.mark.parametrize("name", list(VLAD_CORE))
def test_fused_vlad_core_at_two_ranks_matches_one_device(name, port_at_2):
    """--netvlad_fused_train (and the flagship's trainable LSTM, with its
    VLAD hidden FC sharded) at two ranks against the port's one-device
    step from the same weights on the same global batches."""
    spec = _spec(name)
    model = get_model(spec["model"], ModelHParams(**spec["hparams"]))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["weights"].items()})
    state = TrainState(model, optimizer="SgdOptimizer", **spec["train"])
    step = make_train_step(tlosses.get_loss("CrossEntropyLoss"))
    losses = []
    for b in spec["batches"]:
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        losses.append(float(metrics["loss"]))
    got = port_at_2[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=RTOL)
    for key, value in model.state_dict().items():
        np.testing.assert_allclose(got["state"][key], value.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    assert bool(got["sharded"]) == ("fsdp_min_size" in VLAD_CORE[name][4])


@pytest.mark.parametrize("name", AT_4)
def test_four_ranks_match_the_jax_manual_step(name, port_at_4):
    _assert_close(name, port_at_4[name], 4)


def test_ranks_end_with_the_same_replicated_state(port_at_2):
    """Every rank's copy of the model is the same after the steps (the
    summed gradients and the cross-replica moments are the same bits on
    every rank), gathered on rank 0 and rank 1 alike."""
    rank0, rank1 = port_at_2["ranks"]
    for a, b in zip(rank0, rank1):
        assert (a["rank"], b["rank"]) == (0, 1)
        assert a["digest"] == b["digest"]
        for key in a["state"]:
            np.testing.assert_array_equal(a["state"][key], b["state"][key])


# ---------------------------------------------------------------------------
# the policy, the batch blocks, BatchNorm, the flags (no spawn)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 16), (63, 16), (4096,), (2, 3, 4),
                                   (8,), ()])
@pytest.mark.parametrize("world,min_size", [(1, 64), (2, 0), (2, 64),
                                            (4, 64), (4, 10000), (8, 8)])
def test_param_spec_is_the_jax_policy(shape, world, min_size):
    mesh = jax_mesh.make_mesh(world)
    want = jax_mesh.param_spec("a/b", np.zeros(shape, np.float32), mesh,
                               min_size)
    assert param_spec("a.b", shape, world, min_size) == tuple(want)


def test_shard_batch_takes_the_ranks_blocks_in_order():
    batch = _batches(weights=True, teacher=True)[0]
    batch["id"] = [str(i).encode() for i in range(B)]
    parts = [shard_batch(batch, r, 4) for r in range(4)]
    for key, value in batch.items():
        if key == "id":
            assert sum((p["id"] for p in parts), []) == value
        else:
            np.testing.assert_array_equal(
                np.concatenate([p[key] for p in parts]), value)
    assert shard_rows(16, 3, 4) == slice(12, 16)
    with pytest.raises(ValueError, match="divide"):
        shard_rows(10, 0, 4)


def test_world_size_and_backend_follow_the_device(monkeypatch):
    assert distributed.world_size_for(None, "cpu") == 1
    assert distributed.world_size_for(3, "cpu") == 3
    assert distributed.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.backend_for("cuda", 1) == "nccl"
    # More ranks on a host than its cards: NCCL refuses two ranks on one
    # card, and gloo runs only where the caller asks for it.
    with pytest.raises(ValueError, match="backend='gloo'"):
        distributed.backend_for("cuda", 2)
    assert distributed.backend_for("cuda", 2, "gloo") == "gloo"
    with pytest.raises(ValueError):
        distributed.world_size_for(0, "cpu")
    assert not distributed.maybe_initialize("cpu")  # no torchrun here
    assert distributed.process_count() == 1
    assert distributed.rank_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("local_ranks,backend", [("8", "nccl"),
                                                 ("16", None)])
def test_torchrun_picks_the_backend_by_the_ranks_on_each_host(
        monkeypatch, local_ranks, backend):
    """Two hosts of 8 cards (WORLD_SIZE 16, LOCAL_WORLD_SIZE 8) run NCCL;
    16 ranks on one host of 8 cards are refused."""
    started = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(distributed, "_init",
                        lambda *a: started.append(a))
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("WORLD_SIZE", "16")
    monkeypatch.setenv("LOCAL_RANK", "3")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", local_ranks)
    if backend is None:
        with pytest.raises(ValueError, match="16 ranks"):
            distributed.maybe_initialize("cuda")
        assert not started
    else:
        assert distributed.maybe_initialize("cuda")
        assert started == [(backend, "env://", 16, 3, 3)]


@pytest.mark.parametrize("cli,argv", [
    ("train", ["--train_data_pattern=none-*"]),
    ("eval", ["--eval_data_pattern=none-*", "--run_once"]),
    ("inference", ["--input_data_pattern=none-*", "--output_file=out.csv"]),
])
def test_the_clis_launch_their_ranks_without_a_deadline(monkeypatch, cli,
                                                        argv):
    """A training run, or an eval that polls for checkpoints, runs as long
    as it runs: the CLIs hand the launcher no deadline, and pass on the
    caller's options."""
    import importlib

    calls = []
    monkeypatch.setattr(distributed, "launch", lambda fn, args, n, device,
                        **kw: calls.append((n, device, kw)) or [None])
    main = importlib.import_module(f"yt8m_tpu_torch.cli.{cli}").main
    main([*argv, "--num_devices=2", "--device=cpu"])
    main([*argv, "--num_devices=3", "--device=cpu"], backend="gloo",
         timeout_s=5.0)
    assert calls == [(2, "cpu", {}),
                     (3, "cpu", {"backend": "gloo", "timeout_s": 5.0})]


def test_launch_without_a_deadline_waits_for_the_ranks():
    assert launch(distributed.host_all_reduce, ([2.0],), nprocs=2,
                  device="cpu") == [[4.0]] * 2


def test_replica_moments_of_one_rank():
    """Without a group, the cross-replica moments are one rank's:
    E[x^2] - E[x]^2 clamped at 0, against the inline BN's E[(x-mean)^2]
    within float32 rounding."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        3.0, 2.0, size=(40, 7)).astype(np.float32))
    mean, var = replica_moments(x)
    want_mean, want_var = bn_moments(x)
    torch.testing.assert_close(mean, want_mean, rtol=0, atol=0)
    torch.testing.assert_close(var, want_var, rtol=1e-5, atol=1e-6)
    const = torch.full((5, 3), 0.1)
    assert torch.all(replica_moments(const)[1] >= 0)


def _small_hparams(**kw):
    return ModelHParams(vocab_size=C, feature_dim=D, max_frames=F,
                        dbof_cluster_size=16, dbof_hidden_size=8,
                        netvlad_cluster_size=4, netvlad_hidden_size=8,
                        lstm_cells=8, gru_cells=8, attention_hidden_size=8,
                        nextvlad_cluster_size=4, nextvlad_hidden_size=8,
                        nextvlad_groups=2, chain_hidden_size=8,
                        cnn_filters=8, **kw)


@pytest.mark.parametrize("name", list_models())
def test_bn_axis_reaches_every_batch_norm(name):
    """hparams.bn_axis reaches each BatchNorm site of the model and each
    inline BN (the sites the JAX models pass hp.bn_axis to)."""
    model = get_model(name, _small_hparams(bn_axis=DATA_AXIS))
    plain = get_model(name, _small_hparams())
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    assert all(m.axis == DATA_AXIS for m in norms)
    assert all(m.axis == "" for m in plain.modules()
               if isinstance(m, BatchNorm))
    vlads = [m for m in model.modules() if isinstance(m, NetVladAggregation)]
    assert all(m.bn_axis == DATA_AXIS for m in vlads)
    assert model.state_dict().keys() == plain.state_dict().keys()


def test_adafactor_refuses_a_block_that_factors(monkeypatch):
    """The JAX manual step fails on a sharded leaf whose block Adafactor
    factors; the port refuses it when it builds the state."""
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    monkeypatch.setattr(distributed, "process_index", lambda: 0)
    hp = ModelHParams(vocab_size=128, feature_dim=256,
                      compute_dtype="float32", moe_num_mixtures=1)
    with pytest.raises(ValueError, match="factor"):
        ParallelTrainState(get_model("MoeModel", hp), fsdp_min_size=1000,
                           optimizer="AdafactorOptimizer")
    state = ParallelTrainState(get_model("MoeModel", hp), fsdp_min_size=1000,
                               optimizer="SgdOptimizer")
    assert sorted(state.shards) == ["tower.experts_kernel",
                                    "tower.gates_kernel"]
    assert state.shards["tower.gates_kernel"].shape == (128, 256)


def test_parallel_flags_configure():
    cfg = TrainConfig(num_devices=2, fsdp_min_size=1000, device="cpu")
    assert (cfg.num_devices, cfg.fsdp_min_size) == (2, 1000)
    # --model_parallel is ported (a (data, model) grid of ranks); a grid
    # the ranks do not fill raises the JAX package's make_mesh error.
    assert TrainConfig(model_parallel=2).model_parallel == 2
    assert TrainConfig(num_devices=4, model_parallel=2).model_parallel == 2
    with pytest.raises(ValueError,
                       match="3 devices not divisible by model_parallel=2"):
        TrainConfig(num_devices=3, model_parallel=2)


def test_launch_returns_each_rank_and_fails_loudly(tmp_path):
    """Results come back rank by rank over a caller's file store; a rank
    that raises fails the launch with its traceback; a group past its
    deadline is stopped. The ranks import the port and torch, and
    neither JAX nor the JAX package."""
    store = "file://" + str(tmp_path / "store")
    assert launch(distributed.host_all_reduce, ([1.0, 2.0],), nprocs=3,
                  device="cpu", init_method=store,
                  timeout_s=DEADLINE_S) == [[3.0, 6.0]] * 3
    imported = launch(eval, (
        "[__import__(m) for m in ('yt8m_tpu_torch.cli.train', "
        "'yt8m_tpu_torch.cli.eval', 'yt8m_tpu_torch.cli.inference', "
        "'yt8m_tpu_torch.parallel.replay')] and sorted(m for m in "
        "__import__('sys').modules if m.split('.')[0] in "
        "('jax', 'yt8m_tpu'))",), nprocs=2, device="cpu",
        timeout_s=DEADLINE_S)
    assert imported == [[], []]
    with pytest.raises(RuntimeError, match="NoSuchModel"):
        launch(replay_all, ([dict(model="NoSuchModel", hparams={},
                                  batches=[])],), nprocs=2, device="cpu",
               timeout_s=DEADLINE_S)
    with pytest.raises(TimeoutError):
        launch(time.sleep, (600,), nprocs=2, device="cpu", timeout_s=5)
