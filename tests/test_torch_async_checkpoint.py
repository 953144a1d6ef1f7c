"""--async_checkpoint (yt8m_tpu_torch/train/checkpoint.py): a background
writer of the trainer's step directories, with the JAX package's
semantics (yt8m_tpu/train/checkpoint.py: the state copied to the host
before save returns, saves in order, the last one durable when the run
ends, a crash mid-write leaving the previous step as the latest).

Tolerances: none. A run with the writer and one without it write the same
bytes at every step (model.pt, optimizer.pt, ema.pt: the same tensors
through the same torch.save), and the runs resumed from them log the
same losses, bit for bit (the same computations on the same state).
"""

import os
import threading
import time

import pytest
import torch

from yt8m_tpu_torch.train import checkpoint as ckpt_lib
from yt8m_tpu_torch.train import loop as tloop
from yt8m_tpu_torch.train.checkpoint import (
    EMA_FILE,
    MODEL_FILE,
    OPTIMIZER_FILE,
    CheckpointManager,
)

import test_torch_trainer as trainer_tests  # noqa: E402
from yt8m_tpu_torch.data.synthetic import write_dataset


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("async_data")
    write_dataset(str(root), "train", num_shards=2, videos_per_shard=16,
                  frame_level=True, num_classes=trainer_tests.C, seed=1,
                  rgb_dim=trainer_tests.D_RGB, audio_dim=trainer_tests.D_AUDIO)
    return str(root / "train-*.tfrecord")


def _cfg(data, run, **kw):
    base = dict(save_checkpoint_every_n_steps=1, max_checkpoints_to_keep=10,
                ema_decay=0.9)
    base.update(kw)
    return trainer_tests._port_cfg(data, run, **base)


def _bytes(run, step, name):
    with open(os.path.join(run, str(step), name), "rb") as f:
        return f.read()


def test_async_run_writes_the_sync_run_bytes_and_resumes_alike(
        data, tmp_path):
    runs = {}
    for mode in (False, True):
        run = str(tmp_path / f"async_{mode}")
        trainer = tloop.Trainer(_cfg(data, run, max_steps=3,
                                     async_checkpoint=mode))
        assert trainer.ckpt.async_save is mode
        assert trainer.run() == 3
        runs[mode] = run
    for step in (1, 2, 3):
        for name in (MODEL_FILE, OPTIMIZER_FILE, EMA_FILE):
            assert _bytes(runs[True], step, name) == \
                _bytes(runs[False], step, name), (step, name)
    for mode, run in runs.items():
        # The writer is drained: no hidden temporary directory is left.
        assert sorted(os.listdir(run)) == [
            "1", "2", "3", "events.jsonl", "model_flags.json"]
        assert tloop.Trainer(_cfg(data, run, max_steps=5,
                                  async_checkpoint=mode)).run() == 5
    assert trainer_tests._losses(runs[True]) == \
        trainer_tests._losses(runs[False])
    for name in (MODEL_FILE, OPTIMIZER_FILE, EMA_FILE):
        assert _bytes(runs[True], 5, name) == _bytes(runs[False], 5, name)


def _state():
    state = trainer_tests._state(0, ema=False)
    return trainer_tests._train_some(state, steps=1)


def test_async_save_copies_the_state_before_it_returns(tmp_path,
                                                      monkeypatch):
    """The written step holds the state as it was at save, even when
    training changes the parameters while the writer is still busy."""
    gate = threading.Event()
    real = ckpt_lib.write_step

    def slow(*args):
        gate.wait(10)
        return real(*args)

    monkeypatch.setattr(ckpt_lib, "write_step", slow)
    state = _state()
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    assert ckpt.save(1, state)
    assert ckpt.all_steps() == []  # still in flight
    trainer_tests._train_some(state, steps=1)  # moves every parameter
    gate.set()
    ckpt.close()
    got = torch.load(os.path.join(str(tmp_path), "1", MODEL_FILE),
                     weights_only=True)
    for name, value in want.items():
        assert torch.equal(got[name], value), name


def test_async_saves_are_written_in_order(tmp_path, monkeypatch):
    """A save issued while one is in flight waits for it."""
    real = ckpt_lib.write_step
    order = []

    def slow(directory, step, files):
        time.sleep(0.2)
        order.append(step)
        return real(directory, step, files)

    monkeypatch.setattr(ckpt_lib, "write_step", slow)
    state = _state()
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    t0 = time.perf_counter()
    assert ckpt.save(1, state)
    assert time.perf_counter() - t0 < 0.2  # returned before the write
    assert ckpt.save(2, state)  # waited for step 1
    assert order == [1]
    assert ckpt.force_save(3, state)  # drains: 2, then 3
    assert order == [1, 2, 3] and ckpt.all_steps() == [1, 2, 3]
    # save 1 returned at once, save 2 waited for step 1, force_save for 2
    # and 3.
    held = ckpt.held_seconds
    assert len(held) == 3 and held[0] < 0.2 and held[1] >= 0.15
    assert held[2] >= 0.3 and ckpt.blocking_seconds == sum(held)
    assert not ckpt.force_save(3, state)
    ckpt.close()


def test_async_writer_error_is_raised_at_the_next_save(tmp_path,
                                                       monkeypatch):
    def broken(*args):
        raise OSError("disk full")

    state = _state()
    ckpt = CheckpointManager(str(tmp_path), async_save=True)
    assert ckpt.save(1, state)
    ckpt.wait()
    monkeypatch.setattr(ckpt_lib.torch, "save", broken)
    assert ckpt.save(2, state)  # fails on the writer's thread
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(3, state)  # waits for step 2 first
    monkeypatch.undo()
    # The failed step left no directory; the previous one is the latest.
    assert sorted(os.listdir(str(tmp_path))) == ["1"]
    assert ckpt.latest_step() == 1
    monkeypatch.setattr(ckpt_lib.torch, "save", broken)
    assert ckpt.save(4, state)
    with pytest.raises(OSError, match="disk full"):
        ckpt.close()  # drains the writer: its failure is not swallowed
    monkeypatch.undo()
    assert sorted(os.listdir(str(tmp_path))) == ["1"]


def test_trainer_raises_the_writer_error_when_the_run_ends(data, tmp_path,
                                                           monkeypatch):
    def broken(*args):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_lib, "write_step", broken)
    trainer = tloop.Trainer(_cfg(data, str(tmp_path / "run"), max_steps=2,
                                 async_checkpoint=True,
                                 save_checkpoint_every_n_steps=100))
    with pytest.raises(OSError, match="disk full"):
        trainer.run()
