"""The live-row schedule of the persistent recurrences
(csrc/recurrence_persist.cuh), shared by kernels/lstm.py, gru.py,
lstm_train.py and gru_train.py.

A row of step t is live when num_frames > orig_t (orig_t = F-1-t under
`reverse`). With the rows ordered by num_frames, descending and stable,
the live rows of every step are a prefix of that order: the kernel
multiplies the first live[t] rows of `order` at step t and leaves the
others frozen. The trainable backward runs the same schedule from t =
F-1 down; its product at step t takes the rows live at both t and t+1
(product_rows).
"""

from __future__ import annotations

import ctypes

import torch

# Barrier counters a call provides (csrc/recurrence_persist.cuh ::
# kMaxGroups): one a row group.
BARRIER_WORDS = 256


def live_schedule(num_frames: torch.Tensor, f: int, reverse: bool = False):
    """(order [B] int32, live [F] int32) on num_frames' device, with no
    copy to the host: order sorts the rows by num_frames, descending and
    stable; live[t] counts the rows live at step t."""
    order = torch.sort(num_frames, descending=True, stable=True).indices
    t = torch.arange(f, device=num_frames.device)
    orig = (f - 1 - t) if reverse else t
    live = (num_frames.to(torch.int64)[None, :] > orig[:, None]).sum(1)
    return order.to(torch.int32), live.to(torch.int32)


def live_pairs(num_frames: torch.Tensor, f: int,
               reverse: bool = False) -> torch.Tensor:
    """[F, B] bool: the (step, row) pairs the kernels compute, num_frames
    > orig_t. The trainable forward's gate residuals are 0 elsewhere."""
    t = torch.arange(f, device=num_frames.device)[:, None]
    orig = (f - 1 - t) if reverse else t
    return num_frames.to(torch.int64)[None, :] > orig


def product_rows(live: torch.Tensor) -> torch.Tensor:
    """[F] int32: the rows the trainable backward multiplies at step t,
    min(live[t], live[t+1]) (0 at t = F-1): the rows live at t+1, whose
    dh takes dZ_{t+1} @ W^T, that are live at t as well. Forward, that is
    every row live at t+1; under `reverse` a row live at t+1 but not at t
    would carry dh only into the initial state, which no caller reads."""
    nxt = torch.cat([live[1:], torch.zeros_like(live[:1])])
    return torch.minimum(live, nxt)


def launch_plan(fn, b: int, hd: int, backward: bool = False) -> dict:
    """The kernel's launch plan at B rows and H units, from its C plan
    query `fn` (yt8m_lstm_plan, yt8m_gru_plan or, with `backward`, the
    trainable backwards' yt8m_lstm_train_plan and yt8m_gru_train_plan):
    blocks, unit-tile lanes, row groups, whether the weights stay
    resident, shared bytes a block; the backward's ring warps and ring
    stages a warp. Raises on a CUDA error."""
    keys = ("grid", "lanes", "groups", "resident", "smem")
    if backward:
        keys += ("ring_warps", "stages")
    out = (ctypes.c_int * len(keys))()
    code = fn(b, hd, out)
    if code != 0:
        raise RuntimeError(f"launch plan B={b} H={hd}: CUDA error {code}")
    return dict(zip(keys, out))
