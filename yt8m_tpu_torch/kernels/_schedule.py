"""The live-row schedule of the persistent serving recurrences
(csrc/recurrence_persist.cuh), shared by kernels/lstm.py and gru.py.

A row of step t is live when num_frames > orig_t (orig_t = F-1-t under
`reverse`). With the rows ordered by num_frames, descending and stable,
the live rows of every step are a prefix of that order: the kernel
multiplies the first live[t] rows of `order` at step t and leaves the
others frozen.
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


def launch_plan(fn, b: int, hd: int) -> dict:
    """The kernel's launch plan at B rows and H units, from its C plan
    query `fn` (yt8m_lstm_plan or yt8m_gru_plan): blocks, unit-tile lanes,
    row groups, whether the weights stay resident, shared bytes a block.
    Raises on a CUDA error."""
    out = (ctypes.c_int * 5)()
    code = fn(b, hd, out)
    if code != 0:
        raise RuntimeError(f"launch plan B={b} H={hd}: CUDA error {code}")
    return dict(zip(("grid", "lanes", "groups", "resident", "smem"), out))
