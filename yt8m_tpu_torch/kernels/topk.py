"""Exact top-k for the serving tail.

Replaces yt8m_tpu/kernels/topk.py :: exact_topk, which the JAX package
reaches through serving_topk. Contract (as the TPU kernel's): values
descending; ties go to the lowest index (lax.top_k's rule); NaN and
values <= -3e38 (-inf too) rank last and come out as exactly TOPK_NEG
with in-range indices; k <= 128. `torch.topk` documents no tie order, so
the plain version is a stable descending sort instead.

The CUDA kernel (csrc/topk.cu) is bound by one read of x from device
memory and, at serving batches, by a row's latency. A block a row keeps
the row's order-preserving 32-bit keys in shared memory (-0.0 and +0.0 on
one key). Each thread takes the largest of the keys it loaded, each warp
sorts its 32 maxima; the least of the warps' ceil(k / 8)-th largest is a
threshold at least k keys reach, and those keys (~k + 15 at 4716 scores)
are sorted by a bitonic network. Where more than 256 reach it (many equal
values), the k-th key is the threshold itself (fewer than k above it) or
found by a radix select on the row, and the keys above it and the first
of its ties in index order are sorted instead (`plan`).

serving_topk dispatches as yt8m_tpu/kernels/topk.py :: _dispatch_topk
does: k <= 128 goes to exact_topk, larger k to a library op outside any
kernel (there an exact XLA op, here `stable_sort_topk`, a stable
torch.sort), on either device. sorted_topk, the eval metric path's top-k
(JAX: lax.top_k's order as its library op), dispatches the same way:
both branches already give lax.top_k's order for finite scores.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

TOPK_NEG = -3.0e38
MAX_K = 128
MAX_COLUMNS = 0xFFFF  # C a launch takes (tie counts share a 32-bit scan)

# csrc/topk.cu's block (yt8m_exact_topk_plan reads the kernel's own).
THREADS = 256
BINS = 256     # a byte of the key a pass
LOADS = 5      # loads a thread keeps in flight
CAND = 256     # keys the maxima's threshold may pass and still be sorted
SMEM_LIMIT = 232448
STATIC_SMEM = BINS * 4 + CAND * 8 + (THREADS // 32) * 4 + 3 * 4


def plan(c: int, k: int) -> dict:
    """csrc/topk.cu's launch over rows of C columns: the columns a thread
    owns where the radix select runs (an odd count, so that a warp's
    threads sit on distinct banks), the row's and the block's shared
    memory, the candidates the threshold may pass and still be sorted,
    whether the loads are 16 bytes, and the bitonic network's width where
    it sorts k (the next power of two >= k)."""
    width = 1
    while width < k:
        width *= 2
    return {"threads": THREADS, "span": -(-c // THREADS) | 1, "smem": 4 * c,
            "static_smem": STATIC_SMEM, "bins": BINS, "loads": LOADS,
            "cand": CAND, "vector": c % 4 == 0, "sort_width": width}


def kernel_plan(c: int) -> dict:
    """The compiled kernel's block for C columns (card only)."""
    import ctypes

    out = (ctypes.c_int * 7)()
    _build.check_launch("yt8m_exact_topk_plan",
                        _build.library().yt8m_exact_topk_plan(c, out))
    return dict(zip(("threads", "span", "smem", "bins", "loads", "cand",
                     "static_smem"), out))


def stable_sort_topk(x, k: int):
    """Sanitise, stable descending sort, first k: any k <= C, any device.

    The plain version of exact_topk, and serving_topk's library op for
    k > MAX_K."""
    v = torch.where(torch.isnan(x), torch.full_like(x, TOPK_NEG), x)
    v = torch.clamp_min(v, TOPK_NEG)
    vals, idx = torch.sort(v, dim=1, descending=True, stable=True)
    return vals[:, :k].contiguous(), idx[:, :k].to(torch.int32).contiguous()


exact_topk_plain = stable_sort_topk


def exact_topk(x, k: int = 20):
    """(values [B, k] f32 descending, indices [B, k] int32), exact."""
    require(x.dim() == 2, f"x must be [B, C], got {tuple(x.shape)}")
    b, c = x.shape
    if k > MAX_K:
        raise ValueError(f"exact_topk supports k <= {MAX_K}, got {k}")
    require(1 <= k <= c, f"k={k} must be in [1, C={c}]")
    require(x.dtype == torch.float32, f"x: dtype {x.dtype}, want float32")
    if on_cpu(x):
        return exact_topk_plain(x, k)
    require(c <= MAX_COLUMNS and 4 * c + STATIC_SMEM <= SMEM_LIMIT,
            f"C={c} does not fit the kernel's shared memory")
    require_cuda_operand("x", x, torch.float32, (b, c))
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=x.device)
    code = _build.library().yt8m_exact_topk(
        _build.ptr(x), _build.ptr(vals), _build.ptr(idx), b, c, k,
        _build.current_stream(x.device),
    )
    _build.check_launch("exact_topk", code)
    exact_topk.launches += 1
    return vals, idx


exact_topk.launches = 0


def serving_topk(x, k: int):
    """Serving-tail top-k on float32 predictions: exact_topk for
    k <= MAX_K, the library op stable_sort_topk above it."""
    x = x.to(torch.float32).contiguous()
    if k > MAX_K:
        return stable_sort_topk(x, k)
    return exact_topk(x, k)


def sorted_topk(x, k: int):
    """The eval metric path's top-k (reference: yt8m_tpu/kernels/topk.py ::
    sorted_topk): values descending, ties to the lowest index, as
    lax.top_k orders finite scores; the dispatch of serving_topk."""
    return serving_topk(x, k)
