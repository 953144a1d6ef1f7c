"""Fused mixture-of-experts head for the serving path.

Replaces yt8m_tpu/kernels/moe_head.py :: moe_head_serving. For hidden
activations x [B, H] f32:

    G = round(x) @ Wg             [B, C*(M+1)]  column c*(M+1)+m, no bias
    E = round(x) @ We + be        [B, C*M]      column c*M+m
    eg = exp(clamp(G, -80, 80))
    probs = sum_{m<M} eg[..., m] * sigmoid(E[..., m]) / sum_{m<=M} eg[..., m]

`round` is the cast to the weights' dtype, which selects the route on
the card; any M >= 1 runs there, as the TPU kernel takes any M. The
softmax is in the TPU kernel's ratio form with clamped logits, and the
dummy expert m = M adds to the denominator only. At bf16
the CUDA kernel (csrc/moe_head.cu, on the TMA + wgmma mainloop of
csrc/hopper_gemm.cuh) is bound by the bf16 tensor-core rate and keeps
the [B, C, M+1] and [B, C, M] intermediates on chip; it takes any H (the
rounded x is stored at a pitch of H rounded up to 8, and the last
64-deep stage reads the columns of x and the rows of the weights past H
as TMA's zero fill, zero terms in exact sums). At f32
(--compute_dtype=float32) nothing is rounded to bf16, as in the TPU
kernel at dtype=float32: the same kernel's F32 instances multiply on the
TF32 tensor cores as a 3xTF32 product (kernels/tf32.py: x and the
weights split into two TF32 halves, three products summed in f32, about
2^-21 of each product from the f32 one; the tensor core sums one 32-deep
stage, the stages add up on the FMA units), with the same combine in the
epilogue. They read the weights' split copies, [2, cols, H rounded up
to 4] K-major (`tf32.split_weights`), which MoeHead builds with its
serving constants (`split`), and split x on each call.

A block covers 128 videos x NC classes on both routes. M in {1, 2, 4}
has a tile of its own (`TILES`); any other M up to 121 takes the
run-time tile, NC = min(129 / (M + 1), 121 / M) classes in chains of 136
and 128 columns (M = 32: 3 classes; TMA starts a box of the bf16
weights' MN-major columns at a multiple of 8 columns, so a tile reads
from its first columns rounded down to 8, up to 7 columns on; the f32
route reads K-major rows from any column: min(136 / (M + 1), 128 / M)
classes, M = 32: 4); above 121 a block takes one class and loops over
chunks of 120 mixtures (chains of 136 and 128 columns; f32 128 and
120), adding each chunk's ratio-form terms to the row's numerator and
denominator (the clamp keeps them finite, so no running maximum is
needed). Gate and expert columns have chains of their own on both
routes.

TMA reads the weights by rows whose stride must be a multiple of 16
bytes, and C*(M+1) = 14,148 columns is not a multiple of 8 bf16. The
card path therefore takes each weight as a `pitched` view: the JAX
layout [H, cols] over a zero-padded buffer whose row stride is a
multiple of 8. `MoeHead.make_serving_constants` builds the views once;
the wrapper never pads a copy on a call.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels import tf32
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

PITCH = 8  # row strides the card takes: a multiple of 8 bf16 (16 bytes)

# csrc/moe_head.cu's tiles: M -> (classes a block, gate chain width,
# expert chain width); any other M runs the run-time chains, with
# runtime_classes(M) classes up to M = RUNTIME_MIXTURES and chunks of
# CHUNK_MIXTURES mixtures of one class above.
TILES = {1: (80, 160, 80), 2: (48, 144, 96), 4: (16, 80, 64)}
RUNTIME_CHAINS = (136, 128)
ALIGN_COLS = 8         # TMA box starts: multiples of 16 bytes
# 121: one class still fits the expert chain past the offset.
RUNTIME_MIXTURES = RUNTIME_CHAINS[1] - ALIGN_COLS + 1
# A chunk's gates, the dummy and 7 columns fit 136; its experts and 7, 128.
CHUNK_MIXTURES = 120
CHUNK_STAGES = 3       # the chunked tile's ring beside its exp(gate) slots
# The f32 route's chunked chains: 121 gates (the dummy among them) and
# 120 experts from their own columns, no offset.
F32_CHUNK_CHAINS = (128, 120)
ROWS = 128         # videos a block (two consumer warpgroups of 64)
DEPTH = 64         # H a ring stage (64 bf16, the 128-byte swizzle's row)
F32_DEPTH = 32     # H a stage of the f32 route (32 f32, 128 bytes)
BOX_COLS = 64      # columns of a bf16 weight box
STAGES = 4
SMEM_LIMIT = 232448  # shared bytes a block can ask for


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def runtime_classes(m: int, f32: bool = False) -> int:
    """Classes a block of the run-time tile at M <= 121 mixtures: both
    chains hold them past an offset of up to ALIGN_COLS - 1 columns (the
    f32 route's none)."""
    gate, expert = RUNTIME_CHAINS
    lost = 0 if f32 else ALIGN_COLS - 1
    return min((gate - lost) // (m + 1), (expert - lost) // m)


def plan(b: int, h: int, c: int, m: int, f32: bool = False) -> dict:
    """csrc/moe_head.cu's launch at x [B, H] and C classes of M mixtures,
    on the bf16 route or (f32) the 3xTF32 one: the tile, the mixture
    chunks a block walks, the grid (row tiles fastest), the TMA boxes
    (innermost first) and the shared memory (yt8m_moe_plan reads the
    kernel's own on the card)."""
    slots = 0
    if m in TILES:
        nc, gate, expert = TILES[m]
        chunks = 1
    elif m <= RUNTIME_MIXTURES:
        gate, expert = RUNTIME_CHAINS
        nc, chunks = runtime_classes(m, f32), 1
    else:
        gate, expert = F32_CHUNK_CHAINS if f32 else RUNTIME_CHAINS
        nc, chunks = 1, _ceil(m, CHUNK_MIXTURES)
        slots = 8 * 8 * gate  # [warp][row][gate] f32
    if f32:
        # Both halves of the x tile and of each chain's K-major rows.
        depth, hp = F32_DEPTH, _ceil(h, tf32.PITCH) * tf32.PITCH
        stage = 2 * (ROWS + gate + expert) * F32_DEPTH * 4
        fixed = 128 * 4 + slots * 4 + 2 * STAGES * 8 + 1024
        stages = min(STAGES, (SMEM_LIMIT - fixed) // stage)
        gate_boxes = expert_boxes = 2
        box_x, box_w = (F32_DEPTH, ROWS, 1), (F32_DEPTH, gate, 1)
    else:
        depth, hp = DEPTH, h
        gate_boxes, expert_boxes = _ceil(gate, BOX_COLS), _ceil(expert,
                                                                BOX_COLS)
        stage = ROWS * DEPTH * 2 + (gate_boxes + expert_boxes) * DEPTH * \
            BOX_COLS * 2
        stages = CHUNK_STAGES if chunks > 1 else STAGES
        box_x, box_w = (DEPTH, ROWS), (BOX_COLS, DEPTH)
    cols = gate + expert
    ld = cols + (8 - cols % 32) % 32
    # A block's gate and expert columns (a chunk's, when it walks chunks:
    # the last chunk's gates also hold the dummy), before the offset of up
    # to 7 columns of the bf16 run-time tiles.
    chunk = m if chunks == 1 else CHUNK_MIXTURES
    gate_cols = nc * (m + 1) if chunks == 1 else chunk + 1
    return {
        "classes": nc, "gate": gate, "expert": expert, "chunks": chunks,
        "gate_cols": gate_cols, "expert_cols": nc * chunk,
        "gate_boxes": gate_boxes, "expert_boxes": expert_boxes,
        "grid": (_ceil(b, ROWS), _ceil(c, nc)), "k_steps": _ceil(hp, depth),
        "box_x": box_x, "box_w": box_w,
        "stages": stages, "ring_bytes": stages * stage,
        "offset": 0 if m in TILES or f32 else ALIGN_COLS - 1,
        "smem": stages * stage + 2 * stages * 8 + 128 * 4 + slots * 4 + 1024,
        "stage_ld": ld, "staged_bytes": ROWS * ld * 4,
        "accumulators": cols // 2,
    }


def pitched_buffer(w):
    """w [rows, cols] in a zero-padded buffer [rows, cols rounded up to a
    multiple of 8]: `pitched`'s storage, a plain contiguous tensor (what
    an exported program carries; it slices the view itself)."""
    rows, cols = w.shape
    buf = torch.zeros((rows, _ceil(cols, PITCH) * PITCH), dtype=w.dtype,
                      device=w.device)
    buf[:, :cols] = w
    return buf


def pitched(w):
    """w [rows, cols] as a view of the same shape over a zero-padded
    buffer whose row stride is cols rounded up to a multiple of 8: the
    weight layout the card's kernel reads by TMA."""
    return pitched_buffer(w)[:, :w.shape[1]]


def check_pitched(name, w, shape, dtype=torch.bfloat16) -> None:
    """The card's weight operand: `dtype` (the route's) of `shape`, unit
    column stride, a row stride that is a multiple of 8 and 16-byte
    aligned rows."""
    require(w.dtype == dtype, f"{name}: dtype {w.dtype}, want {dtype}")
    require(tuple(w.shape) == tuple(shape),
            f"{name}: shape {tuple(w.shape)}, want {tuple(shape)}")
    require(w.stride(1) == 1 and w.stride(0) % PITCH == 0
            and w.stride(0) >= shape[1] and w.data_ptr() % 16 == 0,
            f"{name}: strides {w.stride()}; the card reads rows by TMA at a "
            f"stride that is a multiple of {PITCH}: pass "
            f"kernels.moe_head.pitched({name})")


def moe_head_plain(x, gate_kernel, expert_kernel, expert_bias,
                   num_mixtures: int):
    """Plain PyTorch version with the kernel's rounding points."""
    m = num_mixtures
    b = x.shape[0]
    c = gate_kernel.shape[1] // (m + 1)
    xa = x.to(gate_kernel.dtype).to(torch.float32)
    g = torch.matmul(xa, gate_kernel.to(torch.float32))
    e = torch.matmul(xa, expert_kernel.to(torch.float32)) + expert_bias
    eg = torch.exp(torch.clamp(g, -80.0, 80.0)).reshape(b, c, m + 1)
    num = torch.sum(eg[..., :m] * torch.sigmoid(e.reshape(b, c, m)), -1)
    return num / torch.sum(eg, -1)


def moe_head_serving(x, gate_kernel, expert_kernel, expert_bias,
                     num_mixtures: int, split=None):
    """probs [B, C] f32.

    x [B, H] f32; gate_kernel [H, C*(M+1)] and expert_kernel [H, C*M] in
    the compute dtype (bf16 or f32: the route on the card; bf16 with a row
    stride that is a multiple of 8: see `pitched`); expert_bias [C*M]
    f32. `split`: on the card's f32 route, the weights' split copies
    (tf32.split_weights(gate_kernel), tf32.split_weights(expert_kernel)),
    made once per weight version; the CPU and the bf16 route ignore it.
    """
    m = num_mixtures
    require(x.dim() == 2, f"x must be [B, H], got {tuple(x.shape)}")
    b, h = x.shape
    require(gate_kernel.dim() == 2 and gate_kernel.shape[0] == h
            and gate_kernel.shape[1] % (m + 1) == 0,
            f"gate_kernel must be [{h}, C*{m + 1}], "
            f"got {tuple(gate_kernel.shape)}")
    c = gate_kernel.shape[1] // (m + 1)
    if on_cpu(x, gate_kernel, expert_kernel, expert_bias):
        return moe_head_plain(x, gate_kernel, expert_kernel, expert_bias, m)
    require(m >= 1, f"num_mixtures={m}: want at least 1")
    dtype = gate_kernel.dtype
    require(dtype in (torch.bfloat16, torch.float32),
            f"gate_kernel: dtype {dtype}; the CUDA kernels compute in "
            "bfloat16 or float32")
    require_cuda_operand("x", x, torch.float32, (b, h))
    require_cuda_operand("expert_bias", expert_bias, torch.float32, (c * m,))
    f32 = dtype == torch.float32
    if f32:
        require(tuple(expert_kernel.shape) == (h, c * m)
                and expert_kernel.dtype == dtype,
                f"expert_kernel: {expert_kernel.dtype} "
                f"{tuple(expert_kernel.shape)}, want {dtype} {(h, c * m)}")
        gate_split, expert_split = split if split else (None, None)
        tf32.check_split("gate split", gate_split, h, c * (m + 1))
        tf32.check_split("expert split", expert_split, h, c * m)
    else:
        check_pitched("gate_kernel", gate_kernel, (h, c * (m + 1)), dtype)
        check_pitched("expert_kernel", expert_kernel, (h, c * m), dtype)
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    lib = _build.library()
    stream = _build.current_stream(x.device)
    if f32:
        # x's halves at a row pitch of H rounded up to 4 (TMA's rows).
        xs = torch.empty((2, b, _ceil(h, tf32.PITCH) * tf32.PITCH),
                         dtype=torch.float32, device=x.device)
        code = lib.yt8m_moe_head_serving_f32(
            _build.ptr(x), _build.ptr(gate_split), _build.ptr(expert_split),
            _build.ptr(expert_bias), _build.ptr(xs), _build.ptr(out), b, h,
            c, m, stream)
    else:
        # The rounded x at a row pitch of H rounded up to 8 (TMA's rows).
        xa = torch.empty((b, _ceil(h, PITCH) * PITCH), dtype=torch.bfloat16,
                         device=x.device)
        code = lib.yt8m_moe_head_serving(
            _build.ptr(x), _build.ptr(gate_kernel), _build.ptr(expert_kernel),
            _build.ptr(expert_bias), _build.ptr(xa), _build.ptr(out), b, h, c,
            m, gate_kernel.stride(0), expert_kernel.stride(0), stream)
    _build.check_launch("moe_head_serving", code)
    moe_head_serving.launches += 1
    if f32:
        moe_head_serving.launches_f32 += 1
    return out


moe_head_serving.launches = 0
moe_head_serving.launches_f32 = 0  # the f32 route's, counted in both


def kernel_plan(m: int, f32: bool = False) -> dict:
    """The compiled kernel's tile of a route at M mixtures (card only)."""
    import ctypes

    out = (ctypes.c_int * 7)()
    _build.check_launch("yt8m_moe_plan", _build.library().yt8m_moe_plan(
        m, int(f32), out))
    return dict(zip(("classes", "gate", "expert", "stages", "smem",
                     "stage_ld", "chunks"), out))
