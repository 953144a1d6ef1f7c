"""Fused dequantize + per-feature affine + matmul.

Replaces yt8m_tpu/kernels/dequant_matmul.py :: dequant_affine_matmul:

    y[M, N] = (x_u8[M, D] * scale[D] + bias[D]) @ w[D, N]     f32 out

with `scale` and `bias` folding the YT-8M dequantization and an
inference BatchNorm. The compute dtype is the TPU kernel's: bf16 operands
with f32 sums when D >= 512, f32 otherwise. On the card csrc/dequant_matmul.cu
runs it: for bf16, one launch rounds `w` to bf16 on every call (as the
TPU kernel does in its body), a second applies the affine once into a
[M, D] bf16 buffer, and a third runs the persistent TMA + wgmma product
of csrc/hopper_product.cuh (128 x 256 tiles, the f32 output stored by
TMA while the next tile's products run; from the registers when N is no
multiple of 4), both buffers allocated by this wrapper; for f32, one
register-tiled FMA product (128 x 128 a block, 8 x 8 a thread) that
applies the affine once to each uint8 it loads (`plan` describes both
launches). No model of the JAX package calls it; it is a library op for
uint8-input dense layers.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

BF16_MIN_DEPTH = 512  # D from which the TPU kernel computes in bf16

# csrc/hopper_product.cuh's tile (the bf16 route; yt8m_dequant_plan reads
# the kernel's own).
ROWS = 128           # rows a tile: two consumer warpgroups of 64
COLS = 256           # columns a tile: one m64n256k16 chain a warpgroup
DEPTH = 64           # D a ring stage (64 bf16, the 128-byte swizzle's row)
BOX_COLS = 64        # columns of a W box
STAGES = 3
OUT_BOX = (32, 64)   # f32 output box (columns, rows): 128-byte rows
SMS = 132            # an H100's SMs: the persistent grid's cap
# csrc/dequant_matmul.cu's f32 tile.
F32_ROWS = 128
F32_COLS = 128
F32_CHUNK = 32       # depth a shared-memory chunk
F32_THREAD = 8       # outputs a thread along rows and columns


def compute_dtype(d: int) -> torch.dtype:
    return torch.bfloat16 if d >= BF16_MIN_DEPTH else torch.float32


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, d: int, n: int, sms: int = SMS) -> dict:
    """The card's launch for y [M, N] = affine(x [M, D]) @ w [D, N]: the
    route, the tiles (the column tile fastest) and, for bf16, the
    persistent grid, the TMA boxes (innermost first), each map's global
    strides in bytes, the shared memory and whether the output is stored
    by TMA (its row stride N * 4 must be a multiple of 16)."""
    if compute_dtype(d) == torch.float32:
        row_tiles, col_tiles = _ceil(m, F32_ROWS), _ceil(n, F32_COLS)
        return {
            "route": "f32", "row_tiles": row_tiles, "col_tiles": col_tiles,
            "tiles": row_tiles * col_tiles, "grid": row_tiles * col_tiles,
            "threads": (F32_ROWS // F32_THREAD) * (F32_COLS // F32_THREAD),
            "chunks": _ceil(d, F32_CHUNK),
            "vec_x": d % 16 == 0, "vec_w": n % 4 == 0,
            "smem": 2 * 2 * F32_CHUNK * F32_ROWS * 4,
        }
    ldw = _ceil(n, 8) * 8
    row_tiles, col_tiles = _ceil(m, ROWS), _ceil(n, COLS)
    tiles = row_tiles * col_tiles
    stage = ROWS * DEPTH * 2 + _ceil(COLS, BOX_COLS) * DEPTH * BOX_COLS * 2
    staging = 2 * 2 * 64 * 64 * 4  # two consumers x two quarters of [64][64] f32
    return {
        "route": "bf16", "row_tiles": row_tiles, "col_tiles": col_tiles,
        "tiles": tiles, "grid": min(tiles, sms), "k_steps": _ceil(d, DEPTH),
        "ldw": ldw, "box_a": (DEPTH, ROWS, 1), "box_w": (BOX_COLS, DEPTH, 1),
        "box_y": (*OUT_BOX, 1), "w_boxes": _ceil(COLS, BOX_COLS),
        "strides_a": (d * 2, m * d * 2), "strides_w": (ldw * 2, d * ldw * 2),
        "strides_y": (n * 4, m * n * 4), "tma_store": n % 4 == 0,
        "stages": STAGES, "stage_bytes": stage, "staging_bytes": staging,
        "smem": STAGES * stage + staging + 2 * STAGES * 8 + 1024,
    }


def tile_of(t: int, p: dict):
    """Tile t of a plan: (rows, columns) as ranges before clipping to M
    and N; the column tile runs fastest."""
    rt, ct = divmod(t, p["col_tiles"])
    rows, cols = (ROWS, COLS) if p["route"] == "bf16" else (F32_ROWS,
                                                            F32_COLS)
    return (range(rt * rows, (rt + 1) * rows),
            range(ct * cols, (ct + 1) * cols))


def kernel_plan() -> dict:
    """The compiled kernels' tiles and the card's SMs (card only)."""
    import ctypes

    out = (ctypes.c_int * 9)()
    _build.check_launch("yt8m_dequant_plan",
                        _build.library().yt8m_dequant_plan(out))
    return dict(zip(("rows", "cols", "stages", "smem", "f32_rows",
                     "f32_cols", "f32_chunk", "f32_smem", "sms"), out))


def dequant_affine_matmul_plain(x_u8, w, scale, bias):
    """Plain PyTorch version with the kernel's rounding points: the affine
    in f32, both operands rounded to the compute dtype, f32 sums."""
    dt = compute_dtype(x_u8.shape[1])
    x = x_u8.to(torch.float32) * scale + bias
    return torch.matmul(x.to(dt).to(torch.float32),
                        w.to(dt).to(torch.float32))


def dequant_affine_matmul(x_u8, w, scale, bias):
    """y = (x_u8 * scale + bias) @ w: [M, N] f32.

    x_u8 [M, D] uint8; w [D, N] f32; scale and bias [D] f32. Any M and N;
    on the card D must be a multiple of 8 when D >= 512.
    """
    require(x_u8.dim() == 2, f"x_u8 must be [M, D], got {tuple(x_u8.shape)}")
    m, d = x_u8.shape
    require(w.dim() == 2 and w.shape[0] == d,
            f"w must be [{d}, N], got {tuple(w.shape)}")
    n = w.shape[1]
    if on_cpu(x_u8, w, scale, bias):
        return dequant_affine_matmul_plain(x_u8, w, scale, bias)
    require(m >= 1 and n >= 1, "M and N must be at least 1")
    require_cuda_operand("x_u8", x_u8, torch.uint8, (m, d))
    require_cuda_operand("w", w, torch.float32, (d, n))
    require_cuda_operand("scale", scale, torch.float32, (d,))
    require_cuda_operand("bias", bias, torch.float32, (d,))
    out = torch.empty((m, n), dtype=torch.float32, device=x_u8.device)
    lib = _build.library()
    stream = _build.current_stream(x_u8.device)
    if compute_dtype(d) == torch.bfloat16:
        require(d % 8 == 0, f"D={d} must be a multiple of 8")
        # The product copies w in 16-byte rows: its bf16 copy has its
        # columns padded (with zeros) to a multiple of 8.
        ldw = -(-n // 8) * 8
        w16 = torch.empty((d, ldw), dtype=torch.bfloat16,
                          device=x_u8.device)
        xa = torch.empty((m, d), dtype=torch.bfloat16, device=x_u8.device)
        code = lib.yt8m_dequant_matmul_bf16(
            _build.ptr(x_u8), _build.ptr(scale), _build.ptr(bias),
            _build.ptr(w), _build.ptr(w16), _build.ptr(xa), _build.ptr(out),
            m, d, n, ldw, stream)
    else:
        code = lib.yt8m_dequant_matmul_f32(
            _build.ptr(x_u8), _build.ptr(scale), _build.ptr(bias),
            _build.ptr(w), _build.ptr(out), m, d, n, stream)
    _build.check_launch("dequant_affine_matmul", code)
    dequant_affine_matmul.launches += 1
    return out


dequant_affine_matmul.launches = 0
