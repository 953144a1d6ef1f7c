"""The tile plans of dequant_affine_matmul (csrc/dequant_matmul.cu on
csrc/hopper_product.cuh) and of the trainable NetVLAD core
(csrc/netvlad_train.cu) on the CPU: what each launch asks of the card,
the persistent walks, and the kernels' tilings decomposed in plain
PyTorch, held against the plain versions and, for the VLAD core, against
JAX's netvlad_core in interpret mode.

Tolerances: each decomposition against its plain version within f32
summation order, 1e-5 * max|ref| + 1e-6 (both round the same operands
at the same points: the decompositions run the plain softmax row by
row, so bf16(assign) is the same value; only the order of the f32 sums
of the products, of a_sum and of the VJP's row sums differ), and
exactly on the hazards (frames past num_frames never read, num_frames =
0 gives vlad = 0). Against JAX's kernel in interpret mode, the bound of
tests/test_torch_netvlad_train.py (3e-3 * max(1, max|ref|): a last-bit
difference of an f32 softmax before a bf16 rounding moves one operand by
one bf16 step). The compiled kernels' plans are held to these in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.netvlad_train import netvlad_core as jax_core
from yt8m_tpu_torch.kernels import dequant_matmul as tdq
from yt8m_tpu_torch.kernels import netvlad_train as tnt

SMEM_LIMIT = 232448   # shared memory a block can use on an H100
BOX_LIMIT = 256       # TMA's largest box dimension
SWIZZLE_ROW = 128     # bytes: the 128-byte swizzle's row, a box's inner extent
JAX_BF16 = 3e-3       # tests/test_torch_netvlad_train.py's bound


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _close(got, want, rel=1e-5):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-6, err


def _check_box(box, elem_bytes):
    assert all(1 <= n <= BOX_LIMIT for n in box), box
    assert box[0] * elem_bytes == SWIZZLE_ROW, box


# ---------------------------------------------------------------------------
# dequant_affine_matmul
# ---------------------------------------------------------------------------

# (M, D, N): the main shapes, then the edges that cut the new tiles.
DQ_SHAPES = [(153600, 1152, 4096), (153600, 128, 1024),
             (1, 512, 7), (127, 1000, 255), (129, 1152, 257),
             (1, 1152, 4096), (4097, 1152, 257), (70, 512, 130),
             (1, 64, 7), (127, 128, 255), (129, 200, 257), (5, 64, 7),
             (37, 128, 200)]


@pytest.mark.parametrize("m,d,n", DQ_SHAPES)
def test_dequant_plan_fits_the_card(m, d, n):
    p = tdq.plan(m, d, n)
    assert p["smem"] <= SMEM_LIMIT
    if p["route"] == "f32":
        assert tdq.compute_dtype(d) == torch.float32
        assert p["threads"] == 256 and p["chunks"] * tdq.F32_CHUNK >= d
        assert p["vec_x"] == (d % 16 == 0) and p["vec_w"] == (n % 4 == 0)
        return
    assert d % 8 == 0  # the wrapper's requirement on the bf16 route
    _check_box(p["box_a"], 2)
    _check_box(p["box_w"], 2)
    _check_box(p["box_y"], 4)
    assert p["box_a"][1] == tdq.ROWS and p["w_boxes"] * p["box_w"][0] == tdq.COLS
    for stride in (*p["strides_a"], *p["strides_w"]):
        assert stride % 16 == 0
    # The output's row stride decides the store: TMA only for 16-byte rows.
    assert p["tma_store"] == all(s % 16 == 0 for s in p["strides_y"])
    assert p["tma_store"] == (n % 4 == 0)
    assert p["ldw"] % 8 == 0 and p["ldw"] >= n
    assert p["stage_bytes"] % 1024 == 0 and p["staging_bytes"] % 1024 == 0
    assert p["k_steps"] * tdq.DEPTH >= d
    assert p["grid"] == min(p["tiles"], tdq.SMS)


@pytest.mark.parametrize("m,d,n", DQ_SHAPES)
def test_dequant_walk_covers_every_tile_once(m, d, n):
    """The persistent blocks' walks (tile blockIdx.x + i * grid) visit each
    (row tile, column tile) once; on the f32 route a block is a tile. The
    column tile runs fastest; the ranges cover [0, M) x [0, N)."""
    p = tdq.plan(m, d, n)
    seen = np.zeros((p["row_tiles"], p["col_tiles"]), np.int32)
    for blk in range(p["grid"]):
        for t in range(blk, p["tiles"], p["grid"]):
            rows, cols = tdq.tile_of(t, p)
            seen[rows.start // len(rows), cols.start // len(cols)] += 1
    assert (seen == 1).all()
    rows, cols = tdq.tile_of(p["tiles"] - 1, p)
    assert rows.start < m <= rows.stop and cols.start < n <= cols.stop
    if p["col_tiles"] > 1:
        assert tdq.tile_of(1, p)[0] == tdq.tile_of(0, p)[0]


def _dq_args(seed, m, d, n):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (m, d), generator=g, dtype=torch.uint8)
    w = torch.randn(d, n, generator=g) * d ** -0.5
    scale = (4.0 / 255.0) * (0.5 + torch.rand(d, generator=g))
    bias = -2.0 + 0.1 * torch.randn(d, generator=g)
    return x, w, scale, bias


def _tiled_dequant(x, w, scale, bias):
    """The kernels' tilings: for each tile, the affine applied once to its
    rows (unfused multiply and add), the depth walked in the kernel's
    steps (f32: chunks of 32; bf16: stages of 64, zero past D), the
    partial products summed in f32, the tile clipped to [M, N]."""
    m, d = x.shape
    n = w.shape[1]
    p = tdq.plan(m, d, n)
    step = tdq.F32_CHUNK if p["route"] == "f32" else tdq.DEPTH
    dt = tdq.compute_dtype(d)
    wc = w.to(dt).to(torch.float32)
    out = torch.full((m, n), float("nan"))
    for t in range(p["tiles"]):
        rows, cols = tdq.tile_of(t, p)
        r = slice(rows.start, min(rows.stop, m))
        c = slice(cols.start, min(cols.stop, n))
        xa = (x[r].to(torch.float32) * scale + bias).to(dt).to(torch.float32)
        acc = torch.zeros(r.stop - r.start, c.stop - c.start)
        for d0 in range(0, d, step):
            acc += xa[:, d0:d0 + step] @ wc[d0:d0 + step, c]
        out[r, c] = acc
    return out


@pytest.mark.parametrize("m,d,n", [(37, 128, 200), (5, 64, 7),
                                   (130, 200, 257), (1, 384, 129),
                                   (129, 512, 257), (9, 1000, 7)])
def test_dequant_tiling_equals_the_plain_version(m, d, n):
    args = _dq_args(m + d + n, m, d, n)
    want = tdq.dequant_affine_matmul_plain(*args)
    got = _tiled_dequant(*args)
    assert not torch.isnan(got).any()
    _close(got, want)


# ---------------------------------------------------------------------------
# netvlad_core
# ---------------------------------------------------------------------------

# (B, F, K, D): the training shape, then the edges (K in {8, 100, 256,
# 512}, F in {1, 63, 65, 300}).
VLAD_SHAPES = [(256, 300, 256, 1152), (3, 7, 100, 1000), (5, 70, 256, 1152),
               (2, 300, 512, 256), (6, 65, 257, 128), (4, 11, 8, 16),
               (3, 1, 8, 64), (3, 63, 100, 1152), (3, 65, 512, 1000),
               (2, 300, 100, 20)]


@pytest.mark.parametrize("b,f,k,d", VLAD_SHAPES)
def test_netvlad_plan_fits_the_card(b, f, k, d):
    p = tnt.plan(b, f, k, d)
    assert p["fwd_smem"] <= SMEM_LIMIT and p["bwd_smem"] <= SMEM_LIMIT
    assert p["assign_smem"] <= SMEM_LIMIT
    _check_box(p["box_assign"], 2)
    _check_box(p["box_x"], 4)
    _check_box(p["box_v"], 2)
    for stride in (*p["strides_assign"], *p["strides_x"], *p["strides_v"]):
        assert stride % 16 == 0
    assert p["kp"] % 8 == 0 and p["dp"] % 8 == 0
    assert p["kh"] in (128, 256) and 2 * p["kh"] >= k
    assert p["v_boxes"] * p["box_v"][1] == 2 * p["kh"]
    assert p["fwd_stage_bytes"] % 1024 == 0 and p["bwd_stage_bytes"] % 1024 == 0
    assert p["bwd_k_steps"] * tnt.DEPTH >= d
    assert p["fwd_grid"] == min(p["fwd_tiles"], tnt.SMS)
    assert p["bwd_grid"] == min(p["bwd_tiles"], tnt.SMS)


def test_netvlad_refuses_depths_tma_cannot_read():
    """x's rows are TMA strides: D must be a multiple of 4 on the card;
    the plan's strides show why, the CPU path takes any D."""
    assert tnt.plan(2, 5, 8, 18)["strides_x"][0] % 16 != 0
    args = [torch.zeros(2, 5, 8), torch.zeros(2, 5, 18),
            torch.tensor([5, 2], dtype=torch.int32), torch.zeros(8, 18)]
    vlad, _ = tnt.netvlad_core_forward(*args)
    assert vlad.shape == (2, 8, 18)


@pytest.mark.parametrize("b,f,k,d", VLAD_SHAPES)
def test_netvlad_walks_cover_every_tile_once(b, f, k, d):
    """The forward's walk visits each (video, cluster tile, column tile)
    once (the column tile fastest) and the backward's each (video, frame
    tile) once (the frame tile fastest); together they cover [K, D] and
    [F] of every video."""
    p = tnt.plan(b, f, k, d)
    seen = np.zeros((b, p["fwd_cluster_tiles"], p["fwd_col_tiles"]), np.int32)
    for blk in range(p["fwd_grid"]):
        for t in range(blk, p["fwd_tiles"], p["fwd_grid"]):
            video, cl, co = tnt.fwd_tile_of(t, p)
            seen[video, cl.start // tnt.FWD_CLUSTERS,
                 co.start // tnt.FWD_COLS] += 1
    assert (seen == 1).all()
    video, cl, co = tnt.fwd_tile_of(p["fwd_tiles"] - 1, p)
    assert video == b - 1 and cl.start < k <= cl.stop and co.start < d <= co.stop
    seen = np.zeros((b, p["bwd_frame_tiles"]), np.int32)
    for blk in range(p["bwd_grid"]):
        for t in range(blk, p["bwd_tiles"], p["bwd_grid"]):
            video, frames = tnt.bwd_tile_of(t, p)
            seen[video, frames.start // tnt.FRAMES] += 1
    assert (seen == 1).all()
    video, frames = tnt.bwd_tile_of(p["bwd_tiles"] - 1, p)
    assert video == b - 1 and frames.start < f <= frames.stop


def _live(nf, v, f):
    return min(max(int(nf[v]), 0), f)


def _softmax_rows(rows):
    """The plain version's softmax on a video's live rows."""
    e = torch.exp(rows - torch.amax(rows, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


def tiled_forward(act, x, nf, centers):
    """The forward's two launches in plain PyTorch. Launch 1, a video at a
    time: the softmax of its live rows once, a_sum summed in frame order,
    bf16(assign) into a [B, F, Kp] buffer with zero rows up to the next
    multiple of 64. Launch 2, tile by tile: 64-frame steps over the live
    frames only, x rounded to bf16 in the stage with frames past n zero,
    the steps' products summed in f32, a_sum * centers subtracted."""
    b, f, k = act.shape
    d = x.shape[2]
    p = tnt.plan(b, f, k, d)
    assign = torch.full((b, f, p["kp"]), float("nan"))
    a_sum = torch.empty(b, k)
    for v in range(b):
        n = _live(nf, v, f)
        pr = _softmax_rows(act[v, :n])
        acc = torch.zeros(k)
        for r in range(n):
            acc = acc + pr[r]
        a_sum[v] = acc
        assign[v, :n, :k] = _bf(pr)
        assign[v, n:min(f, -(-n // tnt.FRAMES) * tnt.FRAMES), :k] = 0.0
    vlad = torch.full((b, k, d), float("nan"))
    for t in range(p["fwd_tiles"]):
        v, cl, co = tnt.fwd_tile_of(t, p)
        n = _live(nf, v, f)
        cl = slice(cl.start, min(cl.stop, k))
        co = slice(co.start, min(co.stop, d))
        acc = torch.zeros(cl.stop - cl.start, co.stop - co.start)
        for f0 in range(0, n, tnt.FRAMES):
            fr = slice(f0, min(f0 + tnt.FRAMES, f))
            xs = x[v, fr, co].clone()
            xs[max(0, n - f0):] = 0.0  # frames past n: zeros, whatever x holds
            acc += assign[v, fr, cl].T @ _bf(xs)
        vlad[v, cl, co] = acc - a_sum[v, cl, None] * centers[cl, co]
    return vlad, a_sum


def tiled_backward(act, x, nf, centers, dvlad, need_dx=True):
    """The backward's launches in plain PyTorch. Launch 1: bf16(dvlad)
    once, and cdot. Launch 2, a (video, 64 frames) tile at a time: the
    live rows' dassign = bf16(x) @ bf16(dvlad)^T in 64-deep steps, the
    clusters split between two warpgroups of Kh; the softmax VJP with
    each row's sum of assign * dassign added per warpgroup, then across
    them; dact = 0 and bf16(assign) = 0 past n. Launch 3: dx =
    bf16(assign) @ bf16(dvlad), a batch a video."""
    b, f, k = act.shape
    d = x.shape[2]
    p = tnt.plan(b, f, k, d)
    dv16 = _bf(dvlad)
    cdot = torch.sum(centers[None] * dvlad, dim=-1)
    dact = torch.full((b, f, k), float("nan"))
    p16 = torch.full((b, f, k), float("nan"))
    halves = [slice(0, min(p["kh"], k)), slice(p["kh"], min(2 * p["kh"], k))]
    for t in range(p["bwd_tiles"]):
        v, frames = tnt.bwd_tile_of(t, p)
        n = _live(nf, v, f)
        lo, hi = frames.start, min(frames.stop, f)
        dact[v, lo:hi] = 0.0
        p16[v, lo:hi] = 0.0
        if lo >= n:
            continue
        live = slice(lo, min(hi, n))
        xs = _bf(x[v, live])
        da = torch.zeros(live.stop - live.start, k)
        for d0 in range(0, d, tnt.DEPTH):
            da += xs[:, d0:d0 + tnt.DEPTH] @ dv16[v, :, d0:d0 + tnt.DEPTH].T
        pr = _softmax_rows(act[v, live])
        da = da - cdot[v]
        tsum = sum(torch.sum(pr[:, h] * da[:, h], dim=-1, keepdim=True)
                   for h in halves if h.start < k)
        dact[v, live] = pr * (da - tsum)
        p16[v, live] = _bf(pr)
    dx = torch.matmul(p16, dv16) if need_dx else None
    return dact, dx


def _core_args(seed, b, f, k, d):
    g = torch.Generator().manual_seed(seed)
    act = 1.5 * torch.randn(b, f, k, generator=g)
    x = (torch.randint(0, 256, (b, f, d), generator=g).float() * (4.0 / 255.0)
         + (4.0 / 512.0 - 2.0))
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    centers = torch.randn(k, d, generator=g) * d ** -0.5
    dvlad = torch.randn(b, k, d, generator=g)
    return (act, x, nf, centers), dvlad


@pytest.mark.parametrize("b,f,k,d", [(4, 11, 8, 16), (3, 7, 100, 1000),
                                     (3, 65, 257, 128), (3, 63, 512, 64),
                                     (4, 300, 100, 20), (3, 1, 8, 64)])
def test_netvlad_tiling_equals_the_plain_version(b, f, k, d):
    args, dvlad = _core_args(b + f + k + d, b, f, k, d)
    want_v, want_a = tnt.netvlad_core_plain_forward(*args)
    got_v, got_a = tiled_forward(*args)
    _close(got_v, want_v)
    _close(got_a, want_a)
    want_da, want_dx = tnt.netvlad_core_plain_backward(*args, dvlad)
    got_da, got_dx = tiled_backward(*args, dvlad)
    _close(got_da, want_da)
    _close(got_dx, want_dx)
    assert tiled_backward(*args, dvlad, need_dx=False)[1] is None


def test_netvlad_tiling_ignores_frames_past_num_frames_exactly():
    """Large finite act and x past num_frames give the bits of zeros
    there; dact and dx are exact zeros past num_frames; num_frames = 0
    (video 1) gives vlad = 0 and a_sum = 0."""
    (act, x, nf, centers), dvlad = _core_args(5, 4, 70, 100, 64)
    past = torch.arange(70)[None, :] >= nf[:, None]
    clean = (act.masked_fill(past[..., None], 0.0),
             x.masked_fill(past[..., None], 0.0), nf, centers)
    loud = (torch.where(past[..., None], 3e4, act),
            torch.where(past[..., None], -1e5, x), nf, centers)
    for a, c in zip(tiled_forward(*clean), tiled_forward(*loud)):
        assert torch.equal(a, c)
    for a, c in zip(tiled_backward(*clean, dvlad),
                    tiled_backward(*loud, dvlad)):
        assert torch.equal(a, c)
    dact, dx = tiled_backward(*loud, dvlad)
    assert torch.all(dact[past] == 0) and torch.all(dx[past] == 0)
    vlad, a_sum = tiled_forward(*loud)
    assert torch.all(vlad[1] == 0) and torch.all(a_sum[1] == 0)


def test_netvlad_tiling_matches_jax_kernel_and_vjp():
    """The decomposition against JAX's netvlad_core (its Pallas kernels
    in interpret mode) and its VJP at a small shape."""
    rng = np.random.default_rng(7)
    b, f, d, k = 4, 11, 16, 8
    act = rng.normal(size=(b, f, k)).astype(np.float32)
    x = rng.normal(size=(b, f, d)).astype(np.float32)
    nf = np.array([f, 4, 1, 0], dtype=np.int32)
    centers = rng.normal(size=(k, d)).astype(np.float32)
    dvlad = rng.normal(size=(b, k, d)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda a, xx, c: jax_core(a, xx, jnp.asarray(nf), c, True),
        jnp.asarray(act), jnp.asarray(x), jnp.asarray(centers))
    want_da, want_dx, want_dc = vjp(jnp.asarray(dvlad))
    t = [torch.from_numpy(v) for v in (act, x, nf, centers)]
    vlad, a_sum = tiled_forward(*t)
    dact, dx = tiled_backward(*t, torch.from_numpy(dvlad))
    dcenters = -torch.einsum("bk,bkd->kd", a_sum, torch.from_numpy(dvlad))
    for got, want in ((vlad, out), (dact, want_da), (dx, want_dx),
                      (dcenters, want_dc)):
        want = np.asarray(want, np.float64)
        err = np.max(np.abs(got.double().numpy() - want))
        assert err <= JAX_BF16 * max(1.0, np.max(np.abs(want))), err
    assert torch.all(vlad[3] == 0)
