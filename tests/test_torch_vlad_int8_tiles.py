"""The tile plans of the serving NetVLAD aggregation (csrc/netvlad.cu) and
of the int8 DBoF product (csrc/dbof_int8.cu) on the CPU: what each launch
asks of the card, the walks over live chunks and tiles, and the kernels'
tilings decomposed in plain PyTorch, held against the plain versions and
against the JAX kernels in interpret mode.

Tolerances.
  * NetVLAD decomposition against netvlad_aggregate_plain: 1e-5 *
    max|ref| + 1e-6 (f32 summation order). Both round the same operands
    at the same points; where the assignment is one warpgroup's (K <=
    256) the decomposition runs the plain softmax on the chunk's rows, so
    bf16(assign) is the same value. Where the two warpgroups split K, the
    row's sum of exp is the two halves' sums added, which can move the
    f32 assignment by an ulp and its bf16 rounding by one step: there the
    assignment is held to the plain one within 4 ulps of f32, and the
    output to the plain residuals and norms on the decomposition's own
    bf16 assignment and column sums within the same 1e-5 bound.
  * Against JAX's netvlad_aggregate in interpret mode: the bound of
    tests/test_torch_netvlad.py (1e-5 * max|ref| + 1e-7), on the frames
    the port dequantized (the interpret-mode kernel contracts the dequant
    into one FMA).
  * int8: bit for bit against dbof_cluster_maxpool_int8_plain (integer
    sums in int64, one conversion, the affine in f32); against JAX's
    kernel in interpret mode the bound of tests/test_torch_dbof_int8.py
    (1e-5 * max|ref| + 1e-7).
The compiled kernels' plans are held to these in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.dbof import dbof_cluster_maxpool_int8 as jax_int8
from yt8m_tpu.kernels.netvlad import netvlad_aggregate as jax_netvlad
from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.kernels import netvlad as tvlad

SMEM_LIMIT = 232448   # shared memory a block can use on an H100
BOX_LIMIT = 256       # TMA's largest box dimension
SWIZZLE_ROW = 128     # bytes: the 128-byte swizzle's row, a box's inner extent
INT_MIN = -(2 ** 31)


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _close(got, want, rel=1e-5, abs_=1e-6):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * want.abs().max().item() + abs_, err


def _check_box(box, elem_bytes, swizzled=True):
    assert all(1 <= n <= BOX_LIMIT for n in box), box
    if swizzled:
        assert box[0] * elem_bytes == SWIZZLE_ROW, box
    else:
        assert (box[0] * elem_bytes) % 16 == 0, box


# ---------------------------------------------------------------------------
# NetVLAD: plans and walks
# ---------------------------------------------------------------------------

VLAD_PLANS = [(512, 300, 1152, 256), (16, 300, 1152, 512), (8, 300, 256, 264),
              (16, 300, 1152, 104), (16, 300, 1024, 256), (5, 13, 128, 8),
              (4, 70, 256, 136), (2, 1, 128, 64), (1, 1, 128, 512)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("b,f,d,k", VLAD_PLANS)
def test_netvlad_serving_plan_fits_the_card(b, f, d, k, x_dtype):
    p = tvlad.plan(b, f, d, k, x_dtype)
    assert p["assign_smem"] <= SMEM_LIMIT and p["agg_smem"] <= SMEM_LIMIT
    assert 2 <= p["assign_stages"] <= tvlad.MAX_STAGES
    # Every stage and every piece of it 1024-byte aligned.
    assert p["assign_stage_bytes"] % 1024 == 0 and p["x_bytes"] % 1024 == 0
    assert p["agg_stage_bytes"] % 1024 == 0
    assert tvlad.AGG_FRAMES % 16 == 0 and 64 % tvlad.AGG_FRAMES == 0
    # The x tile is rounded to bf16 in place: the bf16 tile fits.
    assert p["x_bytes"] >= max(p["x_load_bytes"], tvlad.B16_BOX)
    _check_box(p["box_x"], p["x_elem_bytes"], p["x_swizzled"])
    assert p["x_swizzled"] == (x_dtype == torch.float32)
    for box in (p["box_w"], p["box_xb"], p["box_assign"]):
        _check_box(box, 2)
    # One chain (or two halves of 256) covers K.
    w = p["clusters_a_warpgroup"]
    assert w * (2 if p["split"] else 1) >= k and p["w_boxes"] * tvlad.BOX >= k
    assert p["split"] == (k > 256)
    assert p["k_steps"] * tvlad.DEPTH == d
    assert p["agg_cluster_tiles"] * tvlad.AGG_CLUSTERS >= k
    assert p["agg_col_tiles"] * tvlad.D_TILE == d
    # The combination's centers tile: four swizzled f32 boxes [256][32].
    _check_box(p["box_centers"], 4)
    assert p["centers_bytes"] == 4 * 32 * tvlad.AGG_CLUSTERS * 4
    assert p["agg_grid"] == p["agg_per_combo"] * p["agg_combos"]
    assert p["agg_grid"] <= max(tvlad.SMS, p["agg_combos"])
    assert p["agg_per_combo"] <= b


def _nf(g, b, f):
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    return nf


@pytest.mark.parametrize("b,f", [(512, 300), (7, 64), (5, 65), (3, 1),
                                 (9, 130)])
def test_netvlad_walks_cover_each_live_chunk_and_tile_once(b, f):
    """The live chunks (nv_serve_scan's list) are those holding a frame t <
    n, each once, videos in order; num_frames outside [0, F] is clamped.
    The assignment's persistent walk takes each item once (two a tile
    for K <= 256, one above); the aggregation's walk each (video, cluster
    tile, column tile) once, the column tile fastest."""
    g = torch.Generator().manual_seed(b + f)
    nf = _nf(g, b, f)
    nf[-1] = 2 * f + 3
    items = tvlad.live_items(nf, f).tolist()
    chunks = -(-f // 64)
    want = [v * chunks + c for v in range(b)
            for c in range(-(-min(int(nf[v]), f) // 64))]
    assert items == want and len(set(items)) == len(items)
    assert all(v * chunks not in items for v in range(b) if nf[v] == 0)
    for k in (256, 512):
        p = tvlad.plan(b, f, 256, k)
        per = p["items_a_tile"]
        tiles = -(-len(items) // per)
        seen = np.zeros(len(items), np.int32)
        for blk in range(p["assign_grid"]):
            for t in range(blk, tiles, p["assign_grid"]):
                for w in range(per):
                    if per * t + w < len(items):
                        seen[per * t + w] += 1
        assert (seen == 1).all()
        seen = np.zeros((b, p["agg_cluster_tiles"], p["agg_col_tiles"]),
                        np.int32)
        for blk in range(p["agg_grid"]):
            walk = tvlad.agg_walk(blk, p, b)
            # A block keeps one (cluster tile, column tile): its centers.
            assert len({(cl.start, co.start) for _, cl, co in walk}) <= 1
            for v, cl, co in walk:
                seen[v, cl.start // tvlad.AGG_CLUSTERS,
                     co.start // tvlad.D_TILE] += 1
        assert (seen == 1).all()
        if p["agg_col_tiles"] > 1:  # the column tile fastest
            assert tvlad.agg_walk(1, p, b)[0][:2] == tvlad.agg_walk(0, p, b)[0][:2]


# ---------------------------------------------------------------------------
# NetVLAD: the tiling in plain PyTorch
# ---------------------------------------------------------------------------


def _vlad_args(seed, b, f, d, k, x_dtype):
    g = torch.Generator().manual_seed(seed)
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=g, dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=g)
    nf = _nf(g, b, f)
    wc = (torch.randn(d, k, generator=g) * d ** -0.5).to(torch.bfloat16)
    scale = 0.5 + torch.rand(k, generator=g)
    bias = 0.3 * torch.randn(k, generator=g)
    centers = torch.randn(k, d, generator=g) * d ** -0.5
    return x, nf, wc, scale, bias, centers


def _chunk_frames(x, v, f0, n):
    """A chunk's 64 rows as the consumers round them: dequant (uint8:
    multiply, then add), bf16; rows past n and past F zeros."""
    f = x.shape[1]
    rows = x[v, f0:f0 + 64].to(torch.float32)
    if x.dtype == torch.uint8:
        rows = rows * DEQUANT_SCALE + DEQUANT_BIAS
    xs = torch.zeros(64, x.shape[2])
    xs[: min(64, f - f0)] = _bf(rows)
    xs[max(0, n - f0):] = 0.0
    return xs


def rounded_frames(x):
    """The frames dequantized (uint8: multiply, then add) and rounded to
    bf16, in f32."""
    xr = x.to(torch.float32)
    if x.dtype == torch.uint8:
        xr = xr * DEQUANT_SCALE + DEQUANT_BIAS
    return _bf(xr)


def cluster_product(x, wc):
    """The frames' cluster product [B, F, K] in f32: rounded_frames times
    the bf16 cluster weights."""
    return torch.matmul(rounded_frames(x), wc.to(torch.float32))


def tiled_serving(x, nf, wc, scale, bias, centers, product=None):
    """csrc/netvlad.cu's five launches in plain PyTorch. (out, xb, assign
    (f32, unrounded), colsum). Launch 1, an item (a live 64-frame chunk)
    at a time: its rows rounded (zeros past n) and stored to xb, the
    affine and softmax of its rows (for K > 256 the row's max and sum
    joined from two halves of 256 clusters), rows past n zero, the
    chunk's column sums. The assignment product runs as the plain
    version's one matmul (the kernel's 64-deep steps only reorder its f32
    sums), so where K is one warpgroup's the assignment is the plain
    one's. Launches 2 and 4, a (video, 256 clusters, 128 columns) tile at
    a time in 32-frame steps over the live frames (rows from n to the
    step's end are zeros in both operands): v = acc - a_sum * centers,
    first its
    sums of squares a row, then (v / n_k) / g; launch 3 forms the norms
    from those sums. `product` (cluster_product's) is computed here when
    not given."""
    b, f, d = x.shape
    k = wc.shape[1]
    p = tvlad.plan(b, f, d, k, x.dtype)
    chunks = p["chunks"]
    if product is None:
        product = cluster_product(x, wc)
    act = product * scale + bias
    halves = ([slice(0, 256), slice(256, k)] if p["split"]
              else [slice(0, k)])
    m = torch.stack([torch.amax(act[..., h], -1) for h in halves]).amax(0)
    e = torch.exp(act - m[..., None])
    if p["split"]:
        s = sum(torch.sum(e[..., h], -1) for h in halves)
    else:
        s = torch.sum(e, -1)
    pr_all = e / s[..., None]
    xb = torch.full((b, f, d), float("nan"))
    assign = torch.full((b, f, k), float("nan"))
    colsum = torch.full((b, chunks, k), float("nan"))
    for item in tvlad.live_items(nf, f).tolist():
        v, c = divmod(item, chunks)
        n = min(max(int(nf[v]), 0), f)
        f0 = c * 64
        rows = min(64, f - f0)
        xb[v, f0:f0 + rows] = _chunk_frames(x, v, f0, n)[:rows]
        pr = pr_all[v, f0:f0 + rows].clone()
        pr[max(0, n - f0):] = 0.0
        assign[v, f0:f0 + rows] = pr
        colsum[v, c] = torch.sum(pr, 0)
    a16 = _bf(assign)
    out = torch.full((b, k, d), float("nan"))
    sumsq = torch.zeros(b, p["agg_col_tiles"], k)

    tiles = [tile for blk in range(p["agg_grid"])
             for tile in tvlad.agg_walk(blk, p, b)]

    def tile_values(tile):
        v, cl, co = tile
        cl = range(cl.start, min(cl.stop, k))
        n = min(max(int(nf[v]), 0), f)
        acc = torch.zeros(len(cl), len(co))
        step = tvlad.AGG_FRAMES
        for f0 in range(0, n, step):  # the live frames' steps only
            fr = slice(f0, min(f0 + step, f))
            acc += a16[v, fr, cl.start:cl.stop].T @ xb[v, fr, co.start:co.stop]
        a_sum = torch.zeros(len(cl))
        for c in range(-(-n // 64)):
            a_sum = a_sum + colsum[v, c, cl.start:cl.stop]
        cen = centers[cl.start:cl.stop, co.start:co.stop]
        return v, cl, co, acc - a_sum[:, None] * cen

    for tile in tiles:
        v, cl, co, val = tile_values(tile)
        sumsq[v, co.start // tvlad.D_TILE, cl.start:cl.stop] = torch.sum(
            val * val, -1)
    ss = torch.zeros(b, k)
    for ct in range(p["agg_col_tiles"]):
        ss = ss + sumsq[:, ct]
    norms = torch.clamp_min(torch.sqrt(ss), tvlad.NORM_EPS)
    gnorm = torch.clamp_min(torch.sqrt(torch.sum(ss / (norms * norms), -1)),
                            tvlad.NORM_EPS)
    for tile in tiles:
        v, cl, co, val = tile_values(tile)
        out[v, cl.start:cl.stop, co.start:co.stop] = (
            val / norms[v, cl.start:cl.stop, None]) / gnorm[v]
    return out, xb, assign, colsum


VLAD_SHAPES = [(4, 70, 256, 136), (3, 300, 256, 256), (3, 130, 128, 512),
               (4, 65, 128, 264), (3, 13, 128, 8), (2, 1, 128, 64)]


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("b,f,d,k", VLAD_SHAPES)
def test_netvlad_serving_tiling_equals_the_plain_version(b, f, d, k,
                                                         x_dtype):
    args = _vlad_args(b + f + d + k, b, f, d, k, x_dtype)
    # Both assignments come from one product: two torch.matmul calls on
    # the same operands need not sum in the same order (MKL may split a
    # product differently from one call to the next), and the bit
    # equality below is about the softmax and the masking.
    product = cluster_product(args[0], args[2])
    out, xb, assign, colsum = tiled_serving(*args, product=product)
    want = tvlad.netvlad_aggregate_plain(*args)
    if b > 2:
        assert torch.all(out[1] == 0)  # num_frames = 0
    pa = tvlad.netvlad_softmax_plain(product, args[1], args[3], args[4])
    x_plain, _ = tvlad.netvlad_assign_plain(*args[:5])
    assert torch.equal(x_plain, rounded_frames(args[0]))
    live = torch.arange(f)[None, :] < args[1][:, None]
    if k <= 256:
        assert torch.equal(_bf(assign[live]), _bf(pa[live]))
        _close(out, want)
    else:
        ulp = torch.finfo(torch.float32).eps * pa[live].abs()
        assert torch.all((assign[live] - pa[live]).abs() <= 4 * ulp + 1e-30)
    # The output on the tiling's own assignment and column sums.
    a16 = torch.where(live[..., None], _bf(assign), 0.0)
    xs = torch.where(live[..., None], xb, 0.0)
    tail = tvlad.netvlad_residuals_plain(a16, colsum.nan_to_num().sum(1),
                                         xs, args[5])
    _close(out, tail)
    # The chunks' column sums add up to the plain a_sum.
    _close(colsum.nan_to_num().sum(1), pa.sum(1), rel=1e-6)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.uint8])
def test_netvlad_serving_tiling_ignores_frames_past_num_frames(x_dtype):
    """Loud frames past num_frames give the same bits as zeros there; a
    video with no frame gives an exact zero descriptor, one with a single
    frame a unit one; a cluster no frame is assigned to is a zero row."""
    x, nf, wc, scale, bias, centers = _vlad_args(3, 5, 70, 128, 136,
                                                 x_dtype)
    bias[7] = -1e4
    past = torch.arange(70)[None, :] >= nf[:, None]
    loud = 255 if x_dtype == torch.uint8 else 1e4
    clean = x.masked_fill(past[..., None], 0)
    noisy = torch.where(past[..., None], torch.tensor(loud, dtype=x.dtype), x)
    got = tiled_serving(noisy, nf, wc, scale, bias, centers)[0]
    assert torch.equal(got, tiled_serving(clean, nf, wc, scale, bias,
                                          centers)[0])
    assert torch.all(got[1] == 0) and torch.all(got[:, 7] == 0)
    norm = torch.linalg.vector_norm(got[2].flatten())
    assert abs(norm.item() - 1.0) < 1e-5 and nf[2] == 1
    _close(got, tvlad.netvlad_aggregate_plain(noisy, nf, wc, scale, bias,
                                              centers))


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.uint8])
def test_netvlad_serving_tiling_matches_jax_kernel(x_dtype):
    """The decomposition against JAX's netvlad_aggregate (its Pallas
    kernel in interpret mode) at tests/test_torch_netvlad.py's shape,
    padded as the wrapper pads (D to 128, K to 8)."""
    rng = np.random.default_rng(11)
    b, f, d, k = 4, 13, 32, 8
    if x_dtype == torch.uint8:
        x = rng.integers(0, 256, size=(b, f, d), dtype=np.uint8)
    else:
        x = rng.normal(size=(b, f, d)).astype(np.float32)
    nf = np.array([13, 1, 0, 7], np.int32)
    wc = (rng.normal(size=(d, k)) / np.sqrt(d)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = (0.3 * rng.normal(size=k)).astype(np.float32)
    centers = (rng.normal(size=(k, d)) / np.sqrt(d)).astype(np.float32)
    frames = torch.from_numpy(x).to(torch.float32)
    if x_dtype == torch.uint8:
        frames = frames * DEQUANT_SCALE + DEQUANT_BIAS
    want = np.asarray(jax_netvlad(
        jnp.asarray(frames.numpy()), jnp.asarray(nf), jnp.asarray(wc),
        jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(centers),
        interpret=True), np.float64)
    padded = tvlad.pad_operands(
        torch.from_numpy(x), torch.from_numpy(wc).to(torch.bfloat16),
        torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(centers))
    xp, wp, sp, bp, cp = padded
    got = tiled_serving(xp, torch.from_numpy(nf), wp, sp, bp, cp)[0]
    got = got[:, :k, :d].double().numpy()
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * np.max(np.abs(want)) + 1e-7, err
    assert np.all(got[2] == 0)


# ---------------------------------------------------------------------------
# int8 DBoF: plan, walk, and the tiling in plain PyTorch
# ---------------------------------------------------------------------------

INT8_PLANS = [(2048, 30, 1152, 8192), (7, 5, 64, 200), (9, 32, 96, 136),
              (3, 32, 128, 48), (1, 1, 16, 1), (5, 30, 1152, 8192)]


@pytest.mark.parametrize("b,s,d,k", INT8_PLANS)
def test_int8_plan_fits_the_card(b, s, d, k):
    p = tdbof.plan_int8(b, d, k)
    assert p["smem"] <= SMEM_LIMIT
    _check_box(p["box_x"], 1)
    _check_box(p["box_w"], 1)
    assert p["box_x"][1] * p["box_x"][2] == p["rows"] == 128
    assert p["box_w"][1] == p["chain"] == 256  # one m64n256k32 a warpgroup
    assert p["stage_bytes"] % 1024 == 0 and p["a_bytes"] % 1024 == 0
    assert p["stage_bytes"] == 48 * 1024
    assert p["k_steps"] * tdbof.INT8_DEPTH >= d and d % 16 == 0
    assert p["grid"] == min(p["tiles"], tdbof.SMS)
    seen = np.zeros((p["row_tiles"], p["cluster_tiles"]), np.int32)
    for blk in range(p["grid"]):
        for t in range(blk, p["tiles"], p["grid"]):
            videos, clusters = tdbof.tile_of(t, p)
            seen[videos.start // 4, clusters.start // 256] += 1
    assert (seen == 1).all()


def tiled_int8(x, w8, a_col, b_col):
    """csrc/dbof_int8.cu in plain PyTorch, exact in int64: per launch of
    32 frames, per tile of 4 videos x 256 clusters, the raw bytes against
    w8 in 128-deep steps (acc_u = x @ w8), the sums in the sign of a_col
    (a max of -acc where a_col < 0, its sign bit), rows s >= S at
    INT_MIN, the max over the video's 32 rows, the sign back, minus 128
    colsum(w8), one conversion to f32, the affine, the clamp at 0; the
    launches' outputs joined by an elementwise max."""
    b, s_all, d = x.shape
    k = w8.shape[1]
    w64 = w8.to(torch.int64)
    colsum8 = torch.sum(w64, 0)
    neg = torch.signbit(a_col)
    out = None
    for s0 in range(0, s_all, 32):
        xs = x[:, s0:s0 + 32]
        s = xs.shape[1]
        p = tdbof.plan_int8(b, d, k)
        part = torch.full((b, k), float("nan"))
        for t in range(p["tiles"]):
            videos, clusters = tdbof.tile_of(t, p)
            vs = slice(videos.start, min(videos.stop, b))
            cs = slice(clusters.start, min(clusters.stop, k))
            rows = torch.zeros(vs.stop - vs.start, 32, d, dtype=torch.int64)
            rows[:, :s] = xs[vs].to(torch.int64)  # zero bytes past S
            acc = torch.zeros(vs.stop - vs.start, 32, cs.stop - cs.start,
                              dtype=torch.int64)
            for d0 in range(0, d, tdbof.INT8_DEPTH):
                acc += rows[:, :, d0:d0 + tdbof.INT8_DEPTH] @ w64[
                    d0:d0 + tdbof.INT8_DEPTH, cs]
            signed = torch.where(neg[cs], -acc, acc)
            signed[:, s:] = INT_MIN  # a zero row is a real value: masked
            best = torch.amax(signed, 1)
            best = torch.where(neg[cs], -best, best) - 128 * colsum8[cs]
            assert best.abs().max() < 2 ** 31
            y = best.to(torch.float32) * a_col[cs] + b_col[cs]
            part[vs, cs] = torch.relu(y)
        out = part if out is None else torch.maximum(out, part)
    return out


def _int8_args(seed, b, s, d, k, signs=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (b, s, d), generator=g, dtype=torch.uint8)
    w = torch.randn(d, k, generator=g) * d ** -0.5
    s_in = DEQUANT_SCALE * (0.5 + torch.rand(d, generator=g))
    b_in = DEQUANT_BIAS * s_in + 0.1 * torch.randn(d, generator=g)
    s_act = 0.5 + torch.rand(k, generator=g)
    if signs:  # negative, zero and negative-zero a_col columns
        s_act[::3] *= -1.0
        s_act[1::7] = 0.0
        s_act[2::11] = -0.0
    b_act = 0.1 * torch.randn(k, generator=g)
    return x, tdbof.int8_serving_constants(w, s_in, b_in, s_act, b_act)


@pytest.mark.parametrize("signs", [False, True], ids=["a_pos", "a_signed"])
@pytest.mark.parametrize("b,s,d,k", [(7, 5, 64, 200), (5, 30, 1152, 300),
                                     (3, 64, 128, 48), (9, 32, 96, 136),
                                     (2, 1, 16, 7)])
def test_int8_tiling_is_bit_for_bit_the_plain_version(b, s, d, k, signs):
    x, (w8, a_col, b_col) = _int8_args(b + s + d + k, b, s, d, k, signs)
    if signs:
        assert torch.any(a_col < 0) and torch.any(a_col == 0)
    got = tiled_int8(x, w8, a_col, b_col)
    want = tdbof.dbof_cluster_maxpool_int8_plain(x, w8, a_col, b_col)
    assert torch.equal(got, want)


def test_int8_tiling_padded_row_hazard():
    """Every live row negative before the ReLU and b_col = 3: the padded
    rows (bytes 0, a real and larger value here) must not enter the max,
    for a_col > 0 and a_col < 0 alike."""
    x, (w8, a_col, _) = _int8_args(5, 6, 30, 64, 64, signs=False)
    x = torch.clamp(x, min=200)
    b_col = torch.full_like(a_col, 3.0)
    for w, a in ((-w8.abs(), torch.ones_like(a_col)),
                 (w8.abs(), -torch.ones_like(a_col))):
        want = tdbof.dbof_cluster_maxpool_int8_plain(x, w, a, b_col)
        assert torch.all(want == 0)
        assert torch.equal(tiled_int8(x, w, a, b_col), want)


def test_int8_tiling_matches_jax_kernel():
    """The decomposition against JAX's dbof_cluster_maxpool_int8 (its
    Pallas kernel in interpret mode) on raw frames and the f32 kernel,
    with a_col of both signs."""
    rng = np.random.default_rng(3)
    b, s, d, k = 4, 9, 64, 48
    x = rng.integers(0, 256, size=(b, s, d), dtype=np.uint8)
    w = (rng.normal(size=(d, k)) / np.sqrt(d)).astype(np.float32)
    s_in = (DEQUANT_SCALE * rng.uniform(0.5, 1.5, d)).astype(np.float32)
    b_in = (DEQUANT_BIAS * s_in + 0.1 * rng.normal(size=d)).astype(np.float32)
    s_act = (rng.uniform(0.5, 1.5, k) * np.where(np.arange(k) % 3, 1, -1)
             ).astype(np.float32)
    b_act = (0.1 * rng.normal(size=k)).astype(np.float32)
    args = (x, w, s_in, b_in, s_act, b_act)
    want = np.asarray(jax_int8(*map(jnp.asarray, args), interpret=True,
                               block_b=2, block_k=k), np.float64)
    consts = tdbof.int8_serving_constants(*map(torch.from_numpy, args[1:]))
    got = tiled_int8(torch.from_numpy(x), *consts).double().numpy()
    err = np.max(np.abs(got - want))
    assert err <= 1e-5 * np.max(np.abs(want)) + 1e-7, err
