"""The tile plans of the NeXtVLAD kernels (csrc/nextvlad.cu and
csrc/nextvlad_train.cu on csrc/hopper_gemm.cuh's TMA + wgmma mainloop)
on the CPU: the packed row layout (kernels/nextvlad.py :: packed_layout),
what each launch asks of the card, the persistent walks, and both
kernels decomposed in plain PyTorch launch by launch over the packed and
padded rows, held against the plain versions and against JAX's
nextvlad_aggregate and the VJP of nextvlad_aggregate_train in interpret
mode.

Tolerances. The forward's decomposition against forward_plain within f32
summation order, 1e-5 * max|ref| + 1e-6: its frames and weights are
small multiples of powers of two, so that xe and the logits are exact
f32 sums in any order and both round the same values to bf16; only the
order of the aggregation's, a_sum's and the norm's f32 sums differs. The
backward's decomposition step by step against plain_backward_steps in
the same bound: each tiled product or epilogue is fed the plain steps'
rounded streams (bf16(dv), bf16(d_act), bf16(d_pre), bf16(d_xe)), so
only f32 order differs (a stream rounded from sums in another order
would move a value by a bf16 step now and then). Hazards exactly (frames
past num_frames never read, pad rows exact zeros, num_frames = 0 gives
zeros). Against JAX's kernels in interpret mode, the bound of
tests/test_torch_nextvlad*.py (3e-3 * max(1, max|ref|)). The compiled
kernels' plans are held to these in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.nextvlad import nextvlad_aggregate as jax_nextvlad
from yt8m_tpu.kernels.nextvlad_train import (
    nextvlad_aggregate_train as jax_train,
)
from yt8m_tpu.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels import nextvlad as tnv
from yt8m_tpu_torch.kernels import nextvlad_train as tnt

SMEM_LIMIT = 232448   # shared memory a block can use on an H100
BOX_LIMIT = 256       # TMA's largest box dimension
SWIZZLE_ROW = 128     # bytes: the 128-byte swizzle's row, a box's inner extent
JAX_BF16 = 3e-3       # tests/test_torch_nextvlad*.py's bound
NAMES = ("dWe", "dWa", "dab", "dWc", "dcenters")

# (B, F, D, lambda, G, K): the serving and training shapes, then
# chip_smoke.py's edges (P = 8, 128, 2, 144, 251; K = 12, 96, 128, 130,
# 256; one group and sixteen; D = 1004).
SHAPES = [(512, 300, 1152, 2, 8, 128), (256, 300, 1152, 2, 8, 128),
          (3, 10, 16, 2, 4, 12), (4, 70, 64, 2, 1, 128),
          (3, 13, 32, 1, 16, 96), (5, 300, 96, 3, 2, 130),
          (2, 130, 1004, 2, 8, 256), (3, 9, 64, 5, 1, 40)]


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


def _up(x, m):
    return -(-x // m) * m


def _close(got, want, rel=1e-5):
    err = (got.double() - want.double()).abs().max().item()
    assert err <= rel * want.abs().max().item() + 1e-6, err


def _check_box(box, elem_bytes=2):
    assert all(1 <= n <= BOX_LIMIT for n in box), box
    assert box[0] * elem_bytes == SWIZZLE_ROW, box


def _num_frames(seed, b, f):
    g = torch.Generator().manual_seed(seed)
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 0, 1], dtype=torch.int32)[: min(b, 3)]
    return nf


# ---------------------------------------------------------------------------
# The plans.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,f,d,lam,g,k", SHAPES)
def test_nextvlad_plan_fits_the_card(b, f, d, lam, g, k):
    p = tnv.plan(_num_frames(b + f, b, f), f, d, lam * d, g, k)
    n = p["dims"]
    for name in ("expand", "cluster", "aggregate", "dassign", "dxg", "dxe",
                 "wgrad_ext", "wgrad_we"):
        launch = p[name]
        assert launch["smem"] <= SMEM_LIMIT, name
        assert launch["stage"] % 1024 == 0, name  # the swizzle's atom
        for key, box in launch.items():
            if key.startswith("box"):
                _check_box(box)
        for stride in launch["strides"]:
            assert stride % 16 == 0, (name, launch["strides"])
        assert launch["grid"] <= tnv.SMS
    assert p["cluster"]["cols"] <= 256 and p["cluster"]["cols"] % 64 == 0
    assert p["dassign"]["box_v"][1] == n["Kp"] <= BOX_LIMIT
    assert n["Kp"] % 64 == 0 and n["Pp"] % 8 == 0 and n["D8"] % 8 == 0
    assert n["Kx"] % 8 == 0
    assert p["aggregate"]["norm_pass"] == (n["Pp"] > tnv.WIDE_COLS)


@pytest.mark.parametrize("b,f,d,lam,g,k", SHAPES)
def test_nextvlad_packed_layout(b, f, d, lam, g, k):
    """Each run is the video's live frames then zero rows to a multiple
    of R; its R G (frame, group) rows are whole 64-deep stages; every
    8-row block is one video's; info says which rows are live."""
    nf = _num_frames(b + f, b, f)
    p = tnv.plan(nf, f, d, lam * d, g, k)
    r = p["R"]
    assert r % 8 == 0 and (r * g) % 64 == 0
    live = nf.clamp(0, f)
    assert torch.equal(p["runs"], (live.long() + r - 1) // r * r)
    assert int(p["poff"][0]) == 0 and p["total"] == int(p["runs"].sum())
    info = tnv.packed_info(nf, f, g)
    assert info.numel() == _up(p["total"], tnv.TILE) <= p["cap"]
    for v in range(b):
        run = info[int(p["poff"][v]):int(p["poff"][v + 1])]
        assert torch.equal(run[:int(live[v])], torch.full_like(run[:int(live[v])], v))
        assert torch.all(run[int(live[v]):] == -1 - v)
    assert torch.all(info[p["total"]:] == -1 - b)
    video = torch.where(info >= 0, info, -1 - info).reshape(-1, 8)
    assert torch.all(video == video[:, :1])
    # The longest videos first.
    assert torch.all(live[p["order"].long()].diff() <= 0)


@pytest.mark.parametrize("b,f,d,lam,g,k", SHAPES)
def test_nextvlad_walks_cover_every_tile_once(b, f, d, lam, g, k):
    """The persistent blocks' walks (tile blockIdx.x + i * grid) visit
    each tile once: the row products' (128 packed rows, 256 columns) and
    the cluster product's (128 rows, a group tile) over the packed total;
    the aggregation's (video, 128 clusters, 288 columns) over every video;
    the backward's per-video tiles over each video's (frame, group) rows;
    the weight gradients' splits over the packed rows once."""
    nf = _num_frames(b + f + 1, b, f)
    p = tnv.plan(nf, f, d, lam * d, g, k)
    n = p["dims"]
    for name, cols, per in (("expand", n["GP"], tnv.COLS),
                            ("cluster", n["G"], p["cluster"]["groups"])):
        seen = np.zeros((p["row_tiles"], -(-cols // per)), np.int32)
        for blk in range(p[name]["grid"]):
            for t in range(blk, p[name]["tiles"], p[name]["grid"]):
                seen[t // seen.shape[1], t % seen.shape[1]] += 1
        assert (seen == 1).all(), name
        assert p["row_tiles"] * tnv.TILE >= p["total"]
    agg = p["aggregate"]
    seen = np.zeros((b, agg["cluster_tiles"], agg["col_tiles"]), np.int32)
    per_video = agg["cluster_tiles"] * agg["col_tiles"]
    for blk in range(agg["grid"]):
        for t in range(blk, agg["tiles"], agg["grid"]):
            v = int(p["order"][t // per_video])
            seen[v, (t // agg["col_tiles"]) % agg["cluster_tiles"],
                 t % agg["col_tiles"]] += 1
    assert (seen == 1).all()
    assert agg["cluster_tiles"] * tnv.TILE >= n["Kp"]
    assert agg["col_tiles"] * tnv.WIDE_COLS >= n["Pp"]
    assert all(s * tnv.DEPTH == int(r) * g
               for s, r in zip(agg["steps"], p["runs"]))
    toff = tnt.video_tiles(p["poff"], g)
    covered = torch.zeros(p["total"] * g, dtype=torch.int32)
    for t in range(int(toff[-1])):
        v = int(torch.searchsorted(toff, torch.tensor(t, dtype=torch.int32),
                                   right=True)) - 1
        r0 = int(p["poff"][v]) * g + (t - int(toff[v])) * tnv.TILE
        covered[r0:min(r0 + tnv.TILE, int(p["poff"][v + 1]) * g)] += 1
    assert torch.all(covered == 1)
    assert int(toff[-1]) == p["dassign"]["tiles"] == sum(p["video_tiles"])
    rows = torch.zeros(_up(p["total"], tnv.DEPTH), dtype=torch.int32)
    for part in tnv.split_rows(p["total"]):
        assert part.start % tnv.DEPTH == 0 and len(part) % tnv.DEPTH == 0
        rows[part.start:part.stop] += 1
    assert torch.all(rows == 1)


# ---------------------------------------------------------------------------
# The forward decomposed.
# ---------------------------------------------------------------------------


def _exact_args(seed, b, f, d, lam, g, k, nf=None):
    """f32 frames in quarters of [-1, 1] and weights in sixteenths of
    [-1/2, 1/2] (ab in eighths): xe and the logits are exact f32 sums."""
    gen = torch.Generator().manual_seed(seed)
    de = lam * d
    p = de // g
    x = torch.randint(-4, 5, (b, f, d), generator=gen).float() / 4
    w = [torch.randint(-8, 9, shape, generator=gen).float() / 16
         for shape in ((d, de), (de, g))]
    w.append(torch.randint(-4, 5, (g,), generator=gen).float() / 8)
    w.append(torch.randint(-8, 9, (de, g * k), generator=gen).float() / 16)
    w.append(torch.randn(k, p, generator=gen) * de ** -0.5)
    if nf is None:
        nf = _num_frames(seed, b, f)
    return [x, nf, *w]


def _pack(t, nf, p):
    """[B, F, w] -> the packed rows [cap, w]: each video's live rows at
    poff, zeros for the pad rows and up to the last tile's end, NaN
    past it (never read)."""
    b, f = t.shape[:2]
    out = torch.full((p["cap"], t.shape[2]), float("nan"), dtype=t.dtype)
    out[:_up(p["total"], tnv.TILE)] = 0
    for v in range(b):
        n = min(max(int(nf[v]), 0), f)
        r0 = int(p["poff"][v])
        out[r0:r0 + n] = t[v, :n]
    return out


def tiled_forward(frames, nf, we, wa, ab, wc, centers, g):
    """The forward's launches in plain PyTorch over the packed rows.
    Launch 0: bf16 frames into the runs. Launch 1, tile by tile (128 rows
    x 256 columns): xe in 64-deep stages, rounded once. Launch 2, a (row
    tile, group tile) at a time: the logits and the attention dots in
    64-deep stages, alpha and the softmax of each (row, group), the
    assignment masked to the live rows, its column sums over each 8-row
    block, then over a 64-row half tile's blocks a video's run at a time
    (one partial a (video, half tile)). Launch 3, a (video, 128 clusters,
    288 columns) tile at a time: a_sum from the partials slot by slot,
    assign^T @ xg over the run's (frame, group) rows in 64-deep stages,
    the centers term, and the norm by the row's reciprocal length.
    Returns (out, a_sum, the packed scratch)."""
    b, f, d = frames.shape
    k = wc.shape[1] // g
    lay = tnv.kernel_layout(we, wa, ab, wc, centers, g)
    n = lay["dims"]
    kp, pp, gp, p_ = n["Kp"], n["Pp"], n["GP"], n["P"]
    p = tnv.plan(nf, f, d, we.shape[1], g, k)
    info = tnv.packed_info(nf, f, g)
    end = info.numel()
    x = tnv.dequantized(frames)
    x = torch.nn.functional.pad(x, (0, n["D8"] - d))
    xb = _pack(_bf(x), nf, p)
    wef, wcf, waf = (lay[name].float() for name in ("we", "wc", "wa"))

    xe = torch.full((p["cap"], gp), float("nan"))
    for r0 in range(0, end, tnv.TILE):
        for c0 in range(0, gp, tnv.COLS):
            acc = torch.zeros(tnv.TILE, min(tnv.COLS, gp - c0))
            for d0 in range(0, n["D8"], tnv.DEPTH):
                acc += (xb[r0:r0 + tnv.TILE, d0:d0 + tnv.DEPTH]
                        @ wef[d0:d0 + tnv.DEPTH, c0:c0 + tnv.COLS])
            xe[r0:r0 + tnv.TILE, c0:c0 + tnv.COLS] = _bf(acc)

    gt = p["cluster"]["groups"]
    assign = torch.full((p["cap"], g * kp), float("nan"))
    sm = torch.full((p["cap"], g * kp), float("nan"))
    part = torch.full((b, p["J"], g, kp), float("nan"))
    for r0 in range(0, end, tnv.TILE):
        rows = slice(r0, r0 + tnv.TILE)
        live = info[rows] >= 0
        for g0 in range(0, g, gt):
            groups = range(g0, min(g0 + gt, g))
            logits = torch.zeros(tnv.TILE, len(groups) * kp)
            dots = torch.zeros(tnv.TILE, len(groups))
            cols = slice(g0 * kp, (g0 + len(groups)) * kp)
            for d0 in range(0, gp, tnv.DEPTH):
                xs = xe[rows, d0:d0 + tnv.DEPTH]
                logits += xs @ wcf[d0:d0 + tnv.DEPTH, cols]
                dots += xs @ waf[g0:g0 + len(groups), d0:d0 + tnv.DEPTH].T
            alpha = torch.sigmoid(dots + lay["ab"][g0:g0 + len(groups)])
            for i, gg in enumerate(groups):
                act = logits[:, i * kp:i * kp + k]
                e = torch.exp(act - torch.amax(act, dim=-1, keepdim=True))
                s = e / torch.sum(e, dim=-1, keepdim=True)
                s = torch.where(live[:, None], s, 0.0)
                a = s * alpha[:, i:i + 1]
                at = torch.zeros(tnv.TILE, kp)
                st = torch.zeros(tnv.TILE, kp)
                at[:, :k], st[:, :k] = a, s
                assign[rows, gg * kp:(gg + 1) * kp] = _bf(at)
                sm[rows, gg * kp:(gg + 1) * kp] = st
                blocks = at.reshape(tnv.TILE // 8, 8, kp).sum(1)
                for half in range(2):
                    r_half = r0 + 64 * half
                    cur, tsum = None, None
                    for bi in range(8):
                        v = int(info[r_half + 8 * bi])
                        v = v if v >= 0 else -1 - v
                        if v != cur:
                            if cur is not None and cur < b:
                                part[cur, r_half // 64 - int(p["poff"][cur]) // 64,
                                     gg] = tsum
                            cur, tsum = v, torch.zeros(kp)
                        tsum = tsum + blocks[8 * half + bi]
                    if cur < b:
                        part[cur, r_half // 64 - int(p["poff"][cur]) // 64,
                             gg] = tsum

    out = torch.full((b, k, p_), float("nan"))
    a_sum = torch.zeros(b, kp)
    xg = xe.reshape(-1, pp)
    ag = assign.reshape(-1, kp)
    for v in range(b):
        r0, r1 = int(p["poff"][v]), int(p["poff"][v + 1])
        slots = (r1 - 1) // 64 - r0 // 64 + 1 if r1 > r0 else 0
        tsum = torch.zeros(kp)
        for j in range(slots):
            for gg in range(g):
                tsum = tsum + part[v, j, gg]
        a_sum[v] = tsum
        acc = torch.zeros(kp, pp)
        for s0 in range(r0 * g, r1 * g, tnv.DEPTH):
            acc += ag[s0:s0 + tnv.DEPTH].T @ xg[s0:s0 + tnv.DEPTH]
        vlad = acc[:k, :p_] - tsum[:k, None] * lay["centers"]
        ss = torch.sum(vlad * vlad, dim=1, keepdim=True)
        out[v] = vlad * (1.0 / torch.sqrt(torch.clamp_min(ss,
                                                          tnv.NORM_EPS_SQ)))
    scratch = {"xb": xb, "xe": xe, "assign": assign, "sm": sm, "info": info,
               "poff": p["poff"], "plan": p, "layout": lay}
    return out, a_sum[:, :k], scratch


@pytest.mark.parametrize("b,f,d,lam,g,k", [(3, 10, 16, 2, 4, 12),
                                           (4, 70, 64, 2, 1, 128),
                                           (3, 13, 32, 1, 16, 96),
                                           (5, 30, 24, 3, 2, 130),
                                           (2, 17, 40, 2, 8, 256),
                                           (3, 9, 64, 5, 1, 40)])
def test_nextvlad_forward_tiling_equals_the_plain_version(b, f, d, lam, g, k):
    args = _exact_args(b + f + d + k, b, f, d, lam, g, k)
    want = tnv.forward_plain(*args, g)
    out, a_sum, s = tiled_forward(*args, g)
    _close(out, want["out"])
    _close(a_sum, want["a_sum"])
    # The rounded streams are the same values (exact sums): bit for bit.
    n = s["layout"]["dims"]
    live = (torch.arange(f)[None, :] < args[1][:, None]).reshape(-1)
    packed = s["info"] >= 0
    xe = s["xe"][:s["info"].numel()][packed].reshape(-1, g, n["Pp"])
    assert torch.equal(xe[..., :n["P"]].reshape(-1, g * n["P"]),
                       want["xe"].reshape(b * f, -1)[live])
    asg = s["assign"][:s["info"].numel()][packed].reshape(-1, g, n["Kp"])
    assert torch.equal(asg[..., :k], _bf(want["assign"].reshape(
        b * f, g, k)[live]))


def test_nextvlad_forward_tiling_ignores_frames_past_num_frames_exactly():
    """Frames past num_frames (1e4) give the bits of zeros there; every
    pad row of the packed streams is an exact zero; num_frames = 0
    (video 1) gives zeros."""
    b, f, d, lam, g, k = 4, 37, 32, 2, 4, 40
    x, nf, *w = _exact_args(9, b, f, d, lam, g, k)
    past = torch.arange(f)[None, :] >= nf[:, None]
    clean = x.masked_fill(past[..., None], 0.0)
    loud = torch.where(past[..., None], 1e4, x)
    a_out, a_sum, a = tiled_forward(clean, nf, *w, g)
    c_out, c_sum, c = tiled_forward(loud, nf, *w, g)
    assert torch.equal(a_out, c_out) and torch.equal(a_sum, c_sum)
    end = a["info"].numel()
    pad = a["info"] < 0
    for name in ("xb", "xe", "assign", "sm"):
        assert torch.equal(a[name][:end], c[name][:end]), name
        assert torch.all(c[name][:end][pad] == 0), name
    assert torch.all(c_out[1] == 0) and torch.all(c_sum[1] == 0)


# ---------------------------------------------------------------------------
# The backward decomposed.
# ---------------------------------------------------------------------------


def tiled_backward(args, g, dy):
    """The backward's launches in plain PyTorch over the forward's packed
    rows, step by step against plain_backward_steps: (the tiled values,
    the plain steps). Launch d_assign, a (video, 128 of its (frame,
    group) rows) tile at a time: xg @ bf16(dv)^T in 64-deep stages, minus
    cdot, and the VJPs over each row's clusters. Launch d_xg, the same
    tiles: bf16(assign) @ bf16(dv) in 64-deep stages of clusters, 288
    columns at a time. Launch d_xe, tile by tile (128 packed rows x 256
    columns): [bf16(d_act) | bf16(d_pre)] @ wext in 64-deep stages plus
    d_xg, zero on the pad rows. The weight gradients: one partial a split
    of packed rows (64-deep stages), the partials added in split order;
    dab over the packed rows in order."""
    x, nf, *w = args
    b, f, d = x.shape
    k = w[3].shape[1] // g
    fw = tnv.forward_plain(*args, g)
    st = tnt.plain_backward_steps(*args, dy, g, fw=fw)
    lay = tnv.kernel_layout(*w, g, training=True)
    n = lay["dims"]
    kp, pp, gp, kx, p_ = n["Kp"], n["Pp"], n["GP"], n["Kx"], n["P"]
    p = tnv.plan(nf, f, d, w[0].shape[1], g, k)
    info = tnv.packed_info(nf, f, g)
    end = info.numel()

    def padded(t, width, inner):
        """[B, F, G, inner] -> [B, F, G * width], zeros past inner."""
        t = t.reshape(b, f, g, inner)
        return torch.nn.functional.pad(t, (0, width - inner)).reshape(
            b, f, g * width)

    xe = _pack(padded(fw["xe"], pp, p_), nf, p)
    sm = _pack(padded(torch.where(fw["live"][..., None, None], fw["sm"], 0.0),
                      kp, k), nf, p)
    alpha = _pack(fw["alpha"], nf, p)
    asg = _pack(padded(_bf(fw["assign"]), kp, k), nf, p)
    dvb = torch.zeros(b, kp, pp)
    dvb[:, :k, :p_] = st["dvb"]
    cdot = torch.zeros(b, kp)
    cdot[:, :k] = st["cdot"]
    toff = tnt.video_tiles(p["poff"], g)

    d_assign = torch.full((p["cap"] * g, kp), float("nan"))
    d_act = torch.full((p["cap"] * g, kp), float("nan"))
    d_pre = torch.full((p["cap"] * g,), float("nan"))
    d_xg = torch.full((p["cap"] * g, pp), float("nan"))
    xg, smg, ag = xe.reshape(-1, pp), sm.reshape(-1, kp), asg.reshape(-1, kp)
    alg = alpha.reshape(-1)
    for t in range(int(toff[-1])):
        v = int(torch.searchsorted(toff, torch.tensor(t, dtype=torch.int32),
                                   right=True)) - 1
        run_end = int(p["poff"][v + 1]) * g
        r0 = int(p["poff"][v]) * g + (t - int(toff[v])) * tnv.TILE
        r1 = min(r0 + tnv.TILE, run_end)
        acc = torch.zeros(r1 - r0, kp)
        for d0 in range(0, pp, tnv.DEPTH):
            acc += xg[r0:r1, d0:d0 + tnv.DEPTH] @ dvb[v, :, d0:d0 + tnv.DEPTH].T
        da = acc - cdot[v]
        d_assign[r0:r1] = da
        live = (info[torch.arange(r0, r1) // g] >= 0)[:, None]
        s, al = smg[r0:r1, :k], alg[r0:r1, None]
        dsm = da[:, :k] * al
        dal = torch.sum(da[:, :k] * s, dim=1, keepdim=True)
        tt = torch.sum(s * dsm, dim=1, keepdim=True)
        d_act[r0:r1] = 0.0
        d_act[r0:r1, :k] = torch.where(live, s * (dsm - tt), 0.0)
        d_pre[r0:r1] = torch.where(live, dal * al * (1.0 - al), 0.0)[:, 0]
        for c0 in range(0, pp, tnv.WIDE_COLS):
            acc = torch.zeros(r1 - r0, min(tnv.WIDE_COLS, pp - c0))
            for k0 in range(0, kp, tnv.DEPTH):
                acc += (ag[r0:r1, k0:k0 + tnv.DEPTH]
                        @ dvb[v, k0:k0 + tnv.DEPTH, c0:c0 + tnv.WIDE_COLS])
            d_xg[r0:r1, c0:c0 + tnv.WIDE_COLS] = acc

    # [bf16(d_act) | bf16(d_pre)] of the plain steps, packed.
    ext = torch.zeros(b, f, kx)
    ext[..., :g * kp] = padded(_bf(st["d_act"]), kp, k)
    ext[..., g * kp:g * kp + g] = _bf(st["d_pre"])
    ext = _pack(ext, nf, p)
    wext = lay["wext"].float()
    d_xe = torch.full((p["cap"], gp), float("nan"))
    dxg = _pack(padded(st["d_xg"].reshape(b, f, g, p_), pp, p_), nf, p)
    for r0 in range(0, end, tnv.TILE):
        live = (info[r0:r0 + tnv.TILE] >= 0)[:, None]
        for c0 in range(0, gp, tnv.COLS):
            acc = torch.zeros(tnv.TILE, min(tnv.COLS, gp - c0))
            for k0 in range(0, kx, tnv.DEPTH):
                acc += (ext[r0:r0 + tnv.TILE, k0:k0 + tnv.DEPTH]
                        @ wext[k0:k0 + tnv.DEPTH, c0:c0 + tnv.COLS])
            d_xe[r0:r0 + tnv.TILE, c0:c0 + tnv.COLS] = torch.where(
                live, dxg[r0:r0 + tnv.TILE, c0:c0 + tnv.COLS] + acc, 0.0)

    dxe = _pack(padded(_bf(st["d_xe"]).reshape(b, f, g, p_), pp, p_),
                nf, p)
    xb = _pack(torch.nn.functional.pad(_bf(fw["x"]), (0, n["D8"] - d)), nf, p)

    def split_k(a, c):
        total = torch.zeros(a.shape[1], c.shape[1])
        for rows in tnv.split_rows(p["total"]):
            acc = torch.zeros_like(total)
            for r in range(rows.start, rows.stop, tnv.DEPTH):
                acc += a[r:r + tnv.DEPTH].T @ c[r:r + tnv.DEPTH]
            total = total + acc
        return total

    dwext = split_k(xe, ext)
    dwe = split_k(xb, dxe)
    dpre_packed = d_pre.reshape(-1, g)[:p["total"]]
    dab = torch.zeros(g)
    for r in range(p["total"]):
        dab = dab + dpre_packed[r]
    tiled = {"d_assign": d_assign, "d_act": d_act, "d_pre": d_pre,
             "d_xg": d_xg, "d_xe": d_xe, "ext": ext, "info": info,
             "total": p["total"],
             "grads": tnt.weight_grads(lay, dwe, dwext, dab,
                                       st["dcenters"])}
    return tiled, st


def _live_groups(t, info, g, width):
    """Packed (frame, group) rows [cap G, width] -> the live frames'
    [L, G, width] in frame order."""
    end = info.numel()
    return t[:end * g].reshape(end, g, width)[info >= 0]


@pytest.mark.parametrize("b,f,d,lam,g,k", [(3, 10, 16, 2, 4, 12),
                                           (4, 70, 64, 2, 1, 128),
                                           (3, 13, 32, 1, 16, 96),
                                           (5, 30, 24, 3, 2, 130),
                                           (2, 17, 40, 2, 8, 256)])
def test_nextvlad_backward_tiling_equals_the_plain_steps(b, f, d, lam, g, k):
    args = _exact_args(b + f + d + k + 1, b, f, d, lam, g, k)
    p_ = lam * d // g
    dy = torch.randn(b, k, p_, generator=torch.Generator().manual_seed(b + k))
    tiled, st = tiled_backward(args, g, dy)
    info = tiled["info"]
    live = (torch.arange(f)[None, :] < args[1][:, None]).reshape(-1)
    kp = tiled["d_assign"].shape[1]
    da = _live_groups(tiled["d_assign"], info, g, kp)[..., :k]
    _close(da, st["d_assign"].reshape(b * f, g, k)[live])
    _close(_live_groups(tiled["d_act"], info, g, kp)[..., :k],
           st["d_act"].reshape(b * f, g, k)[live])
    _close(_live_groups(tiled["d_pre"][:, None], info, g, 1)[..., 0],
           st["d_pre"].reshape(b * f, g)[live])
    pp = tiled["d_xg"].shape[1]
    _close(_live_groups(tiled["d_xg"], info, g, pp)[..., :p_].reshape(
        -1, g * p_), st["d_xg"][live])
    d_xe = tiled["d_xe"][:info.numel()][info >= 0].reshape(-1, g, pp)
    _close(d_xe[..., :p_].reshape(-1, g * p_), st["d_xe"][live])
    for name, got in zip(NAMES, tiled["grads"]):
        _close(got, st[name])


def test_nextvlad_backward_tiling_ignores_frames_past_num_frames_exactly():
    """Frames past num_frames (1e4) leave every stream and gradient bit
    for bit; the pad rows of d_act, d_xg and d_xe are exact zeros; the
    videos with num_frames = 0 alone give zero gradients."""
    b, f, d, lam, g, k = 4, 21, 32, 2, 4, 40
    x, nf, *w = _exact_args(10, b, f, d, lam, g, k)
    dy = torch.randn(b, k, lam * d // g,
                     generator=torch.Generator().manual_seed(3))
    past = torch.arange(f)[None, :] >= nf[:, None]
    a, _ = tiled_backward([x.masked_fill(past[..., None], 0.0), nf, *w], g,
                          dy)
    c, _ = tiled_backward([torch.where(past[..., None], 1e4, x), nf, *w], g,
                          dy)
    end = c["total"]  # the rows past it are d_act's tail, zeroed by dv's launch
    pad = c["info"][:end] < 0
    for name in ("d_act", "d_pre", "d_xg"):
        rows = c[name][:end * g].reshape(end, -1)
        assert torch.equal(rows, a[name][:end * g].reshape(end, -1)), name
        assert torch.all(rows[pad] == 0), name
    assert torch.equal(c["d_xe"][:end], a["d_xe"][:end])
    assert torch.all(c["d_xe"][:end][pad] == 0)
    for p_, q_ in zip(a["grads"], c["grads"]):
        assert torch.equal(p_, q_)
    empty, _ = tiled_backward([x[1:2], nf[1:2].clone(), *w], g, dy[1:2])
    for grad in empty["grads"]:
        assert torch.all(grad == 0)


# ---------------------------------------------------------------------------
# Against JAX.
# ---------------------------------------------------------------------------


def test_nextvlad_tiling_matches_jax_kernel_and_vjp():
    """The decompositions against JAX's nextvlad_aggregate (its Pallas
    kernel in interpret mode) and the VJP of nextvlad_aggregate_train at
    a small shape with uint8 frames (the pack's dequantization)."""
    rng = np.random.default_rng(7)
    b, f, d, lam, g, k = 4, 10, 16, 2, 4, 12
    de = lam * d
    p = de // g
    x = rng.integers(0, 256, size=(b, f, d), dtype=np.uint8)
    nf = np.array([f, 4, 1, 0], np.int32)
    w = [rng.normal(0, 0.1, shape).astype(np.float32) for shape in
         ((d, de), (de, g), (g,), (de, g * k), (k, p))]
    dy = rng.normal(size=(b, k, p)).astype(np.float32)
    jargs = [jnp.asarray(v) for v in (x, nf)]
    want = np.asarray(jax_nextvlad(*jargs, *map(jnp.asarray, w), groups=g,
                                   interpret=True))
    _, vjp = jax.vjp(
        lambda *ws: jax_train(*jargs, *ws, g, DEQUANT_SCALE, DEQUANT_BIAS,
                              True, jnp.bfloat16),
        *map(jnp.asarray, w))
    want_grads = [np.asarray(v) for v in vjp(jnp.asarray(dy))]
    t = [torch.from_numpy(v) for v in (x, nf, *w)]
    out, _, _ = tiled_forward(*t, g)
    tiled, _ = tiled_backward(t, g, torch.from_numpy(dy))
    for got, ref in ((out, want), *zip(tiled["grads"], want_grads)):
        ref = np.asarray(ref, np.float64)
        err = np.max(np.abs(got.double().numpy() - ref))
        assert err <= JAX_BF16 * max(1.0, np.max(np.abs(ref))), err
    assert torch.all(out[3] == 0)
