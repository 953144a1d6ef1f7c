"""Fused NeXtVLAD aggregation for the serving path.

Replaces yt8m_tpu/kernels/nextvlad.py :: nextvlad_aggregate. For frames
x [B, F, D] (uint8, dequantized on the fly, or float32), the expansion
We [D, De] (De = lambda * D), the group attention Wa [De, G] and ab [G],
the clusters Wc [De, G * K] and the centers [K, P] (P = De / G), per
video:

    xe     = r(r(x) @ r(We))                     [F, De]  (f32 sums, one rounding)
    alpha  = sigmoid(xe @ r(Wa) + ab)            [F, G]   f32
    sm     = softmax_K(xe @ r(Wc))               [F, G, K] f32, per group
    assign = sm * alpha * (f < num_frames)       f32
    vlad   = sum_{f,g} r(assign) (x) xg - a_sum (x) centers   [K, P] f32 sums
    a_sum  = sum_{f,g} assign                    [K] (unrounded)
    out    = vlad / sqrt(max(sum_P vlad^2, 1e-12))            (intra-norm)

with xg[f, g] = xe[f, g*P:(g+1)*P] and `r` the cast to the compute dtype
(bf16 on the card); every product sums exact products in f32. The plain
version rounds at the same points as the JAX package's
nextvlad_aggregate_reference.

The CUDA kernel (csrc/nextvlad.cu) runs every product on the TMA +
wgmma mainloop of csrc/hopper_gemm.cuh, over a packed row layout
(`packed_layout`; csrc/nextvlad_hopper.cuh): the live frames of all
videos one after another, each video's run padded with zero rows to a
multiple of R = max(8, 64 / gcd(G, 64)) frames, so that every row tensor
is a plain [rows, width] matrix (one 2-D TMA map) and a video's (frame,
group) rows are whole 64-deep stages. Its launches: the live frames to
bf16 into the packed rows; xe = xb @ We (persistent, 128 packed rows x
256 columns a tile, rounded to bf16 once, stored by TMA); xe @ Wc with
the attention dots xe @ Wa beside it, whose epilogue takes alpha, each
(row, group)'s softmax, bf16(assign) and each video's f32 column sums of
the assignment in a fixed order; and the aggregation assign^T @ xg over
each video's (frame, group) rows, longest videos first, with the centers
term and the intra-norm in its epilogue (a norm pass only when P is
wider than 288). Frames past num_frames are neither read nor computed; a
video with num_frames = 0 gives zeros. What it materialises (B = 512, F
= 300 at the reference widths, for the packed rows only): xb 354 MB and
xe 708 MB in bf16, the bf16 assignment 315 MB at most.

Above MAX_CLUSTERS (Kp > 256, `plan`'s "wide") a group's logits no
longer fit the cluster product's registers: its Logits launch writes
them, tiles of 256 clusters, as f32 into a [cap, G * Kp] scratch that
the wrapper allocates (the training forward's sm, normalised there in
place), and a softmax launch (a block a (64-row half tile, group))
normalises each row over all K and writes bf16(assign), sm and the
column sums as the cluster product does. The card refuses only what the
index arithmetic cannot hold: cap * G * max(Pp, Kp, 256) < 2^31
(`max_clusters()`: 11,184,768 at the smallest capacity).

The kernel takes the weights in a group-major, padded bf16 layout
(`kernel_layout`, made once per model as a serving constant): P padded
to Pp (a multiple of 8) inside each group, K to Kp (a multiple of 64),
D to a multiple of 8; the pads are zeros, so padded features are exact
zeros end to end and padded clusters are left out of the softmax by the
kernel.
"""

from __future__ import annotations

import math

import torch

from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

NORM_EPS_SQ = 1e-12
MAX_CLUSTERS = 256   # Kp the cluster product's registers hold; above: "wide"
WIDE_CLUSTERS = 256  # clusters a tile of the wide Logits launch
HALF = 64            # packed rows a block of the wide softmax launch
INDEX_LIMIT = 2 ** 31  # the packed rows' widest row tensor indexes in int
TILE = 128           # packed rows a tile (csrc/nextvlad_hopper.cuh)
COLS = 256           # the row product's column tile
WIDE_COLS = 288      # the aggregation's (and d_xg's) column tile: 256 + 32
DEPTH = 64           # bf16 a 64-deep stage (128 bytes: the swizzle's row)
K_MULTIPLE = 64      # Kp: a group's clusters are whole 64-column boxes
SMS = 132            # an H100's SMs (the persistent grids' size)
WGRAD_SPLITS = 8     # row ranges of the backward's split-K weight gradients
STAGES = 4           # every product's ring
A_BYTES = TILE * DEPTH * 2   # a stage's A tile, [128 rows][64 deep] bf16
BOX_BYTES = DEPTH * 64 * 2   # a [64][64] bf16 box


def _r(t, dtype):
    return t.to(dtype).to(torch.float32)


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def dims(d: int, de: int, groups: int, k: int) -> dict:
    """The kernel's padded widths for input dim d, expansion de, G groups
    and K clusters."""
    g = groups
    p = de // g
    pp = _up(p, 8)
    kp = _up(k, K_MULTIPLE)
    return {"D": d, "D8": _up(d, 8), "G": g, "K": k, "P": p, "Pp": pp,
            "Kp": kp, "GP": g * pp, "KA": _up(g, 8),
            "Kx": g * kp + _up(g, 8)}


def max_clusters() -> int:
    """The widest K the card takes: cap * G * max(Pp, Kp, 256) < 2^31 at
    the smallest capacity (B = F = G = 1: cap = 64 + 128 rows), with Kp a
    multiple of 64; a call's own limit comes from its B, F and G."""
    cap = packed_capacity(1, 1, 1)
    return (INDEX_LIMIT - 1) // cap // K_MULTIPLE * K_MULTIPLE


def indexable(b: int, f: int, groups: int, pp: int, kp: int) -> bool:
    """Whether the packed rows' widest row tensor indexes in int."""
    return packed_capacity(b, f, groups) * groups * max(pp, kp, 256) \
        < INDEX_LIMIT


def run_frames(groups: int) -> int:
    """R: a video's run of packed rows is a multiple of R frames, so that
    its R G (frame, group) rows are whole 64-deep stages and every 8-row
    block is one video's."""
    return max(8, 64 // math.gcd(groups, 64))


def packed_capacity(b: int, f: int, groups: int) -> int:
    """Packed rows to allocate: every video's padded run, then the last
    128-row tile."""
    return b * _up(f, run_frames(groups)) + TILE


def asum_slots(f: int, groups: int) -> int:
    """J: the 64-row half tiles a video's run can touch, each one f32
    partial of its assignment's column sums."""
    return -(-_up(f, run_frames(groups)) // 64) + 1


def packed_layout(num_frames, f: int, groups: int) -> dict:
    """The packed row layout: poff [B + 1] int32 (poff[b] video b's first
    packed row, poff[B] the total), the padded run lengths, and order
    [B] int32 (the videos, longest first: the aggregation's walk)."""
    r = run_frames(groups)
    n = num_frames.to(torch.int64).clamp(0, f)
    runs = (n + r - 1) // r * r
    poff = torch.zeros(n.numel() + 1, dtype=torch.int32, device=n.device)
    torch.cumsum(runs, 0, dtype=torch.int32, out=poff[1:])
    order = torch.argsort(n, descending=True, stable=True).to(torch.int32)
    return {"poff": poff, "runs": runs, "order": order}


def packed_info(num_frames, f: int, groups: int):
    """info [round_up(total, 128)] as the kernel writes it: b for a live
    frame of video b, -1 - b for a pad row of its run, -1 - B for the
    rows past the total."""
    lay = packed_layout(num_frames, f, groups)
    b = num_frames.numel()
    n = num_frames.to(torch.int64).clamp(0, f)
    parts = []
    for v in range(b):
        run = int(lay["runs"][v])
        live = int(n[v])
        parts.append(torch.tensor([v] * live + [-1 - v] * (run - live),
                                  dtype=torch.int32))
    total = int(lay["poff"][-1])
    parts.append(torch.full((_up(total, TILE) - total,), -1 - b,
                            dtype=torch.int32))
    return torch.cat(parts)


def unpacked(t, scratch, b: int, f: int):
    """A packed row tensor [cap, w] of the kernel's scratch as [B, F, w],
    its live rows in place and zeros elsewhere."""
    total = int(scratch["poff"][-1])
    live = scratch["info"][:total] >= 0
    out = torch.zeros(b * f, t.shape[1], dtype=t.dtype, device=t.device)
    rows = (torch.arange(f, device=t.device)[None, :]
            < scratch["num_frames"].to(torch.int64)[:, None]).reshape(-1)
    out[rows] = t[:total][live]
    return out.reshape(b, f, -1)


def _smem(bytes_: int) -> int:
    """A launch's dynamic shared memory: its layout plus the slack that
    aligns the base to 1024 bytes (csrc/hopper_gemm.cuh ::
    smem_request)."""
    return bytes_ + 1024


def _box2(rows: int, elem_bytes: int = 2):
    """A 2-D box [rows][128 bytes], innermost first."""
    return (128 // elem_bytes, rows)


def cluster_groups(kp: int) -> int:
    """Groups a tile of the cluster product: 256 columns (192 at Kp =
    192)."""
    return {64: 4, 128: 2}.get(kp, 1)


def plan(num_frames, f: int, d: int, de: int, groups: int, k: int,
         sms: int = SMS) -> dict:
    """The card's launches for frames [B, F, D] with num_frames, De, G
    and K: the packed layout, each product's TMA boxes (innermost first),
    the row strides of its maps in bytes, its shared memory, its tiles
    and persistent grid; the forward's and the backward's."""
    n = dims(d, de, groups, k)
    g, pp, kp, gp, kx, d8 = (n["G"], n["Pp"], n["Kp"], n["GP"], n["Kx"],
                             n["D8"])
    b = num_frames.numel()
    lay = packed_layout(num_frames.cpu(), f, g)
    total = int(lay["poff"][-1])
    cap = packed_capacity(b, f, g)
    row_tiles = -(-total // TILE)
    wide_k = kp > MAX_CLUSTERS
    kn = WIDE_CLUSTERS if wide_k else cluster_groups(kp) * kp
    wide = -(-pp // WIDE_COLS)
    video_tiles = [-(-int(r) * g // TILE) for r in lay["runs"]]
    rowprod = {"box_a": _box2(TILE), "box_w": _box2(DEPTH),
               "box_y": _box2(64), "stage": A_BYTES + 4 * BOX_BYTES,
               "smem": _smem(STAGES * (A_BYTES + 4 * BOX_BYTES)
                             + 4 * 64 * 64 * 2 + 2 * STAGES * 8)}
    out = {
        "dims": n, "R": run_frames(g), "cap": cap, "total": total,
        "J": asum_slots(f, g), "poff": lay["poff"], "order": lay["order"],
        "runs": lay["runs"], "row_tiles": row_tiles,
        "pack_grid": (b + 1, -(-max(_up(f, run_frames(g)), TILE) // 32)),
        "expand": {**rowprod, "strides": (d8 * 2, gp * 2, gp * 2),
                   "depth": d8, "cols": gp,
                   "tiles": row_tiles * -(-gp // COLS),
                   "grid": min(-(-cap // TILE) * -(-gp // COLS), sms)},
        "wide": wide_k,
        "cluster": {"kp": kp, "groups": 1 if wide_k else cluster_groups(kp),
                    "cols": kn,
                    "box_x": _box2(TILE), "box_w": _box2(DEPTH),
                    "box_wa": _box2(8),
                    "strides": (gp * 2, g * kp * 2, gp * 2),
                    "stage": A_BYTES + -(-kn // 64) * BOX_BYTES + 1024,
                    "smem": _smem(STAGES * (A_BYTES + -(-kn // 64)
                                            * BOX_BYTES + 1024)
                                  + (0 if wide_k else 2 * 8 * kn * 4
                                     + 2 * TILE * 4)
                                  + 2 * STAGES * 8),
                    "tiles": row_tiles * (g * -(-kp // kn) if wide_k
                                          else -(-g // cluster_groups(kp))),
                    "grid": min(-(-cap // TILE) * (
                        g * -(-kp // kn) if wide_k
                        else -(-g // cluster_groups(kp))), sms),
                    "cluster_tiles": -(-kp // kn) if wide_k else 1},
        "softmax": ({"grid": (-(-cap // HALF), g),
                     "blocks": 2 * row_tiles * g,
                     "logits_floats": cap * g * kp} if wide_k else None),
        "aggregate": {"box_a": _box2(DEPTH), "box_x": _box2(DEPTH),
                      "strides": (kp * 2, pp * 2), "col_tiles": wide,
                      "cluster_tiles": -(-kp // TILE),
                      "stage": A_BYTES + 5 * BOX_BYTES,
                      "smem": _smem(STAGES * (A_BYTES + 5 * BOX_BYTES)
                                    + 2 * TILE * 4 + 2 * STAGES * 8),
                      "steps": [int(r) * g // DEPTH for r in lay["runs"]],
                      "tiles": b * -(-kp // TILE) * wide,
                      "grid": min(b * -(-kp // TILE) * wide, sms),
                      "norm_pass": wide > 1},
        "video_tiles": video_tiles,
        "dassign": {"box_x": _box2(TILE), "box_v": _box2(min(kp, kn)),
                    "strides": (pp * 2, pp * 2),
                    "stage": A_BYTES + min(kp, kn) * DEPTH * 2,
                    "smem": _smem(STAGES * (A_BYTES + min(kp, kn) * DEPTH * 2)
                                  + 2 * STAGES * 8),
                    "cluster_tiles": -(-kp // kn) if wide_k else 1,
                    "tiles": sum(video_tiles) * (-(-kp // kn) if wide_k
                                                 else 1),
                    "grid": sms,
                    # the wide VJP launch: a warp a (frame, group) row
                    "vjp_blocks": -(-cap * g // 8) if wide_k else 0,
                    "dasg_floats": cap * g * kp if wide_k else 0},
        "dxg": {"box_a": _box2(TILE), "box_v": _box2(DEPTH),
                "strides": (kp * 2, pp * 2), "stage": A_BYTES + 5 * BOX_BYTES,
                "smem": _smem(STAGES * (A_BYTES + 5 * BOX_BYTES)
                              + 2 * STAGES * 8),
                "tiles": sum(video_tiles) * wide, "grid": sms},
        "dxe": {**rowprod, "strides": (kx * 2, gp * 2, gp * 2), "depth": kx,
                "cols": gp, "tiles": row_tiles * -(-gp // COLS),
                "grid": min(-(-cap // TILE) * -(-gp // COLS), sms)},
    }
    for name, m, nn in (("wgrad_ext", gp, kx), ("wgrad_we", d8, gp)):
        tiles = WGRAD_SPLITS * -(-m // TILE) * -(-nn // COLS)
        out[name] = {"box_x": _box2(DEPTH), "box_y": _box2(DEPTH),
                     "strides": (m * 2, nn * 2), "rows": m, "cols": nn,
                     "stage": A_BYTES + 4 * BOX_BYTES,
                     "smem": _smem(STAGES * (A_BYTES + 4 * BOX_BYTES)
                                   + 2 * STAGES * 8),
                     "tiles": tiles, "grid": min(tiles, sms)}
    return out


def split_rows(total: int, splits: int = None):
    """The weight gradients' split s: packed rows [s per, min((s + 1)
    per, round_up(total, 64)))."""
    splits = splits or WGRAD_SPLITS
    rows = _up(total, DEPTH)
    per = _up(-(-rows // splits), DEPTH)
    return [range(min(s * per, rows), min((s + 1) * per, rows))
            for s in range(splits)]


def kernel_plan() -> dict:
    """The compiled kernels' tiles and the card's SMs (card only)."""
    import ctypes

    fwd = (ctypes.c_int * 16)()
    _build.check_launch("yt8m_nextvlad_plan",
                        _build.library().yt8m_nextvlad_plan(fwd))
    bwd = (ctypes.c_int * 9)()
    _build.check_launch("yt8m_nextvlad_train_plan",
                        _build.library().yt8m_nextvlad_train_plan(bwd))
    out = dict(zip(("rows", "cols", "wide_cols", "rowprod_stages",
                    "rowprod_smem", "cluster_stages", "cluster_smem_64",
                    "cluster_smem_128", "cluster_smem_192",
                    "cluster_smem_256", "aggregate_stages",
                    "aggregate_smem", "sms", "wide_clusters",
                    "logits_stages", "logits_smem"), fwd))
    out.update(zip(("dassign_stages", "dassign_smem_64", "dassign_smem_128",
                    "dassign_smem_192", "dassign_smem_256", "dxg_stages",
                    "dxg_smem", "wgrad_stages", "wgrad_smem"), bwd))
    return out


def dequantized(frames):
    """uint8 frames dequantized to f32 (x * scale, then + bias, each
    rounded); f32 frames as they are."""
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x * DEQUANT_SCALE + DEQUANT_BIAS
    return x


def forward_plain(frames, num_frames, expand_w, attn_w, attn_b, cluster_w,
                  centers, groups, dtype=torch.bfloat16) -> dict:
    """The forward's intermediates with the kernel's rounding points:
    x [B, F, D] f32, xe [B, F, De] (rounded), alpha [B, F, G], sm and
    assign [B, F, G, K] f32, live [B, F], a_sum [B, K], vlad (pre-norm)
    and out [B, K, P]."""
    b, f, d = frames.shape
    g = groups
    de = expand_w.shape[1]
    p = de // g
    k = cluster_w.shape[1] // g
    x = dequantized(frames)
    xe = _r(torch.matmul(_r(x, dtype), _r(expand_w, dtype)), dtype)
    alpha = torch.sigmoid(torch.matmul(xe, _r(attn_w, dtype))
                          + attn_b.to(torch.float32))
    act = torch.matmul(xe, _r(cluster_w, dtype)).reshape(b, f, g, k)
    e = torch.exp(act - torch.amax(act, dim=-1, keepdim=True))
    sm = e / torch.sum(e, dim=-1, keepdim=True)
    live = (torch.arange(f, device=frames.device)[None, :]
            < num_frames.to(torch.int64)[:, None])
    assign = torch.where(live[:, :, None, None], sm * alpha[..., None], 0.0)
    xg = xe.reshape(b, f * g, p)
    vlad = torch.matmul(_r(assign, dtype).reshape(b, f * g, k).transpose(1, 2),
                        xg)
    a_sum = torch.sum(assign, dim=(1, 2))
    vlad = vlad - a_sum[:, :, None] * centers.to(torch.float32)
    sum_sq = torch.sum(vlad * vlad, dim=2, keepdim=True)
    out = vlad / torch.sqrt(torch.clamp_min(sum_sq, NORM_EPS_SQ))
    return {"x": x, "xe": xe, "alpha": alpha, "sm": sm, "assign": assign,
            "live": live, "a_sum": a_sum, "vlad": vlad, "sum_sq": sum_sq,
            "out": out}


def nextvlad_aggregate_plain(frames, num_frames, expand_w, attn_w, attn_b,
                             cluster_w, centers, groups,
                             dtype=torch.bfloat16):
    """Plain PyTorch version: intra-normalised descriptors [B, K, P] f32."""
    return forward_plain(frames, num_frames, expand_w, attn_w, attn_b,
                         cluster_w, centers, groups, dtype)["out"]


def kernel_layout(expand_w, attn_w, attn_b, cluster_w, centers, groups,
                  training: bool = False) -> dict:
    """The kernel's weight operands from the model's f32 weights:

        we [D8, G*Pp]    we[d, g*Pp + p]       = We[d, g*P + p]
        wc [G*Pp, G*Kp]  wc[g*Pp + p, h*Kp + k] = Wc[g*P + p, h*K + k]
        wa [G, G*Pp]     wa[h, g*Pp + p]       = Wa[g*P + p, h]
        ab [G], centers [K, P] f32

    in bf16 with zero pads. With `training`, also wext [Kx, G*Pp] =
    [wc^T; wa; 0] (Kx = G*Kp + KA), the backward's operand, of which `wa`
    is then a view."""
    d, de = expand_w.shape
    n = dims(d, de, groups, cluster_w.shape[1] // groups)
    g, p, pp, k, kp = n["G"], n["P"], n["Pp"], n["K"], n["Kp"]
    dev = expand_w.device
    bf = torch.bfloat16
    with torch.no_grad():
        we = torch.zeros(n["D8"], g, pp, dtype=bf, device=dev)
        we[:d, :, :p] = expand_w.reshape(d, g, p)
        wc = torch.zeros(g, pp, g, kp, dtype=bf, device=dev)
        wc[:, :p, :, :k] = cluster_w.reshape(g, p, g, k)
        wc = wc.reshape(n["GP"], g * kp)
        wa = torch.zeros(g, g, pp, dtype=bf, device=dev)
        wa[:, :, :p] = attn_w.reshape(g, p, g).permute(2, 0, 1)
        out = {"we": we.reshape(n["D8"], n["GP"]), "wc": wc,
               "wa": wa.reshape(g, n["GP"]),
               "ab": attn_b.detach().to(torch.float32).contiguous(),
               "centers": centers.detach().to(torch.float32).contiguous(),
               "dims": n}
        if training:
            wext = torch.zeros(n["Kx"], n["GP"], dtype=bf, device=dev)
            wext[: g * kp] = wc.t()
            wext[g * kp: g * kp + g] = out["wa"]
            out["wext"] = wext
            out["wa"] = wext[g * kp: g * kp + g]
    return out


def _frames_for_kernel(frames, n):
    """Frames with D padded to a multiple of 8 (zeros; the padded rows of
    `we` are zeros, so any padded value adds exactly 0)."""
    if n["D8"] == n["D"]:
        return frames.contiguous()
    return torch.nn.functional.pad(frames, (0, n["D8"] - n["D"])).contiguous()


def launch_forward(frames, num_frames, layout, residuals: bool = False):
    """Launch the CUDA forward: (out [B, K, P] f32, scratch), where
    scratch holds the kernel's packed layout (poff, order, info,
    num_frames) and intermediates over cap packed rows (xb, xe, assign
    bf16; the a_sum partials and a_sum f32; with `residuals` also alpha
    [cap, G], the f32 softmax sm [cap, G * Kp] and the pre-norm vlad,
    which the backward reads)."""
    n = layout["dims"]
    b, f, _ = frames.shape
    g, k, p, kp = n["G"], n["K"], n["P"], n["Kp"]
    require(frames.dtype in (torch.uint8, torch.float32),
            f"frames: dtype {frames.dtype}, want uint8 or float32")
    require(1 <= b <= 65535 and f >= 1,
            f"B={b} must be in [1, 65535] and F={f} at least 1")
    require(k <= max_clusters(),
            f"nextvlad_aggregate takes K <= {max_clusters()} on the card, "
            f"got K={k}")
    cap = packed_capacity(b, f, g)
    require(indexable(b, f, g, n["Pp"], n["Kp"]),
            f"B * F = {b * f} frames of {g} groups and K={k} is more "
            f"packed rows than the kernel indexes")
    x = _frames_for_kernel(frames, n)
    require_cuda_operand("frames", x, frames.dtype, (b, f, n["D8"]))
    require_cuda_operand("num_frames", num_frames, torch.int32, (b,))
    require_cuda_operand("we", layout["we"], torch.bfloat16,
                         (n["D8"], n["GP"]))
    require_cuda_operand("wc", layout["wc"], torch.bfloat16,
                         (n["GP"], g * kp))
    require_cuda_operand("wa", layout["wa"], torch.bfloat16, (g, n["GP"]))
    require_cuda_operand("ab", layout["ab"], torch.float32, (g,))
    require_cuda_operand("centers", layout["centers"], torch.float32, (k, p))
    dev = frames.device
    ptiles = -(-n["Pp"] // WIDE_COLS)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    s = packed_layout(num_frames, f, g)
    del s["runs"]
    s.update({
        "num_frames": num_frames, "frames": f,
        "info": empty((cap,), torch.int32),
        "xb": empty((cap, n["D8"]), torch.bfloat16),
        "xe": empty((cap, n["GP"]), torch.bfloat16),
        "assign": empty((cap, g * kp), torch.bfloat16),
        "asum_part": empty((b, asum_slots(f, g), g, kp)),
        "a_sum": empty((b, kp)),
    })
    wide = kp > MAX_CLUSTERS
    if residuals or wide:
        s["alpha"] = empty((cap, g))
    if residuals:
        s["sm"] = empty((cap, g * kp))
    elif wide:
        s["logits"] = empty((cap, g * kp))
    if residuals or ptiles > 1:
        s["vlad"] = empty((b, k, p))
    if ptiles > 1:
        s["sumsq"] = empty((b, ptiles, k))
    out = empty((b, k, p))
    lib = _build.library()
    fn = (lib.yt8m_nextvlad_aggregate_u8 if frames.dtype == torch.uint8
          else lib.yt8m_nextvlad_aggregate_f32)

    def opt(name):
        return _build.ptr(s[name]) if name in s else None

    code = fn(
        _build.ptr(x), _build.ptr(num_frames), _build.ptr(s["poff"]),
        _build.ptr(s["order"]), _build.ptr(layout["we"]),
        _build.ptr(layout["wc"]), _build.ptr(layout["wa"]),
        _build.ptr(layout["ab"]), _build.ptr(layout["centers"]),
        _build.ptr(s["xb"]), _build.ptr(s["info"]), _build.ptr(s["xe"]),
        opt("alpha"), _build.ptr(s["assign"]), opt("sm"), opt("logits"),
        _build.ptr(s["asum_part"]), _build.ptr(s["a_sum"]), opt("vlad"),
        opt("sumsq"), _build.ptr(out), b, f, n["D8"], g, k, p, cap,
        _build.current_stream(dev),
    )
    _build.check_launch("nextvlad_aggregate", code)
    return out, s


def _shapes(frames, num_frames, expand_w, attn_w, attn_b, cluster_w,
            centers, groups):
    require(frames.dim() == 3,
            f"frames must be [B, F, D], got {tuple(frames.shape)}")
    b, _, d = frames.shape
    require(expand_w.dim() == 2 and expand_w.shape[0] == d,
            f"expand_w must be [{d}, De], got {tuple(expand_w.shape)}")
    de = expand_w.shape[1]
    g = groups
    require(g >= 1 and de % g == 0,
            f"expansion dim {de} not divisible by groups {g}")
    p = de // g
    require(cluster_w.dim() == 2 and cluster_w.shape[0] == de
            and cluster_w.shape[1] % g == 0,
            f"cluster_w must be [{de}, G*K], got {tuple(cluster_w.shape)}")
    k = cluster_w.shape[1] // g
    for name, t, shape in (("num_frames", num_frames, (b,)),
                           ("attn_w", attn_w, (de, g)),
                           ("attn_b", attn_b, (g,)),
                           ("centers", centers, (k, p))):
        require(tuple(t.shape) == shape,
                f"{name} must be {list(shape)}, got {tuple(t.shape)}")


def nextvlad_aggregate(frames, num_frames, expand_w, attn_w, attn_b,
                       cluster_w, centers, groups, dtype=torch.bfloat16,
                       layout=None):
    """Intra-normalised NeXtVLAD descriptors [B, K, P] f32 (pre-BN).

    frames [B, F, D] uint8 or float32; num_frames [B]; the five f32
    weights in the JAX model's shapes. For CPU tensors the plain version
    in `dtype`; for CUDA tensors the kernel, which computes in bf16 and
    takes `layout` (`kernel_layout` of the weights, made here when None).
    """
    _shapes(frames, num_frames, expand_w, attn_w, attn_b, cluster_w,
            centers, groups)
    if on_cpu(frames, num_frames, expand_w, attn_w, attn_b, cluster_w,
              centers):
        return nextvlad_aggregate_plain(frames, num_frames, expand_w, attn_w,
                                        attn_b, cluster_w, centers, groups,
                                        dtype)
    require(dtype == torch.bfloat16,
            "the CUDA kernel computes in bf16; dtype must be bfloat16")
    if layout is None:
        layout = kernel_layout(expand_w, attn_w, attn_b, cluster_w, centers,
                               groups)
    out, _ = launch_forward(frames, num_frames.to(torch.int32).contiguous(),
                            layout)
    nextvlad_aggregate.launches += 1
    return out


def nextvlad_aggregate_with_scratch(frames, num_frames, layout):
    """The kernel's output and intermediates (see launch_forward), for
    the card's rounding witness; counts as a launch."""
    out, s = launch_forward(frames, num_frames, layout)
    nextvlad_aggregate.launches += 1
    return out, s


nextvlad_aggregate.launches = 0


def _live_rows(num_frames, f):
    live = (torch.arange(f, device=num_frames.device)[None, :]
            < num_frames.to(torch.int64)[:, None])
    return live.reshape(-1)


def forward_on_stream(frames, num_frames, layout, scratch, out) -> dict:
    """The plain steps fed the kernel's own roundings (its bf16 operands
    `layout`, frames xb and xe, assignment and a_sum, unpacked from its
    packed rows), over the live frames: {name: (kernel value, plain f32
    value)} for the rounded streams "xe" and "assign" and for "out", the
    plain aggregation and norm on the kernel's xe, assignment and a_sum.
    Where a bf16 value differs from bf16 of the plain one, the two sums
    ran in another order; what is left in "out" is f32 order alone."""
    n = layout["dims"]
    d, g, k, p, pp, kp = n["D"], n["G"], n["K"], n["P"], n["Pp"], n["Kp"]
    b, f, _ = frames.shape
    rows = _live_rows(num_frames, f)
    full_xe = unpacked(scratch["xe"], scratch, b, f).reshape(b * f, g, pp)
    xe = full_xe[rows, :, :p].reshape(-1, g * p)
    xb = unpacked(scratch["xb"], scratch, b, f).reshape(b * f, -1)[rows, :d]
    we = layout["we"][:d].reshape(d, g, pp)[:, :, :p].reshape(d, g * p)
    pairs = {"xe": (xe, torch.matmul(xb.float(), we.float()))}
    del xb, full_xe
    xef = xe.float()
    wc = layout["wc"].reshape(g, pp, g, kp)[:, :p, :, :k].reshape(g * p, -1)
    wa = layout["wa"].reshape(g, g, pp)[:, :, :p].reshape(g, g * p).t()
    act = torch.matmul(xef, wc.float()).reshape(-1, g, k)
    alpha = torch.sigmoid(torch.matmul(xef, wa.float()) + layout["ab"])
    e = torch.exp(act - torch.amax(act, dim=-1, keepdim=True))
    del act
    assign = e / torch.sum(e, dim=-1, keepdim=True) * alpha[..., None]
    del e
    ka = unpacked(scratch["assign"], scratch, b, f).reshape(
        b * f, g, kp)[rows, :, :k]
    pairs["assign"] = (ka, assign)
    full = torch.zeros(b * f, g, k, device=frames.device)
    full[rows] = ka.float()
    xg = torch.zeros(b * f, g * p, device=frames.device)
    xg[rows] = xef
    vlad = torch.bmm(full.reshape(b, f * g, k).transpose(1, 2),
                     xg.reshape(b, f * g, p))
    vlad = vlad - scratch["a_sum"][:, :k, None] * layout["centers"]
    sum_sq = torch.sum(vlad * vlad, dim=2, keepdim=True)
    pairs["out"] = (out, vlad / torch.sqrt(torch.clamp_min(sum_sq,
                                                           NORM_EPS_SQ)))
    return pairs
