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

The CUDA kernel (csrc/nextvlad.cu) is six launches on the caller's
stream, over the live frames of all videos packed one after another
(`row_off`, the prefix sums of the live counts): the live frames to
bf16; xe = xb @ We (a tiled tensor-core product, rounded to bf16 once);
alpha (the G length-De attention dots of each frame, on the CUDA cores);
xe @ Wc with one group's K clusters a column tile, whose epilogue takes
the softmax, bf16(assign) and each video's column sums; the aggregation
assign^T @ xg over each video's live F * G rows with the centers term;
and the intra-norm. Frames past num_frames are neither read nor
computed; a video with num_frames = 0 gives zeros. What it materialises
(B = 512, F = 300 at the reference widths, written for the live frames
only): xb 354 MB and xe 708 MB in bf16, the bf16 assignment 315 MB,
alpha 5 MB and the pre-norm vlad 75 MB.

The kernel takes the weights in a group-major, padded bf16 layout
(`kernel_layout`, made once per model as a serving constant): P padded
to Pp (a multiple of 8) inside each group, K to Kp (a multiple of 64, at
most 256), D to a multiple of 8; the pads are zeros, so padded features
are exact zeros end to end and padded clusters are left out of the
softmax by the kernel.
"""

from __future__ import annotations

import torch

from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels import _build
from yt8m_tpu_torch.kernels._checks import (
    on_cpu,
    require,
    require_cuda_operand,
)

NORM_EPS_SQ = 1e-12
MAX_CLUSTERS = 256   # K a block of the cluster product holds for its softmax
TILE = 128           # rows and columns of a block tile (csrc/nextvlad.cu)
MAX_ATTENTION_BYTES = 200 * 1024  # the attention weights in shared memory
K_MULTIPLE = 64      # Kp: a warp's share of a cluster tile is whole fragments


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
    scratch holds the kernel's intermediates (row_off, the prefix sums of
    the live counts that pack the live frames; xb, xe, assign bf16;
    alpha, a_sum and the pre-norm vlad f32; with `residuals` also the f32
    softmax sm [B, F, G, Kp], which the backward reads)."""
    n = layout["dims"]
    b, f, _ = frames.shape
    g, k, p, kp = n["G"], n["K"], n["P"], n["Kp"]
    require(frames.dtype in (torch.uint8, torch.float32),
            f"frames: dtype {frames.dtype}, want uint8 or float32")
    require(1 <= b <= 65535 and f >= 1,
            f"B={b} must be in [1, 65535] and F={f} at least 1")
    require(k <= MAX_CLUSTERS,
            f"nextvlad_aggregate takes K <= {MAX_CLUSTERS}, got K={k}")
    require(g * n["GP"] * 2 <= MAX_ATTENTION_BYTES,
            f"nextvlad_aggregate holds the attention weights in shared "
            f"memory: G * G * Pp * 2 = {g * n['GP'] * 2} bytes, at most "
            f"{MAX_ATTENTION_BYTES}")
    require(-(-b * f // TILE) <= 65535,
            f"B * F = {b * f} frames is more than 65535 tiles of "
            f"{TILE}")
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
    ftiles = -(-f // TILE)
    ptiles = -(-n["Pp"] // TILE)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    row_off = torch.zeros(b + 1, dtype=torch.int32, device=dev)
    torch.cumsum(num_frames.clamp(0, f), 0, dtype=torch.int32,
                 out=row_off[1:])
    s = {
        "row_off": row_off,
        "xb": empty((b, f, n["D8"]), torch.bfloat16),
        "xe": empty((b, f, n["GP"]), torch.bfloat16),
        "assign": empty((b, f, g, kp), torch.bfloat16),
        "asum_part": empty((b, ftiles + 1, g, kp)),
        "alpha": empty((b, f, g)),
        "vlad": empty((b, k, p)),
        "sumsq": empty((b, ptiles, k)),
        "a_sum": empty((b, kp)),
    }
    if residuals:
        s["sm"] = empty((b, f, g, kp))
    out = empty((b, k, p))
    lib = _build.library()
    fn = (lib.yt8m_nextvlad_aggregate_u8 if frames.dtype == torch.uint8
          else lib.yt8m_nextvlad_aggregate_f32)
    code = fn(
        _build.ptr(x), _build.ptr(num_frames), _build.ptr(row_off),
        _build.ptr(layout["we"]), _build.ptr(layout["wc"]),
        _build.ptr(layout["wa"]), _build.ptr(layout["ab"]),
        _build.ptr(layout["centers"]), _build.ptr(s["xb"]),
        _build.ptr(s["xe"]), _build.ptr(s["assign"]),
        _build.ptr(s["asum_part"]), _build.ptr(s["alpha"]),
        _build.ptr(s["vlad"]), _build.ptr(s["sumsq"]), _build.ptr(s["a_sum"]),
        _build.ptr(s["sm"]) if residuals else None, _build.ptr(out), b, f,
        n["D8"], g, k, p, _build.current_stream(dev),
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
    `layout`, frames xb and xe, assignment and a_sum), over the live
    frames: {name: (kernel value, plain f32 value)} for the rounded
    streams "xe" and "assign" and for "out", the plain aggregation and
    norm on the kernel's xe, assignment and a_sum. Where a bf16 value
    differs from bf16 of the plain one, the two sums ran in another
    order; what is left in "out" is f32 order alone."""
    n = layout["dims"]
    d, g, k, p, pp, kp = n["D"], n["G"], n["K"], n["P"], n["Pp"], n["Kp"]
    b, f, _ = frames.shape
    rows = _live_rows(num_frames, f)
    xe = scratch["xe"].reshape(b * f, g, pp)[rows, :, :p].reshape(-1, g * p)
    xb = scratch["xb"].reshape(b * f, -1)[rows, :d].float()
    we = layout["we"][:d].reshape(d, g, pp)[:, :, :p].reshape(d, g * p)
    pairs = {"xe": (xe, torch.matmul(xb, we.float()))}
    del xb
    xef = xe.float()
    wc = layout["wc"].reshape(g, pp, g, kp)[:, :p, :, :k].reshape(g * p, -1)
    wa = layout["wa"].reshape(g, g, pp)[:, :, :p].reshape(g, g * p).t()
    act = torch.matmul(xef, wc.float()).reshape(-1, g, k)
    alpha = torch.sigmoid(torch.matmul(xef, wa.float()) + layout["ab"])
    e = torch.exp(act - torch.amax(act, dim=-1, keepdim=True))
    del act
    assign = e / torch.sum(e, dim=-1, keepdim=True) * alpha[..., None]
    del e
    ka = scratch["assign"].reshape(b * f, g, kp)[rows, :, :k]
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
