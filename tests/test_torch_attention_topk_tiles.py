"""The redesigned attention pooling (csrc/attention_pool.cu) and top-k
(csrc/topk.cu) on the CPU: what each launch asks of the card, the
persistent walk over videos and the ring of stages, and the kernels'
decompositions in plain PyTorch, held against the plain versions and
against the JAX kernels in interpret mode.

Tolerances.
  * Top-k: bit for bit. The radix select (the key map, the byte passes
    with their early exit, the gather of the ties in index order over the
    threads' spans, the bitonic network) against exact_topk_plain (values
    by their bits and indices) and against JAX's exact_topk in interpret
    mode (values as floats: the JAX kernel reports each tie's maximum,
    +0.0 for a -0.0 column; indices exactly).
  * Attention, the tiled decomposition (16-frame tiles, the 64-column
    chunks' 16-column k steps in the kernel's column order summed in four
    chains, the pooling by tiles in the kernel's order) against
    attention_pool_plain: 1e-5 * max|ref| + 1e-6 where every bf16
    attention weight agrees with the plain version's (the f32 sums run in
    another order, nothing else differs); where one flips at a rounding
    boundary, the limit attention_pool.rounding_limit derives.
  * Against JAX's attention_pool in interpret mode: the bound of
    tests/test_torch_attention.py, 2e-2 * max|ref|, for num_frames >= 1
    (at 0 the JAX kernel averages padded rows; that file shows it).
The compiled kernels' plans are held to these in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import _topk_cases
from yt8m_tpu.kernels.attention_pool import attention_pool as jax_pool
from yt8m_tpu.kernels.topk import exact_topk as jax_exact_topk
from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels import attention_pool as tap
from yt8m_tpu_torch.kernels import topk as ttopk

SMEM_LIMIT = 232448   # shared memory a block can use on an H100
REGISTERS = 65536     # 32-bit registers an SM
NEG = -3.0e38


def _bf(t):
    return t.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Top-k: the radix select
# ---------------------------------------------------------------------------


def keys_of(v):
    """csrc/topk.cu :: key_of on sanitised f32 values, as int64: -0.0 made
    +0.0, then the sign bit flipped for positives, every bit for
    negatives."""
    u = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u == 0x80000000, torch.zeros_like(u), u)
    return torch.where(u >= 0x80000000, (~u) & 0xFFFFFFFF, u | 0x80000000)


def _before(a, i, b, j):
    return a > b or (a == b and i < j)


def select_kth(keys, k, early_exit=True):
    """csrc/topk.cu :: select_kth over a list of keys: the k-th largest a
    byte a pass from the top. (prefix, mask, need, passes)."""
    prefix, mask, need = 0, 0, k
    for pas in range(4):
        shift = 24 - 8 * pas
        hist = [0] * 256
        for key in keys:
            if (key & mask) == prefix:
                hist[(key >> shift) & 0xFF] += 1
        cum = 0
        for d in range(255, -1, -1):  # the bin the count reaches need in
            if cum + hist[d] >= need:
                break
            cum += hist[d]
        need -= cum
        prefix |= d << shift
        mask |= 0xFF << shift
        if early_exit and hist[d] == need:
            break
    return prefix, mask, need, pas + 1


def bitonic(ck, ci):
    """csrc/topk.cu :: bitonic on lists of a power-of-two length."""
    width = len(ck)
    size = 2
    while size <= width:
        stride = size // 2
        while stride > 0:
            for i in range(width // 2):
                lo = 2 * i - (i & (stride - 1))
                hi = lo + stride
                up = (lo & size) == 0
                if (_before(ck[hi], ci[hi], ck[lo], ci[lo]) if up else
                        _before(ck[lo], ci[lo], ck[hi], ci[hi])):
                    ck[lo], ck[hi] = ck[hi], ck[lo]
                    ci[lo], ci[hi] = ci[hi], ci[lo]
            stride //= 2
        size *= 2
    return ck, ci


def _pow2(n):
    w = 1
    while w < n:
        w *= 2
    return w


def radix_topk(x, k, early_exit=True):
    """The kernel's selection, row by row: (values [B, k], indices [B, k]
    int32, [(route, passes)] a row). Route "maxima": the threshold is the
    least of the 8 warps' ceil(k / 8)-th largest of the threads' maxima
    over the columns each loaded, and every key that reaches it is
    sorted. Where more than CAND keys reach it,
    route "ties" (fewer than k pass it: it is the k-th key) or route "row"
    (the radix select on the row's keys): the keys above the k-th and its
    first ties in index order are sorted."""
    b, c = x.shape
    p = ttopk.plan(c, k)
    warps = p["threads"] // 32
    v = torch.clamp_min(torch.where(torch.isnan(x), torch.full_like(x, NEG),
                                    x), NEG)
    vals = torch.empty(b, k)
    idxs = torch.empty(b, k, dtype=torch.int32)
    routes = []
    spans = [range(min(c, t * p["span"]), min(c, (t + 1) * p["span"]))
             for t in range(p["threads"])]
    vec = 4 if p["vector"] else 1  # the columns a thread loads, coalesced
    loaded = [[col for col in range(c) if (col // vec) % p["threads"] == t]
              for t in range(p["threads"])]
    for r in range(b):
        keys = keys_of(v[r]).tolist()
        maxima = [max((keys[col] for col in group), default=0)
                  for group in loaded]  # an empty set's 0 below every key
        m = -(-k // warps)
        threshold = min(sorted(maxima[32 * w:32 * w + 32], reverse=True)[m - 1]
                        for w in range(warps))
        assert sum(mx >= threshold for mx in maxima) >= k
        cand = [col for col in range(c) if keys[col] >= threshold]
        if len(cand) <= p["cand"]:  # any order: the network sorts them
            route, passes = "maxima", 0
            width = _pow2(len(cand))
        else:
            above = sum(key > threshold for key in keys)
            if above < k:  # the threshold is the k-th key
                route, passes = "ties", 0
                prefix, mask, need = threshold, 0xFFFFFFFF, k - above
            else:
                route = "row"
                prefix, mask, need, passes = select_kth(keys, k, early_exit)
            above, ties = [], []
            for span in spans:  # the block scan's order: thread, column
                for col in span:
                    if (keys[col] & mask) > prefix:
                        above.append(col)
                    elif (keys[col] & mask) == prefix:
                        ties.append(col)
            assert len(above) == k - need and len(ties) >= need
            cand = above + ties[:need]
            width = _pow2(k)
        ck = [keys[col] for col in cand] + [0] * (width - len(cand))
        ci = cand + [2 ** 31 - 1] * (width - len(cand))
        ck, ci = bitonic(ck, ci)
        routes.append((route, passes))
        idxs[r] = torch.tensor(ci[:k], dtype=torch.int32)
        vals[r] = v[r][idxs[r].long()]
    return vals, idxs, routes


def _new_topk_cases():
    rng = np.random.default_rng(17)
    signed = -rng.random((4, 4716)).astype(np.float32)
    signed[0, ::2] = 0.0
    signed[0, 1::2] = -0.0
    signed[1, :40] = -0.0
    signed[1, 40:80] = 0.0
    signed[2, 100:] = -0.0
    signed[3, 7], signed[3, 3], signed[3, 9] = 0.0, -0.0, 0.5
    equal = np.full((3, 301), 0.25, np.float32)
    equal[1] = -3.4e38
    equal[2] = np.nan
    # Top 16 bits of every key alike: 0.5 + [0, 2^-9).
    close = (0.5 + rng.random((4, 4716)) * 2.0 ** -9).astype(np.float32)
    close[1, ::5] = close[1, 0]
    odd = rng.random((5, 4715)).astype(np.float32)
    odd[0, ::3] = 0.75
    sigmoid = (1 / (1 + np.exp(-rng.normal(0, 3, (6, 4716))))).astype(
        np.float32)
    cases = {"k_equals_c": (rng.random((4, 128)).astype(np.float32), 128),
             "k_equals_c_small": (rng.random((3, 20)).astype(np.float32), 20),
             "c_not_a_multiple_of_4": (odd, 20)}
    for k in (1, 20, 64, 128):
        cases[f"signed_zeros_k{k}"] = (signed, k)
        cases[f"all_equal_k{k}"] = (equal, k)
        cases[f"top16_alike_k{k}"] = (close, k)
        cases[f"sigmoid_k{k}"] = (sigmoid, k)
    return cases


def _all_topk_cases():
    return {**_topk_cases(), **_new_topk_cases()}


@pytest.mark.parametrize("case", sorted(_all_topk_cases()))
def test_radix_select_is_bit_for_bit_the_plain_version(case):
    x, k = _all_topk_cases()[case]
    xt = torch.from_numpy(x)
    got_v, got_i, _ = radix_topk(xt, k)
    want_v, want_i = ttopk.exact_topk_plain(xt, k)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    assert torch.equal(got_i, want_i)
    plain_v, plain_i, _ = radix_topk(xt, k, early_exit=False)
    assert torch.equal(plain_v.view(torch.int32), got_v.view(torch.int32))
    assert torch.equal(plain_i, got_i)


@pytest.mark.parametrize("case", ["signed_zeros_k20", "signed_zeros_k128",
                                  "all_equal_k64", "top16_alike_k20",
                                  "sigmoid_k64", "c_not_a_multiple_of_4",
                                  "k_equals_c", "special", "ties"])
def test_radix_select_matches_jax_kernel(case):
    x, k = _all_topk_cases()[case]
    got_v, got_i, _ = radix_topk(torch.from_numpy(x), k)
    want_v, want_i = jax_exact_topk(jnp.asarray(x), k, interpret=True,
                                    block_b=8)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_radix_select_routes_and_early_exit():
    """At 4716 uniform or sigmoid scores the warps' threshold passes a
    few more keys than k and they are sorted (the first route; at k = 128
    some rows pass more than 256 and take another); a row of equal values
    passes every key, none above it (the threshold is the k-th key);
    many distinct keys just above the threshold take the radix select;
    fewer than 256 columns are sorted whole."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((16, 4716)).astype(np.float32))
    z = torch.from_numpy(rng.normal(0, 3, (16, 4716)).astype(np.float32))
    for k in (1, 20, 64, 128):
        for rows in (x, torch.sigmoid(z)):
            _, _, routes = radix_topk(rows, k)
            first = sum(route == "maxima" for route, _ in routes)
            assert first == 16 if k <= 64 else first >= 8, (k, routes)
    _, _, routes = radix_topk(torch.full((1, 4716), 0.25), 20)
    assert routes == [("ties", 0)]
    _, _, routes = radix_topk(torch.full((1, 200), 0.25), 20)
    assert routes == [("maxima", 0)]  # every key fits the sort
    # 300 keys just above the rest (in the first 16 spans, so that seven
    # warps' thresholds lie below them): the radix select on the row, all
    # four bytes without its early exit.
    dense = torch.cat([0.9 + x[:1, :300] * 1e-3, x[:1, 300:] * 0.5], 1)
    assert radix_topk(dense, 20)[2][0][0] == "row"
    assert radix_topk(dense, 20, early_exit=False)[2] == [("row", 4)]


@pytest.mark.parametrize("c,k", [(4716, 20), (4716, 64), (4715, 128),
                                 (301, 20), (7, 1), (128, 128),
                                 (ttopk.MAX_COLUMNS, 128)])
def test_topk_plan_fits_the_card(c, k):
    p = ttopk.plan(c, k)
    assert p["span"] % 2 == 1 and p["span"] * p["threads"] >= c
    assert (p["span"] - 2) * p["threads"] < c  # the smallest odd span
    fits = p["smem"] + p["static_smem"] <= SMEM_LIMIT
    assert fits == (c <= (SMEM_LIMIT - p["static_smem"]) // 4)
    assert p["sort_width"] >= k and p["sort_width"] < 2 * max(k, 1)
    assert p["cand"] >= ttopk.MAX_K and p["cand"] <= p["threads"]
    assert p["vector"] == (c % 4 == 0)


def test_topk_spans_cover_the_row_once_on_distinct_banks():
    for c in (4716, 4715, 301, 7):
        p = ttopk.plan(c, 20)
        cols = []
        for t in range(p["threads"]):
            cols += range(min(c, t * p["span"]), min(c, (t + 1) * p["span"]))
        assert cols == list(range(c))
        for w in range(p["threads"] // 32):  # a warp's j-th reads
            banks = {((32 * w + lane) * p["span"]) % 32 for lane in range(32)}
            assert len(banks) == 32


def test_topk_keys_order_and_signed_zero():
    v = torch.tensor([NEG, -1.0, -1e-30, -0.0, 0.0, 1e-30, 0.5, 1.0,
                      float("inf")])
    k = keys_of(v).tolist()
    assert k[3] == k[4]
    assert all(a < b for a, b in zip(k[:3] + k[4:], k[1:3] + k[4:][1:]))
    assert min(k) > 0  # no sanitised value takes the sort's padding key


def test_topk_wrapper_refuses_what_the_kernel_cannot_hold():
    x = torch.zeros(2, 20)
    assert ttopk.exact_topk(x, 20)[1].tolist() == [list(range(20))] * 2
    with pytest.raises(ValueError):
        ttopk.exact_topk(x, 21)


# ---------------------------------------------------------------------------
# Attention pooling: the plan and the persistent walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("d", [8, 64, 1001, 1152])
@pytest.mark.parametrize("h", [1, 2, 4, 8, 16, 19])
def test_attention_plan_fits_the_card(x_dtype, d, h):
    """The ring, Q in fragment order, the scores and the attention fit a
    block's shared memory at F=300 for every launch the wrapper makes (D
    padded, more than 16 heads 16 at a time); at least two stages, each
    1024-byte aligned (the swizzle's atom); the pass-2 accumulators of a
    warp's groups fit its registers; the TMA box fits its limits."""
    dp = tap.padded_columns(d, x_dtype)
    esize = 1 if x_dtype == torch.uint8 else 4
    assert dp % tap.CHUNK == 0 and (dp * esize) % tap.LINE == 0 and dp >= d
    for hh in ([16, h - 16] if h > 16 else [h]):
        p = tap.plan(300, dp, hh, x_dtype)
        assert p["smem"] <= SMEM_LIMIT and p["stages"] >= 2
        assert p["stages"] <= p["warps"]  # a stage's pass-1 tiles, one warp
        assert p["stage_bytes"] % tap.ALIGN == 0
        assert p["q_off"] == p["stages"] * p["stage_bytes"]
        assert p["bar_off"] >= (p["q_off"] + p["q_bytes"] + p["scores_bytes"]
                                + p["attn_bytes"])
        assert p["groups_a_warp"] <= tap.MAX_GROUPS
        acc = tap.MAX_GROUPS * 2 * p["n_tiles"] * 4
        assert acc + 48 <= REGISTERS // p["threads"]
        assert all(1 <= n <= 256 for n in p["box"])
        assert p["box"][0] * esize == tap.LINE
        assert p["lines"] * tap.LINE >= dp * esize
        # The swizzle puts the same bytes of eight rows on eight distinct
        # 16-byte units (an odd line count); a head's attention row
        # starts 16 bytes past the last one's bank.
        for b in (0, 16, 64, 112):
            units = {(((b >> 4) & 7) ^ ((r * p["lines"] + (b >> 7)) & 7))
                     for r in range(8)}
            assert len(units) == 8
        assert (2 * p["attn_pitch"]) % 128 == 16
        assert p["f16"] >= 300 and p["attn_pitch"] >= p["f16"]


def test_attention_plan_at_the_serving_shape():
    p = tap.plan(300, 1152, 8, torch.uint8, b=512)
    assert (p["stages"], p["stage_bytes"], p["grid"]) == (10, 18432, 132)
    assert p["resident_frames"] == 160 and p["groups_a_warp"] == 3
    q = tap.plan(300, 1152, 8, torch.float32)
    assert q["stages"] == 2 and q["lines"] == 37


def walk(num_frames, f, stages, grid):
    """The persistent grid's protocol, block by block in turns: each
    block's producer takes its first video (the block's index) and then
    the next one from the counter as soon as the last one's loads are
    issued, issues video_loads into the ring (a slot is reused
    only once the load S before it was released), and its consumers use
    the loads in the kernel's order: a video's first load (its header,
    every warp), pass 1's tiles (the warp of the tile's slot; releasing
    those pass 2 will not find in place), then pass2_order's (every warp,
    releasing each). A warp may wait on load X only where it knows load
    X - S has landed (an mbarrier's parity tells one phase from the next,
    not from the one after): it waited on it itself, or a barrier of the
    consumers lies between a wait on it and this one (the header's, for
    every load before the video's first; the end of pass 1's, for pass
    1's loads). Returns, for each video, the block that took it and
    the frames each pass read; raises if a slot's content is not the load
    expected, a wait would run two phases ahead, or the walk stops making
    progress."""
    nf = list(num_frames)
    nxt = iter(range(grid, len(nf)))
    taken, reads = {}, {v: {1: [], 2: []} for v in range(len(nf))}
    blocks = [{"issued": 0, "released": set(), "slots": {}, "queue": [],
               "uses": [], "stopped": False, "floor": 0, "pass1": set(),
               "known": {w: set() for w in range(tap.WARPS)}}
              for _ in range(grid)]

    def uses_of(v, first):
        n = nf[v]
        rows = f if n <= 0 else min(n, f)
        tiles = -(-rows // tap.ROWS)
        p1 = tiles if n > 0 else 0
        kept = min(tiles, stages) if n > 0 else 0
        out = [("header", v, None, first, False)]
        out += [(1, v, t, first + t, t < tiles - kept) for t in range(p1)]
        out += [(2, v, t, first + j, True)
                for t, j in tap.pass2_order(n, f, stages)]
        return out

    def free(blk, load):
        return load < stages or (load - stages) in blk["released"]

    progress = True
    while progress:
        progress = False
        for bi, blk in enumerate(blocks):
            # The producer: as many loads as the ring takes.
            while not blk["stopped"]:
                if not blk["queue"]:
                    v = blk.setdefault("next", bi)
                    if v is None:
                        if not free(blk, blk["issued"]):
                            break
                        blk["slots"][blk["issued"] % stages] = (
                            blk["issued"], "end")
                        blk["issued"] += 1
                        blk["stopped"] = True
                        progress = True
                        break
                    taken[v] = bi
                    blk["uses"] += uses_of(v, blk["issued"])
                    blk["queue"] = [(v, pt) for pt in
                                    tap.video_loads(nf[v], f, stages)]
                load = blk["issued"]
                if not free(blk, load):
                    break
                blk["slots"][load % stages] = (load, blk["queue"].pop(0))
                blk["issued"] += 1
                progress = True
                if not blk["queue"]:  # the last load issued: take the next
                    blk["next"] = next(nxt, None)
            # The consumers.
            while blk["uses"]:
                kind, v, t, load, release = blk["uses"][0]
                if load >= blk["issued"]:
                    break
                have_load, content = blk["slots"][load % stages]
                assert have_load == load, "a stage was overwritten too early"
                if kind == "header":
                    blk["floor"] = load
                    blk["pass1"] = set()
                    for w in range(tap.WARPS):
                        blk["known"][w] = {load}
                elif kind == 2 and blk["pass1"]:  # the end of pass 1
                    for w in range(tap.WARPS):
                        blk["known"][w] |= blk["pass1"]
                    blk["pass1"] = set()
                slot = load % stages
                for w in ([slot] if kind == 1 else range(tap.WARPS)):
                    prev = load - stages
                    assert (prev < blk["floor"] or prev in blk["known"][w]), (
                        "a wait two phases ahead")
                    blk["known"][w].add(load)
                if kind == 1:
                    blk["pass1"].add(load)
                if kind != "header":
                    assert content == (v, (1 if kind == 1 else 2, t)) or (
                        kind == 2 and content == (v, (1, t)))
                    rows = f if nf[v] <= 0 else min(nf[v], f)
                    reads[v][kind] += range(tap.ROWS * t,
                                            min(tap.ROWS * (t + 1), rows))
                if release:
                    blk["released"].add(load)
                blk["uses"].pop(0)
                progress = True
    assert all(b["stopped"] and not b["uses"] for b in blocks), "deadlock"
    return taken, reads


@pytest.mark.parametrize("b,f,stages,grid", [
    (512, 300, 10, 132), (512, 300, 2, 132), (40, 300, 10, 3),
    (7, 13, 12, 132), (300, 40, 2, 5), (64, 300, 12, 1)])
def test_attention_walk_covers_each_video_and_row_once(b, f, stages, grid):
    g = np.random.default_rng(b + f + stages)
    nf = g.integers(1, f + 1, size=b)
    nf[:5] = [f, 1, 0, -2, 3 * f][:min(b, 5)]
    taken, reads = walk(nf, f, stages, min(grid, b))
    assert sorted(taken) == list(range(b))
    for v, n in enumerate(nf):
        rows = f if n <= 0 else min(n, f)
        assert sorted(reads[v][2]) == list(range(rows))
        assert sorted(reads[v][1]) == (list(range(rows)) if n > 0 else [])


def test_attention_video_loads_read_long_videos_twice_short_ones_once():
    assert tap.video_loads(160, 300, 10) == [(1, t) for t in range(10)]
    assert tap.video_loads(161, 300, 10) == (
        [(1, t) for t in range(11)] + [(2, 0)])
    assert tap.video_loads(0, 300, 10) == [(2, t) for t in range(19)]
    assert tap.pass2_order(300, 300, 10)[:2] == [(9, 9), (10, 10)]
    assert tap.pass2_order(300, 300, 10)[-1] == (8, 27)


# ---------------------------------------------------------------------------
# Attention pooling: the tiled decomposition
# ---------------------------------------------------------------------------


def test_dequantize_as_one_fma_is_the_two_rounding_affine():
    """fma(2^23 + u, s, -2^23 s) + b (the kernel) equals (u * s) + b with
    both roundings (the plain version) for every byte, before and after
    the bf16 rounding."""
    u = np.arange(256)
    s, bias = np.float32(DEQUANT_SCALE), np.float32(DEQUANT_BIAS)
    magic = np.float64(2.0 ** 23)
    fma = ((magic + u) * np.float64(s) - magic * np.float64(s)).astype(
        np.float32)
    kernel = (fma + bias).astype(np.float32)
    plain = (u.astype(np.float32) * s).astype(np.float32) + bias
    np.testing.assert_array_equal(kernel.view(np.int32),
                                  plain.view(np.int32))
    plain_t = torch.from_numpy(u.astype(np.float32)) * DEQUANT_SCALE \
        + DEQUANT_BIAS
    assert torch.equal(_bf(torch.from_numpy(kernel)), _bf(plain_t))


def tiled_attention(frames, num_frames, query, stages):
    """The kernel's decomposition: (pooled [B, H, D], its bf16 attention
    [B, F, H]). Pass 1 a 16-frame tile at a time, each 64-column chunk's
    four k16 steps over the kernel's columns 16 q + 4 i + {0..3} (q the
    thread's quad index), a step's 16 exact products rounded once into
    its chain, the four chains summed (c0 + c1) + (c2 + c3); the softmax
    over the live rows; pass 2 by tiles in pass2_order, a tile's 16 exact
    products into the f32 sum."""
    b, f, d = frames.shape
    h = query.shape[1]
    dp = tap.padded_columns(d, frames.dtype)
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x * DEQUANT_SCALE + DEQUANT_BIAS
    xb = torch.nn.functional.pad(_bf(x), (0, dp - d)).double()
    qb = torch.nn.functional.pad(_bf(query), (0, 0, 0, dp - d)).double()
    out = torch.zeros(b, h, dp)
    attn_all = torch.zeros(b, f, h)
    steps = [[tap.CHUNK * j + 16 * q + 4 * i + e for q in range(4)
              for e in range(4)] for j in range(dp // tap.CHUNK)
             for i in range(4)]
    for v in range(b):
        n = int(num_frames[v])
        rows = f if n <= 0 else min(n, f)
        tiles = -(-rows // tap.ROWS)
        if n > 0:
            scores = torch.zeros(rows, h)
            for t in range(tiles):
                fr = slice(tap.ROWS * t, min(tap.ROWS * (t + 1), rows))
                chains = [torch.zeros(fr.stop - fr.start, h) for _ in range(4)]
                for s, cols in enumerate(steps):
                    part = (xb[v, fr][:, cols] @ qb[cols]).float()
                    chains[s % 4] = chains[s % 4] + part
                scores[fr] = (chains[0] + chains[1]) + (chains[2] + chains[3])
            e = torch.exp(scores - scores.max(0).values)
            attn = _bf(e / e.sum(0))
        else:
            attn = _bf(torch.full((rows, h), 1.0 / f))
        attn_all[v, :rows] = attn
        acc = torch.zeros(h, dp)
        for t, _ in tap.pass2_order(n, f, stages):
            fr = slice(tap.ROWS * t, min(tap.ROWS * (t + 1), rows))
            acc = acc + (attn[fr].double().T @ xb[v, fr]).float()
        out[v] = acc
    return out[..., :d].contiguous(), attn_all


def _attention_args(seed, b, f, d, h, x_dtype):
    g = torch.Generator().manual_seed(seed)
    if x_dtype == torch.uint8:
        x = torch.randint(0, 256, (b, f, d), generator=g, dtype=torch.uint8)
    else:
        x = torch.randn(b, f, d, generator=g)
    nf = torch.randint(1, f + 1, (b,), generator=g, dtype=torch.int32)
    nf[: min(b, 3)] = torch.tensor([f, 1, 0], dtype=torch.int32)[: min(b, 3)]
    q = (torch.randn(d, h, generator=g) * d ** -0.5).to(torch.bfloat16)
    return x, nf, q


def _plain_attention_weights(frames, nf, query):
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x * DEQUANT_SCALE + DEQUANT_BIAS
    scores = torch.matmul(_bf(x), _bf(query))
    live = torch.arange(frames.shape[1])[None, :] < nf[:, None]
    scores = torch.where(live[..., None], scores, -1e9)
    return _bf(torch.softmax(scores, dim=1)), live | (nf <= 0)[:, None]


ATTN_SHAPES = [(5, 13, 32, 4), (3, 70, 1001, 3), (4, 20, 64, 16),
               (2, 1, 8, 1), (3, 40, 1152, 8), (4, 45, 128, 2)]


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
@pytest.mark.parametrize("b,f,d,h", ATTN_SHAPES)
def test_attention_tiling_equals_the_plain_version(b, f, d, h, x_dtype):
    args = _attention_args(b + f + d + h, b, f, d, h, x_dtype)
    p = tap.plan(f, tap.padded_columns(d, x_dtype), h, x_dtype)
    for stages in (p["stages"], 2):  # the plan's ring, and a shallow one
        got, attn = tiled_attention(*args, stages)
        want = tap.attention_pool_plain(*args)
        plain_attn, read = _plain_attention_weights(*args)
        if torch.equal(torch.where(read[..., None], attn, 0.0),
                       torch.where(read[..., None], plain_attn, 0.0)):
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item() + 1e-6, err
        else:
            r = tap.rounding_limit(*args, got, want)
            assert r.explained and r.away == 0, r[1:]
            assert torch.all((got - want).abs() <= r.limit)


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_attention_tiling_ignores_frames_past_num_frames(x_dtype):
    x, nf, q = _attention_args(9, 4, 40, 64, 8, x_dtype)
    past = torch.arange(40)[None, :] >= nf[:, None]
    past[2] = False  # the empty video reads all its rows
    loud = 255 if x_dtype == torch.uint8 else 1e4
    clean = x.masked_fill(past[..., None], 0)
    noisy = torch.where(past[..., None], torch.as_tensor(loud, dtype=x.dtype),
                        x)
    assert torch.equal(tiled_attention(clean, nf, q, 2)[0],
                       tiled_attention(noisy, nf, q, 2)[0])


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_attention_tiling_matches_jax_kernel(x_dtype):
    x, nf, q = _attention_args(11, 4, 37, 96, 8, x_dtype)
    got, _ = tiled_attention(x, nf, q, 2)
    want = np.asarray(jax_pool(jnp.asarray(x.numpy()), jnp.asarray(nf.numpy()),
                               jnp.asarray(q.float().numpy()),
                               interpret=True))
    for v in range(4):
        if int(nf[v]) < 1:
            continue
        err = np.abs(got[v].numpy() - want[v]).max()
        assert err <= 2e-2 * np.abs(want[v]).max(), (v, err)
