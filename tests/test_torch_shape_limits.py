"""The shapes the card's kernels used to refuse, and --moe_head_pallas=false.

On the CPU every wrapper runs its plain version; these tests hold those
plain versions at the new shapes against the JAX package's Pallas kernels
in interpret mode, walk the card kernels' new tilings in plain PyTorch
(the MoE head's run-time tile and its chunks of mixtures, the K-tiled
NetVLAD assignment, the wide backward of netvlad_core) against the plain
versions, check the launch plans at the new shapes, and hold the models'
plain MoE head (--moe_head_pallas=false) against the JAX models with
saturated gates. Tolerances:
  * the MoE head against JAX's kernel: 1e-5 * max|ref| + 1e-7 at bf16
    (tests/test_torch_hopper_tiles.py's bound: the same roundings,
    another summation order), 1e-5 * max|ref| + 1e-6 at f32;
  * netvlad_aggregate against JAX's kernel: 2^-8 * max|ref|, the card's
    NetVLAD bound (tests/test_torch_cuda.py): with K = 520 and 1024 the
    f32 softmax's sum over K in another order moves some assignments
    across a bf16 rounding boundary, one bf16 step of an operand (2.6e-5
    of max|ref| 0.026 read at K = 520; tests/test_torch_netvlad.py's 1e-5
    holds at K = 8, where no value sits that close to a boundary);
  * netvlad_core against JAX's kernel and custom VJP: 3e-3 * max(1,
    max|ref|) (tests/test_torch_netvlad_train.py's bf16 bound);
  * the tilings against the plain versions: 1e-5 * max|ref| + 1e-6 (f32
    sums in another order; both round the same operands);
  * the models' plain head against JAX's: 1e-5 * max|ref| + 1e-6 at
    float32 compute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.moe_head import moe_head_serving as jax_moe
from yt8m_tpu.kernels.netvlad import netvlad_aggregate as jax_netvlad
from yt8m_tpu.kernels.netvlad_train import _run_fwd as jax_core_forward
from yt8m_tpu.kernels.netvlad_train import netvlad_core as jax_core
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.kernels import moe_head as tmoe
from yt8m_tpu_torch.kernels import netvlad as tvlad
from yt8m_tpu_torch.kernels import netvlad_train as tnt
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.models import frame_utils as tfu

SMEM_LIMIT = 232448  # shared memory a block can use on an H100


def _err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)), np.max(np.abs(want))


def _close(got, want, rel, abs_):
    err, top = _err(got, want)
    assert err <= rel * top + abs_, err


# ---------------------------------------------------------------------------
# The MoE head at M > 16.
# ---------------------------------------------------------------------------


def _moe_inputs(seed, b, h, c, m):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(b, h))).astype(np.float32)
    wg = (rng.normal(size=(h, c * (m + 1))) / np.sqrt(h)).astype(np.float32)
    we = (rng.normal(size=(h, c * m)) / np.sqrt(h)).astype(np.float32)
    be = (rng.normal(size=(c * m,)) * 0.1).astype(np.float32)
    return x, wg, we, be


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m", [17, 32, 135])
def test_moe_plain_matches_jax_kernel_at_many_mixtures(m, dtype):
    x, wg, we, be = _moe_inputs(m, 9, 32, 20, m)
    tdt = getattr(torch, dtype)
    got = tmoe.moe_head_serving(
        torch.from_numpy(x), tmoe.pitched(torch.from_numpy(wg).to(tdt)),
        tmoe.pitched(torch.from_numpy(we).to(tdt)), torch.from_numpy(be), m)
    want = jax_moe(*map(jnp.asarray, (x, wg, we, be)), m,
                   dtype=getattr(jnp, dtype), interpret=True, block_b=16,
                   block_c=8)
    _close(got.numpy(), np.asarray(want), 1e-5,
           1e-7 if dtype == "bfloat16" else 1e-6)


def _gather_cols(w, start, n):
    """Columns start .. start + n - 1 of w, zeros past its edge (TMA's and
    the f32 loader's zero fill)."""
    out = torch.zeros(w.shape[0], n, dtype=torch.float32)
    stop = min(start + n, w.shape[1])
    if stop > start:
        out[:, :stop - start] = w[:, start:stop].float()
    return out


def moe_runtime_tile(x, wg, we, be, m):
    """csrc/moe_head.cu's bf16 kernel in plain PyTorch at M <= 121 (the
    run-time tile) or M > 121 (chunks of 120 mixtures of one class): each
    block's gate chain (136 columns) and expert chain (128) loaded from
    its first columns rounded down to 8 (TMA's box starts), then its
    combine at the offsets, with the kernel's masks."""
    b, c = x.shape[0], wg.shape[1] // (m + 1)
    gate, expert = tmoe.RUNTIME_CHAINS
    align = tmoe.ALIGN_COLS
    xa = x.to(torch.bfloat16).float()
    out = torch.empty(b, c)
    if m <= tmoe.RUNTIME_MIXTURES:
        nc = tmoe.runtime_classes(m)
        for c0 in range(0, c, nc):
            g0, e0 = c0 * (m + 1), c0 * m
            rg, re = g0 % align, e0 % align
            g = xa @ _gather_cols(wg, g0 - rg, gate)
            e = xa @ _gather_cols(we, e0 - re, expert)
            assert rg + nc * (m + 1) <= gate and re + nc * m <= expert
            for k in range(min(nc, c - c0)):
                gk = g[:, rg + k * (m + 1):rg + (k + 1) * (m + 1)]
                ek = (e[:, re + k * m:re + (k + 1) * m]
                      + be[(c0 + k) * m:(c0 + k + 1) * m])
                eg = torch.exp(torch.clamp(gk, -80, 80))
                out[:, c0 + k] = (torch.sum(eg[:, :m] * torch.sigmoid(ek), 1)
                                  / torch.sum(eg, 1))
        return out
    step = tmoe.CHUNK_MIXTURES
    chunks = -(-m // step)
    for cls in range(c):
        num = torch.zeros(b)
        den = torch.zeros(b)
        for j in range(chunks):
            mix0 = j * step
            g0, e0 = cls * (m + 1) + mix0, cls * m + mix0
            rg, re = g0 % align, e0 % align
            g = xa @ _gather_cols(wg, g0 - rg, gate)
            e = xa @ _gather_cols(we, e0 - re, expert)
            u = torch.arange(gate) - rg  # the chunk's gate u at column u + rg
            ok = (u >= 0) & (mix0 + u <= m) & ((u < step) | (j == chunks - 1))
            eg = torch.where(ok, torch.exp(torch.clamp(g, -80, 80)), 0.0)
            den += eg.sum(1)
            u = torch.arange(expert) - re  # expert u at column u + re
            ok = (u >= 0) & (u < step) & (mix0 + u < m)
            idx = torch.clamp(u, 0, step - 1)
            gate_of = eg[:, torch.clamp(idx + rg, max=gate - 1)]
            bias = be[cls * m + torch.clamp(mix0 + idx, max=m - 1)]
            num += torch.where(ok, gate_of * torch.sigmoid(e + bias),
                               0.0).sum(1)
        out[:, cls] = num / den
    return out


def moe_f32_tiles(x, wg, we, be, m):
    """The f32 route's tiling in plain PyTorch: the bf16 route's tiles
    (tmoe.plan(..., f32=True)), each chain loaded from the block's exact
    first gate and expert columns (K-major rows: no rounded start), the
    run-time tile at min(136 / (M + 1), 128 / M) classes, above M = 121
    one class in chunks of 120 mixtures in chains of 128 and 120 columns,
    with the kernel's masks."""
    b, h = x.shape
    c = wg.shape[1] // (m + 1)
    p = tmoe.plan(b, h, c, m, f32=True)
    gate, expert = p["gate"], p["expert"]
    out = torch.empty(b, c)
    if p["chunks"] == 1:
        nc = p["classes"]
        for c0 in range(0, c, nc):
            g = x @ _gather_cols(wg, c0 * (m + 1), gate)
            e = x @ _gather_cols(we, c0 * m, expert)
            assert nc * (m + 1) <= gate and nc * m <= expert
            for k in range(min(nc, c - c0)):
                gk = g[:, k * (m + 1):(k + 1) * (m + 1)]
                ek = (e[:, k * m:(k + 1) * m]
                      + be[(c0 + k) * m:(c0 + k + 1) * m])
                eg = torch.exp(torch.clamp(gk, -80, 80))
                out[:, c0 + k] = (torch.sum(eg[:, :m] * torch.sigmoid(ek), 1)
                                  / torch.sum(eg, 1))
        return out
    step = tmoe.CHUNK_MIXTURES
    chunks = p["chunks"]
    assert step + 1 <= gate and step <= expert
    for cls in range(c):
        num = torch.zeros(b)
        den = torch.zeros(b)
        for j in range(chunks):
            mix0 = j * step
            g = x @ _gather_cols(wg, cls * (m + 1) + mix0, gate)
            e = x @ _gather_cols(we, cls * m + mix0, expert)
            u = torch.arange(gate)  # the chunk's gate u at column u
            ok = (mix0 + u <= m) & ((u < step) | (j == chunks - 1))
            eg = torch.where(ok, torch.exp(torch.clamp(g, -80, 80)), 0.0)
            den += eg.sum(1)
            u = torch.arange(expert)  # expert u at column u, its gate too
            ok = mix0 + u < m
            bias = be[cls * m + torch.clamp(mix0 + u, max=m - 1)]
            num += torch.where(ok, eg[:, :expert] * torch.sigmoid(e + bias),
                               0.0).sum(1)
        out[:, cls] = num / den
    return out


@pytest.mark.parametrize("m", [3, 16, 17, 32, 63, 64, 121, 122, 128, 200,
                               240, 241])
def test_moe_tilings_match_the_plain_version(m):
    """Both routes' tilings: every offset of a start rounded down to 8 on
    the bf16 route, exact starts on the f32 route, and the dummy gate
    alone in the last chunk (M = 240)."""
    b, h, c = 5, 16, 7
    x, wg, we, be = map(torch.from_numpy, _moe_inputs(m + 1, b, h, c, m))
    wg = wg * 40  # gate logits past +-80 on some columns: the clamp acts
    for dtype, tiled in ((torch.bfloat16, moe_runtime_tile),
                         (torch.float32, moe_f32_tiles)):
        g, e = wg.to(dtype), we.to(dtype)
        want = tmoe.moe_head_plain(x, g, e, be, m)
        _close(tiled(x, g, e, be, m).numpy(), want.numpy(), 1e-5, 1e-6)


@pytest.mark.parametrize("m", [17, 31, 32, 63, 64, 100, 121, 122, 200, 256,
                               1000])
def test_moe_plan_at_many_mixtures(m):
    for b, h, c in ((512, 2048, 4716), (37, 96, 83)):
        p = tmoe.plan(b, h, c, m)
        assert p["smem"] <= SMEM_LIMIT
        assert p["classes"] >= 1 and p["chunks"] >= 1
        assert p["gate_cols"] <= p["gate"] and p["expert_cols"] <= p["expert"]
        # Past the offset of a start rounded down to 8 columns.
        assert p["gate_cols"] + p["offset"] <= p["gate"]
        assert p["expert_cols"] + p["offset"] <= p["expert"]
        if p["chunks"] == 1:
            assert p["classes"] * m <= 128  # the bias slot
        else:
            assert p["classes"] == 1 and p["stages"] >= 2
            assert (p["chunks"] - 1) * tmoe.CHUNK_MIXTURES < m <= \
                p["chunks"] * tmoe.CHUNK_MIXTURES
        gb, gc = p["grid"]
        assert (gc - 1) * p["classes"] < c <= gc * p["classes"] <= 65535 * 128
        # The f32 route: the same tiles from exact starts, as many classes
        # a block or more, its ring within the card's shared memory.
        f = tmoe.plan(b, h, c, m, f32=True)
        assert f["smem"] <= SMEM_LIMIT and f["stages"] >= 2
        assert f["offset"] == 0 and f["chunks"] == p["chunks"]
        assert f["gate_cols"] <= f["gate"] and f["expert_cols"] <= f["expert"]
        assert f["classes"] >= p["classes"]
        assert f["staged_bytes"] <= f["ring_bytes"]
    assert tmoe.plan(512, 2048, 4716, 32)["classes"] == 3
    assert tmoe.plan(512, 2048, 4716, 32, f32=True)["classes"] == 4


# ---------------------------------------------------------------------------
# NetVLAD serving at K > 512.
# ---------------------------------------------------------------------------

B, F, D = 4, 13, 32
NUM_FRAMES = np.array([13, 1, 0, 7], np.int32)


def _vlad_inputs(seed, x_dtype, k):
    rng = np.random.default_rng(seed)
    if x_dtype == "uint8":
        x = rng.integers(0, 256, size=(B, F, D), dtype=np.uint8)
    else:
        x = rng.normal(size=(B, F, D)).astype(np.float32)
    wc = (rng.normal(size=(D, k)) / np.sqrt(D)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = (0.3 * rng.normal(size=k)).astype(np.float32)
    centers = (rng.normal(size=(k, D)) / np.sqrt(D)).astype(np.float32)
    return x, NUM_FRAMES, wc, scale, bias, centers


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("k", [520, 1024])
def test_netvlad_plain_matches_jax_kernel_at_many_clusters(k, x_dtype):
    args = _vlad_inputs(k, x_dtype, k)
    x, nf, wc, scale, bias, centers = map(torch.from_numpy, args)
    got = tvlad.netvlad_aggregate(x, nf, wc.to(torch.bfloat16), scale, bias,
                                  centers).numpy()
    frames = tfu.ensure_float(x).numpy()
    want = jax_netvlad(*map(jnp.asarray, (frames,) + args[1:]),
                       interpret=True)
    _close(got, np.asarray(want), 2.0 ** -8, 0)
    assert np.all(got[2] == 0)  # num_frames 0


def test_netvlad_plain_float32_compute_matches_jax_kernel_at_520():
    args = _vlad_inputs(5, "float32", 520)
    got = tvlad.netvlad_aggregate(*map(torch.from_numpy, args)).numpy()
    want = jax_netvlad(*map(jnp.asarray, args), interpret=True,
                       dtype=jnp.float32)
    _close(got, np.asarray(want), 1e-5, 1e-8)


def netvlad_wide_assignment(frames, num_frames, cluster_w, act_scale,
                            act_bias):
    """csrc/netvlad.cu's K > 512 launches 1a and 1b in plain PyTorch: the
    logits of each live 64-frame chunk tiled over 256 clusters, then each
    chunk's rows normalised over all K (rows past num_frames zero). ->
    (bf16 assignment [B, F, K], column sums [B, chunks, K])."""
    x, _ = tvlad.netvlad_assign_plain(frames, num_frames, cluster_w,
                                      act_scale, act_bias)
    b, f, _ = x.shape
    k = cluster_w.shape[1]
    w = cluster_w.float()
    p = tvlad.plan(b, f, max(128, x.shape[2]), k)
    chunks = p["chunks"]
    assign = torch.zeros(b, f, k, dtype=torch.bfloat16)
    colsum = torch.zeros(b, chunks, k)
    for item in tvlad.live_items(num_frames, f).tolist():
        v, c = divmod(item, chunks)
        f0 = c * tvlad.FRAME_CHUNK
        end = min(f0 + tvlad.FRAME_CHUNK, f)
        live = min(max(int(num_frames[v]), 0), f)
        logits = torch.empty(end - f0, k)
        for kt in range(p["assign_cluster_tiles"]):
            ks = slice(kt * 256, min((kt + 1) * 256, k))
            logits[:, ks] = (x[v, f0:end] @ w[:, ks]) * act_scale[ks] \
                + act_bias[ks]
        e = torch.exp(logits - logits.amax(1, keepdim=True))
        a = e / e.sum(1, keepdim=True)
        a[max(live - f0, 0):] = 0
        assign[v, f0:end] = a.to(torch.bfloat16)
        colsum[v, c] = a.sum(0)
    return assign, colsum


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
def test_netvlad_wide_assignment_matches_the_plain_version(x_dtype):
    args = _vlad_inputs(3, x_dtype, 1024)
    x, nf, wc, scale, bias, _ = map(torch.from_numpy, args)
    wc = wc.to(torch.bfloat16)
    assign, colsum = netvlad_wide_assignment(x, nf, wc, scale, bias)
    _, want = tvlad.netvlad_assign_plain(x, nf, wc, scale, bias)
    _close(colsum.sum(1).numpy(), want.sum(1).numpy(), 1e-5, 1e-6)
    differ = assign != want.to(torch.bfloat16)
    # A last-bit difference of the f32 softmax moves a bf16 value one step.
    a, w = assign[differ].float(), want[differ].to(torch.bfloat16).float()
    assert torch.all((a - w).abs() <= 2.0 ** -7 * torch.maximum(a, w))


@pytest.mark.parametrize("k", [520, 1024, 2048, 4096])
@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_netvlad_plan_at_many_clusters(k, x_dtype):
    b, f, d = 512, 300, 1152
    p = tvlad.plan(b, f, d, k, x_dtype)
    assert p["wide"] and p["clusters_a_warpgroup"] == 256 and not p["split"]
    assert p["assign_smem"] <= SMEM_LIMIT and p["assign_stages"] >= 2
    assert p["agg_smem"] <= SMEM_LIMIT
    assert (p["assign_cluster_tiles"] - 1) * 256 < k <= \
        p["assign_cluster_tiles"] * 256
    assert p["logits_floats"] == b * f * k
    assert 0 < p["assign_grid"] <= tvlad.SMS and 0 < p["softmax_grid"]
    assert p["agg_cluster_tiles"] * tvlad.AGG_CLUSTERS >= k
    assert p["work"] == b * (d // tvlad.D_TILE + 2) * k + b
    # K <= 512 keeps its assignment launch.
    assert not tvlad.plan(b, f, d, 512, x_dtype)["wide"]


# ---------------------------------------------------------------------------
# netvlad_core at K > 512.
# ---------------------------------------------------------------------------

CB, CF, CD, CK = 4, 11, 16, 520
BF16 = 3e-3


def _core_inputs(seed):
    rng = np.random.default_rng(seed)
    act = rng.normal(size=(CB, CF, CK)).astype(np.float32)
    x = rng.normal(size=(CB, CF, CD)).astype(np.float32)
    nf = np.array([CF, 4, 1, 0], dtype=np.int32)
    centers = rng.normal(size=(CK, CD)).astype(np.float32)
    dvlad = rng.normal(size=(CB, CK, CD)).astype(np.float32)
    return act, x, nf, centers, dvlad


def test_netvlad_core_plain_forward_matches_jax_kernel_at_520():
    act, x, nf, centers, _ = _core_inputs(0)
    jv, ja = jax_core_forward(jnp.asarray(act), jnp.asarray(x),
                              jnp.asarray(nf), jnp.asarray(centers), True)
    vlad, a_sum = tnt.netvlad_core_forward(
        *map(torch.from_numpy, (act, x, nf, centers)))
    _close(vlad.numpy(), np.asarray(jv), BF16, 0)
    _close(a_sum.numpy(), np.asarray(ja)[:, 0], BF16, 0)
    assert np.all(vlad.numpy()[3] == 0) and np.all(a_sum.numpy()[3] == 0)


def test_netvlad_core_plain_backward_matches_jax_vjp_at_520():
    act, x, nf, centers, dvlad = _core_inputs(1)
    _, vjp = jax.vjp(
        lambda a, xx, c: jax_core(a, xx, jnp.asarray(nf), c, True),
        jnp.asarray(act), jnp.asarray(x), jnp.asarray(centers))
    want = vjp(jnp.asarray(dvlad))
    t = [torch.from_numpy(v) for v in (act, x, nf, centers, dvlad)]
    ta = t[0].clone().requires_grad_()
    tx = t[1].clone().requires_grad_()
    tc = t[3].clone().requires_grad_()
    (tnt.netvlad_core(ta, tx, t[2], tc) * t[4]).sum().backward()
    for got, w in zip((ta.grad, tx.grad, tc.grad), want):
        err, top = _err(got.numpy(), np.asarray(w))
        assert err <= BF16 * max(1.0, top), err
    past = np.arange(CF)[None, :] >= nf[:, None]
    assert np.all(ta.grad.numpy()[past] == 0)
    assert np.all(tx.grad.numpy()[past] == 0)


def netvlad_core_wide_backward(act, x, num_frames, centers, dvlad):
    """csrc/netvlad_train.cu's K > 512 backward in plain PyTorch: dassign
    (bf16 operands, f32 sums, minus cdot) over tiles of 512 clusters into
    dact on the live rows, then the row launch's softmax VJP over all K.
    -> (dact, bf16(assign))."""
    b, f, k = act.shape
    p = tnt.plan(b, f, k, x.shape[2])
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    cdot = torch.sum(centers[None] * dvlad, -1)
    dact = torch.zeros(b, f, k)
    for t in range(p["bwd_tiles"]):
        v, frames = tnt.bwd_tile_of(t, p)
        ks = tnt.bwd_clusters_of(t, p)
        live = min(max(int(num_frames[v]), 0), f)
        rows = slice(frames.start, min(frames.stop, live))
        cols = slice(ks.start, min(ks.stop, k))
        if rows.start >= rows.stop or cols.start >= cols.stop:
            continue
        dact[v, rows, cols] = (bf(x[v, rows]) @ bf(dvlad[v, cols]).T
                               - cdot[v, cols])
    assign = tnt.masked_assignment(act, num_frames)
    tt = torch.sum(assign * dact, -1, keepdim=True)
    return assign * (dact - tt), bf(assign)


def test_netvlad_core_wide_backward_matches_the_plain_version():
    act, x, nf, centers, dvlad = map(torch.from_numpy, _core_inputs(2))
    want, want_dx = tnt.netvlad_core_plain_backward(act, x, nf, centers,
                                                    dvlad)
    got, p16 = netvlad_core_wide_backward(act, x, nf, centers, dvlad)
    _close(got.numpy(), want.numpy(), 1e-5, 1e-6)
    _close((p16 @ dvlad.to(torch.bfloat16).float()).numpy(),
           want_dx.numpy(), 1e-5, 1e-6)


@pytest.mark.parametrize("k", [520, 1024, 2048, 19285])
def test_netvlad_core_plan_at_many_clusters(k):
    b, f, d = 256, 300, 1152
    p = tnt.plan(b, f, k, d)
    assert p["wide"] and p["kh"] == 256
    assert 1 <= p["assign_rows"] <= tnt.ASSIGN_ROWS
    # The dynamic buffers plus the static row statistics (2 x 32 floats).
    assert p["assign_smem"] + 2 * tnt.ASSIGN_ROWS * 4 <= SMEM_LIMIT
    assert p["fwd_smem"] <= SMEM_LIMIT and p["bwd_smem"] <= SMEM_LIMIT
    assert (p["bwd_cluster_tiles"] - 1) * 512 < k <= \
        p["bwd_cluster_tiles"] * 512
    assert p["bwd_tiles"] == b * p["bwd_frame_tiles"] * p["bwd_cluster_tiles"]
    assert p["softmax_blocks"] * 8 >= b * f
    assert tnt.assign_rows(tnt.max_clusters() + 1) == 0
    assert tnt.plan(b, f, 512, d)["assign_rows"] == tnt.ASSIGN_ROWS


def test_netvlad_core_wide_tiles_cover_every_row_and_cluster_once():
    b, f, k, d = 3, 130, 1100, 64
    p = tnt.plan(b, f, k, d, sms=7)
    seen = np.zeros((b, p["bwd_frame_tiles"], p["bwd_cluster_tiles"]),
                    np.int32)
    for blk in range(p["bwd_grid"]):
        for t in range(blk, p["bwd_tiles"], p["bwd_grid"]):
            video, frames = tnt.bwd_tile_of(t, p)
            ks = tnt.bwd_clusters_of(t, p)
            seen[video, frames.start // tnt.FRAMES, ks.start // 512] += 1
    assert (seen == 1).all()


def test_netvlad_core_refuses_what_one_block_cannot_stage(monkeypatch):
    k = tnt.max_clusters() + 1
    act = torch.zeros(1, 2, k)
    monkeypatch.setattr(tnt, "on_cpu", lambda *ts: False)
    with pytest.raises(ValueError, match=f"K <= {k - 1}"):
        tnt.netvlad_core_forward(act, torch.zeros(1, 2, 8),
                                 torch.ones(1, dtype=torch.int32),
                                 torch.zeros(k, 8))


# ---------------------------------------------------------------------------
# --moe_head_pallas=false: the JAX model's plain head.
# ---------------------------------------------------------------------------

MB, MF, MD, MC, MM = 5, 6, 16, 7, 3
MOE_HEADS = {"MoeModel": "tower", "ChainMoeModel": "chain/stage0",
             "DbofModel": "video_classifier"}


def _hp(cls, pallas, **kw):
    return cls(vocab_size=MC, feature_dim=MD, max_frames=MF,
               moe_num_mixtures=MM, moe_head_pallas=pallas,
               compute_dtype="float32", chain_stages=3, chain_hidden_size=16,
               dbof_cluster_size=32, dbof_hidden_size=16, iterations=MF,
               sample_random_frames=False, **kw)


def _saturated(variables, head):
    """Gate 0 and the dummy gate of class 0 planted at 1000 and 800 times
    the sum of the head's (non-negative) inputs: both logits far past 80,
    20% apart, so the exact softmax gives the dummy ~0 and the clamped
    ratio gives it half."""
    params = jax.tree_util.tree_map(np.array, variables["params"])
    node = params
    for key in head.split("/"):
        node = node[key]
    node["gates_kernel"][:, 0] = 1000.0
    node["gates_kernel"][:, MM] = 800.0
    return {**variables, "params": params}


@pytest.mark.parametrize("name", sorted(MOE_HEADS))
def test_moe_head_pallas_false_serves_the_plain_head(name):
    frame = name == "DbofModel"
    rng = np.random.default_rng(0)
    if frame:
        feats = rng.integers(0, 256, size=(MB, MF, MD), dtype=np.uint8)
    else:
        feats = np.abs(rng.normal(size=(MB, MD))).astype(np.float32) + 0.5
    nf = np.full(MB, MF, np.int32)
    jmodel = jax_get_model(name, _hp(JaxHParams, False))
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(feats), jnp.asarray(nf), train=False)
    variables = _saturated(variables, MOE_HEADS[name])
    want = np.asarray(jmodel.apply(
        variables, jnp.asarray(feats), jnp.asarray(nf), train=False,
        rngs={"sample": jax.random.PRNGKey(3)})["predictions"])
    got = {}
    for pallas in (False, True):
        model = get_model(name, _hp(ModelHParams, pallas))
        model.load_state_dict(state_dict_from_jax(variables))
        model.eval()
        with torch.no_grad():
            got[pallas] = model(torch.from_numpy(feats),
                                torch.from_numpy(nf))["predictions"].numpy()
    _close(got[False], want, 1e-5, 1e-6)
    # The kernel's clamped ratio (the flag on) is another function here:
    # 100x the bound above at least (the chain's later stages dilute
    # stage 0's saturated class).
    err, top = _err(got[True], want)
    assert err > 1e-3 * top, err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flagship_at_520_clusters_and_17_mixtures_matches_jax(dtype,
                                                              monkeypatch):
    """NetVladLstmModel with K = 520 and M = 17, serving and training
    forwards, against the JAX model (its Pallas kernels in interpret mode
    at bf16), with tests/test_torch_zoo.py's bounds."""
    import test_torch_zoo as zoo

    zoo._compare("NetVladLstmModel", dtype, monkeypatch,
                 netvlad_cluster_size=520, moe_num_mixtures=17)


# ---------------------------------------------------------------------------
# NeXtVLAD at K > 256 (rows 15 and 16).
# ---------------------------------------------------------------------------

from yt8m_tpu.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE  # noqa: E402
from yt8m_tpu.kernels.nextvlad import (  # noqa: E402
    nextvlad_aggregate as jax_nextvlad,
)
from yt8m_tpu.kernels.nextvlad_train import (  # noqa: E402
    nextvlad_aggregate_train as jax_nextvlad_train,
)
from yt8m_tpu_torch.kernels import nextvlad as tnv  # noqa: E402
from yt8m_tpu_torch.kernels import nextvlad_train as tnvt  # noqa: E402

NXV_B, NXV_F, NXV_D, NXV_LAM, NXV_G = 4, 10, 16, 2, 4
NXV_FRAMES = np.array([10, 4, 1, 0], np.int32)
NXV_BF16 = 3e-3  # tests/test_torch_nextvlad*.py's bound


def _nxv_inputs(seed, x_dtype, k):
    rng = np.random.default_rng(seed)
    d, g = NXV_D, NXV_G
    de = NXV_LAM * d
    if x_dtype == "uint8":
        x = rng.integers(0, 256, size=(NXV_B, NXV_F, d), dtype=np.uint8)
    else:
        x = rng.normal(size=(NXV_B, NXV_F, d)).astype(np.float32)
    w = [rng.normal(0, 0.1, shape).astype(np.float32) for shape in
         ((d, de), (de, g), (g,), (de, g * k), (k, de // g))]
    return x, NXV_FRAMES, w


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("k", [264, 520])
def test_nextvlad_plain_matches_jax_kernel_at_many_clusters(k, x_dtype):
    """The plain serving version against JAX's kernel in interpret mode:
    3e-3 * max(1, max|ref|), the bound of tests/test_torch_nextvlad.py,
    on the rows whose pre-norm length is not tiny (its angular check on
    those)."""
    import test_torch_nextvlad as serving

    x, nf, w = _nxv_inputs(k + len(x_dtype), x_dtype, k)
    jargs = [jnp.asarray(v) for v in (x, nf, *w)]
    want = np.asarray(jax_nextvlad(*jargs, groups=NXV_G, interpret=True))
    prenorm = np.linalg.norm(np.asarray(
        serving.nextvlad_aggregate_reference(*jargs, groups=NXV_G,
                                             normalize=False)), axis=2)
    got = tnv.nextvlad_aggregate(*map(torch.from_numpy, (x, nf, *w)),
                                 NXV_G).numpy()
    assert got.shape == want.shape == (NXV_B, k, NXV_LAM * NXV_D // NXV_G)
    serving._hold(got, want, prenorm)
    assert np.all(got[3] == 0)


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("k", [264, 520])
def test_nextvlad_train_plain_matches_jax_at_many_clusters(k, x_dtype):
    """The trainable forward and the plain VJP against JAX's
    nextvlad_aggregate_train (its kernels in interpret mode): the forward
    and the five weight gradients within 3e-3 * max(1, max|ref|). Both
    get the frames the port dequantized (the interpret kernel contracts
    the dequantization into one FMA; tests/test_torch_nextvlad_train.py
    holds the port's uint8 path to its path on those frames)."""
    x, nf, w = _nxv_inputs(k + 7, x_dtype, k)
    p = NXV_LAM * NXV_D // NXV_G
    dy = np.random.default_rng(k).normal(size=(NXV_B, k, p)).astype(
        np.float32)
    xj = x if x_dtype == "float32" else tnv.dequantized(
        torch.from_numpy(x)).numpy()
    fwd, vjp = jax.vjp(
        lambda *ws: jax_nextvlad_train(jnp.asarray(xj), jnp.asarray(nf), *ws,
                                       NXV_G, DEQUANT_SCALE, DEQUANT_BIAS,
                                       True, jnp.bfloat16),
        *map(jnp.asarray, w))
    want = [np.asarray(v) for v in vjp(jnp.asarray(dy))]
    t = [torch.from_numpy(v) for v in (xj, nf, *w)]
    ws = [v.clone().requires_grad_() for v in t[2:]]
    out = tnvt.nextvlad_aggregate_train(t[0], t[1], *ws, NXV_G)
    (out * torch.from_numpy(dy)).sum().backward()
    _close(out.detach().numpy(), np.asarray(fwd), NXV_BF16, 0)
    for got, ref, v in zip((v.grad for v in ws), want, w):
        assert got.shape == v.shape
        err, top = _err(got.numpy(), ref)
        assert err <= NXV_BF16 * max(1.0, top), err


def nextvlad_wide_forward(args, g):
    """csrc/nextvlad.cu's K > 256 launches 2a and 2b in plain PyTorch over
    the packed rows: the logits of each (128-row tile, group, 256
    clusters) tile in 64-deep stages (columns past K not written), alpha
    in each group's first cluster tile; then a (64-row half tile, group)
    at a time: each live row's max and sum of exponentials over K, the
    softmax, bf16(assign), zeros past K and on rows that are not live,
    and one column-sum partial a (video, half tile). -> (sm, assign,
    partials, a_sum from the partials, the plan)."""
    import test_torch_nextvlad_tiles as tiles

    x, nf, *w = args
    b, f, d = x.shape
    k = w[3].shape[1] // g
    fw = tnv.forward_plain(*args, g)
    lay = tnv.kernel_layout(*w, g)
    n = lay["dims"]
    kp, pp, p_ = n["Kp"], n["Pp"], n["P"]
    p = tnv.plan(nf, f, d, w[0].shape[1], g, k)
    assert p["wide"] and p["cluster"]["cluster_tiles"] == -(-kp // 256)
    info = tnv.packed_info(nf, f, g)
    xe = tiles._pack(torch.nn.functional.pad(
        fw["xe"].reshape(b, f, g, p_), (0, pp - p_)).reshape(b, f, -1),
        nf, p)
    wc, wa = lay["wc"].float(), lay["wa"].float()
    logits = torch.full((p["cap"], g * kp), float("nan"))
    alpha = torch.full((p["cap"], g), float("nan"))
    for t in range(p["cluster"]["tiles"]):
        nkt = p["cluster"]["cluster_tiles"]
        rt, gg, ct = t // (g * nkt), (t // nkt) % g, t % nkt
        rows = slice(rt * tnv.TILE, (rt + 1) * tnv.TILE)
        c0 = gg * kp + ct * 256
        cols = slice(c0, c0 + min(256, k - ct * 256))
        acc = torch.zeros(tnv.TILE, cols.stop - cols.start)
        dots = torch.zeros(tnv.TILE)
        for d0 in range(0, g * pp, tnv.DEPTH):
            acc += xe[rows, d0:d0 + tnv.DEPTH] @ wc[d0:d0 + tnv.DEPTH, cols]
            dots += xe[rows, d0:d0 + tnv.DEPTH] @ wa[gg, d0:d0 + tnv.DEPTH]
        logits[rows, cols] = acc
        if ct == 0:
            alpha[rows, gg] = torch.sigmoid(dots + lay["ab"][gg])
    sm = torch.full_like(logits, float("nan"))
    assign = torch.full_like(logits, float("nan"))
    part = torch.full((b, p["J"], g, kp), float("nan"))
    for hf in range(p["softmax"]["grid"][0]):
        if hf >= p["softmax"]["blocks"] // g:
            continue
        rows = slice(hf * tnv.HALF, (hf + 1) * tnv.HALF)
        live = info[rows] >= 0
        for gg in range(g):
            cols = slice(gg * kp, gg * kp + k)
            lg = torch.where(live[:, None], logits[rows, cols], 0.0)
            e = torch.exp(lg - lg.amax(1, keepdim=True))
            s = torch.where(live[:, None], e / e.sum(1, keepdim=True), 0.0)
            a = s * torch.where(live, alpha[rows, gg], 0.0)[:, None]
            st, at = torch.zeros(tnv.HALF, kp), torch.zeros(tnv.HALF, kp)
            st[:, :k], at[:, :k] = s, a
            sm[rows, gg * kp:(gg + 1) * kp] = st
            assign[rows, gg * kp:(gg + 1) * kp] = at.to(torch.bfloat16).float()
            videos = [int(v) if v >= 0 else -1 - int(v) for v in info[rows]]
            for v in sorted(set(videos)):
                if v < b:
                    mask = torch.tensor([u == v for u in videos])
                    slot = hf - int(p["poff"][v]) // tnv.HALF
                    part[v, slot, gg] = at[mask].sum(0)
    a_sum = torch.zeros(b, kp)
    for v in range(b):
        r0, r1 = int(p["poff"][v]), int(p["poff"][v + 1])
        for j in range((r1 - 1) // 64 - r0 // 64 + 1 if r1 > r0 else 0):
            a_sum[v] += part[v, j].sum(0)
    return {"sm": sm, "assign": assign, "a_sum": a_sum[:, :k], "info": info,
            "plan": p, "fw": fw, "alpha": alpha}


def _nxv_live(t, info, g, width, k):
    end = info.numel()
    return t[:end].reshape(end, g, width)[info >= 0][..., :k]


@pytest.mark.parametrize("g,k", [(4, 264), (2, 520), (1, 300)])
def test_nextvlad_wide_forward_tiling_equals_the_plain_version(g, k):
    """The wide launches against forward_plain: the f32 softmax and a_sum
    within 1e-5 * max|ref| + 1e-6 (f32 sums in another order: the inputs
    are tests/test_torch_nextvlad_tiles.py's exact ones, so xe and the
    logits are exact), the bf16 assignment within one bf16 step, pads and
    rows that are not live exactly zero."""
    import test_torch_nextvlad_tiles as tiles

    b, f, d, lam = 3, 11, 16, 2
    args = tiles._exact_args(g + k, b, f, d, lam, g, k)
    out = nextvlad_wide_forward(args, g)
    fw, info = out["fw"], out["info"]
    kp = tnv.dims(d, lam * d, g, k)["Kp"]
    live = fw["live"].reshape(-1)
    want_sm = fw["sm"].reshape(b * f, g, k)[live]
    _close(_nxv_live(out["sm"], info, g, kp, k).numpy(), want_sm.numpy(),
           1e-5, 1e-6)
    _close(out["a_sum"].numpy(), fw["a_sum"].numpy(), 1e-5, 1e-6)
    got = _nxv_live(out["assign"], info, g, kp, k)
    want = fw["assign"].reshape(b * f, g, k)[live].to(torch.bfloat16).float()
    assert torch.all((got - want).abs() <= 2.0 ** -7 * torch.maximum(
        got.abs(), want.abs()))
    end = info.numel()
    dead = info < 0
    assert torch.all(out["assign"][:end][dead] == 0)
    pads = out["sm"][:end].reshape(end, g, kp)[..., k:]
    assert torch.all(pads == 0)


def nextvlad_wide_backward(args, g, dy):
    """csrc/nextvlad_train.cu's K > 256 launches 2a and 2b in plain
    PyTorch: d_assign - cdot over (video tile of 128 (frame, group) rows,
    256 clusters) tiles in 64-deep stages into a [rows G, Kp] f32
    scratch, then a row at a time the softmax and sigmoid VJPs over the
    row's Kp clusters. -> (d_act [rows G, Kp], d_pre [rows G], steps)."""
    import test_torch_nextvlad_tiles as tiles

    x, nf, *w = args
    b, f, d = x.shape
    k = w[3].shape[1] // g
    fw = tnv.forward_plain(*args, g)
    st = tnvt.plain_backward_steps(*args, dy, g, fw=fw)
    n = tnv.dims(d, w[0].shape[1], g, k)
    kp, pp, p_ = n["Kp"], n["Pp"], n["P"]
    p = tnv.plan(nf, f, d, w[0].shape[1], g, k)
    assert p["wide"] and p["dassign"]["cluster_tiles"] == -(-kp // 256)
    info = tnv.packed_info(nf, f, g)

    def padded(t, width, inner):
        t = t.reshape(b, f, g, inner)
        return torch.nn.functional.pad(t, (0, width - inner)).reshape(
            b, f, g * width)

    xg = tiles._pack(padded(fw["xe"], pp, p_), nf, p).reshape(-1, pp)
    sm = tiles._pack(padded(torch.where(fw["live"][..., None, None],
                                        fw["sm"], 0.0), kp, k),
                     nf, p).reshape(-1, kp)
    alpha = tiles._pack(fw["alpha"], nf, p).reshape(-1)
    dvb = torch.zeros(b, kp, pp)
    dvb[:, :k, :p_] = st["dvb"]
    cdot = torch.zeros(b, kp)
    cdot[:, :k] = st["cdot"]
    toff = tnvt.video_tiles(p["poff"], g)
    nkt = p["dassign"]["cluster_tiles"]
    assert p["dassign"]["tiles"] == int(toff[-1]) * nkt
    dasg = torch.full((p["cap"] * g, kp), float("nan"))
    for t in range(p["dassign"]["tiles"]):
        vt, ct = divmod(t, nkt)
        v = int(torch.searchsorted(toff, torch.tensor(vt, dtype=torch.int32),
                                   right=True)) - 1
        run_end = int(p["poff"][v + 1]) * g
        r0 = int(p["poff"][v]) * g + (vt - int(toff[v])) * tnv.TILE
        r1 = min(r0 + tnv.TILE, run_end)
        cols = slice(ct * 256, min((ct + 1) * 256, kp))
        acc = torch.zeros(r1 - r0, cols.stop - cols.start)
        for d0 in range(0, pp, tnv.DEPTH):
            acc += xg[r0:r1, d0:d0 + tnv.DEPTH] @ dvb[v, cols,
                                                       d0:d0 + tnv.DEPTH].T
        dasg[r0:r1, cols] = acc - cdot[v, cols]
    rows = p["total"] * g
    assert p["dassign"]["vjp_blocks"] * 8 >= rows
    da, s = dasg[:rows], sm[:rows]
    al = alpha[:rows, None]
    live = (info[torch.arange(rows) // g] >= 0)[:, None]
    dal = torch.sum(da * s, 1, keepdim=True)
    tt = torch.sum(s * (da * al), 1, keepdim=True)
    d_act = torch.where(live, s * (da * al - tt), 0.0)
    d_pre = torch.where(live, dal * al * (1.0 - al), 0.0)[:, 0]
    return d_act, d_pre, st, info


@pytest.mark.parametrize("g,k", [(4, 264), (2, 520)])
def test_nextvlad_wide_backward_tiling_equals_the_plain_steps(g, k):
    """The wide d_assign tiles and the row VJP against
    plain_backward_steps on the live rows: 1e-5 * max|ref| + 1e-6 (f32
    order); pad rows exactly zero."""
    import test_torch_nextvlad_tiles as tiles

    b, f, d, lam = 3, 11, 16, 2
    args = tiles._exact_args(g + k + 1, b, f, d, lam, g, k)
    dy = torch.randn(b, k, lam * d // g,
                     generator=torch.Generator().manual_seed(k))
    d_act, d_pre, st, info = nextvlad_wide_backward(args, g, dy)
    kp = tnv.dims(d, lam * d, g, k)["Kp"]
    end = d_act.shape[0] // g  # the packed total
    info = info[:end]
    got = d_act.reshape(end, g, kp)
    live = st["d_act"].reshape(b * f, g, k)[
        (torch.arange(f)[None, :] < args[1][:, None]).reshape(-1)]
    _close(got[info >= 0][..., :k].numpy(), live.numpy(), 1e-5, 1e-6)
    assert torch.all(got[info >= 0][..., k:] == 0)
    assert torch.all(got[info < 0] == 0)
    want_pre = st["d_pre"].reshape(b * f, g)[
        (torch.arange(f)[None, :] < args[1][:, None]).reshape(-1)]
    _close(d_pre.reshape(end, g)[info >= 0].numpy(),
           want_pre.numpy(), 1e-5, 1e-6)


@pytest.mark.parametrize("k", [257, 264, 520, 1000, 1600])
def test_nextvlad_plan_at_many_clusters(k):
    """The wide plan at the serving (B = 512) and training (B = 256)
    shapes: the logits launch's tiles and shared memory, the softmax and
    VJP grids, the dassign tiles; K <= 256 keeps its launches."""
    for b in (512, 256):
        nf = torch.from_numpy(np.random.default_rng(b).integers(
            1, 301, size=b).astype(np.int32))
        p = tnv.plan(nf, 300, 1152, 2304, 8, k)
        kp = -(-k // 64) * 64
        assert p["wide"] and p["cluster"]["groups"] == 1
        assert p["cluster"]["cols"] == 256
        assert p["cluster"]["cluster_tiles"] == -(-kp // 256)
        assert p["cluster"]["tiles"] == p["row_tiles"] * 8 * -(-kp // 256)
        assert p["cluster"]["smem"] <= SMEM_LIMIT
        assert 0 < p["cluster"]["grid"] <= tnv.SMS
        assert p["softmax"]["grid"] == (-(-p["cap"] // 64), 8)
        assert p["softmax"]["blocks"] <= p["softmax"]["grid"][0] * 8
        assert p["softmax"]["logits_floats"] == p["cap"] * 8 * kp
        assert p["dassign"]["smem"] <= SMEM_LIMIT
        assert p["dassign"]["box_v"] == (64, 256)
        assert p["dassign"]["vjp_blocks"] * 8 >= p["cap"] * 8
        assert tnv.indexable(b, 300, 8, 288, kp)
    narrow = tnv.plan(nf, 300, 1152, 2304, 8, 256)
    assert not narrow["wide"] and narrow["softmax"] is None


def test_nextvlad_plan_at_264_clusters():
    """K = 264 at the reference widths: the plan the card refused before
    (the wrapper raised at K > 256). Kp = 320, two cluster tiles a group,
    three aggregation cluster tiles of 128."""
    nf = torch.full((512,), 300, dtype=torch.int32)
    p = tnv.plan(nf, 300, 1152, 2304, 8, 264)
    assert p["wide"] and p["dims"]["Kp"] == 320
    assert p["cluster"]["cluster_tiles"] == 2
    assert p["aggregate"]["cluster_tiles"] == 3
    assert p["dassign"]["tiles"] == sum(p["video_tiles"]) * 2


def test_nextvlad_max_clusters_is_the_index_limit(monkeypatch):
    """max_clusters() is the widest Kp (a multiple of 64) with cap * G *
    Kp < 2^31 at the smallest capacity; the wrapper refuses above it and
    where a call's own B, F, G and K overflow the packed rows' index."""
    m = tnv.max_clusters()
    cap = tnv.packed_capacity(1, 1, 1)
    assert m == 11184768 and m % 64 == 0
    assert cap * m < 2 ** 31 <= cap * (m + 64)
    assert tnv.indexable(1, 1, 1, 8, m) and not tnv.indexable(1, 1, 1, 8,
                                                              m + 64)
    assert not tnv.indexable(65535, 300, 8, 288, 576)
    monkeypatch.setattr(tnv, "on_cpu", lambda *ts: False)
    monkeypatch.setattr(tnv, "max_clusters", lambda: 300)
    x, nf, w = _nxv_inputs(1, "uint8", 320)
    with pytest.raises(ValueError, match="K <= 300"):
        tnv.nextvlad_aggregate(*map(torch.from_numpy, (x, nf, *w)), NXV_G)
