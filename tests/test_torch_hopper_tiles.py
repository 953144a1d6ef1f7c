"""The tile plans of the TMA + wgmma kernels (csrc/dbof.cu,
csrc/moe_head.cu, csrc/hopper_gemm.cuh) on the CPU: what each launch
asks of the card, the DBoF tiling decomposed in plain PyTorch, and the
MoE head's pitched weight views, held against JAX's moe_head_serving in
interpret mode.

Tolerances: the tiled DBoF against dbof_cluster_maxpool_plain within f32
summation order (1e-5 * max|ref| + 1e-6; both round the same operands,
the products run tile by tile), and exactly 0 on the padded-row hazard.
The pitched views hold the same values as the contiguous weights, so
the plain MoE and MoeHead serving give the same bits on them; against
JAX's kernel in interpret mode, 1e-5 * max|ref| (tests/test_torch_kernels.py's
bound: the same roundings, another summation order). The compiled
kernels' own plans are held to these in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.moe_head import moe_head_serving as jax_moe
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.kernels import moe_head as tmoe
from yt8m_tpu_torch.models.heads import MoeHead

SMEM_LIMIT = 232448   # shared memory a block can use on an H100
BOX_LIMIT = 256       # TMA's largest box dimension
SWIZZLE_ROW = 128     # bytes: the 128-byte swizzle's row, a box's inner extent

DBOF_SHAPES = [(2048, 30, 1152, 8192), (7, 5, 64, 200), (9, 32, 96, 136),
               (1, 1, 32, 8), (130, 31, 1152, 1000), (3, 1, 64, 264),
               (5, 32, 1152, 8192)]


def _check_boxes(*boxes):
    for box in boxes:
        assert all(1 <= n <= BOX_LIMIT for n in box), box
        assert box[0] * 2 == SWIZZLE_ROW and (box[0] * 2) % 16 == 0, box


@pytest.mark.parametrize("b,s,d,k", DBOF_SHAPES)
def test_dbof_plan_fits_the_card(b, s, d, k):
    p = tdbof.plan(b, s, d, k)
    assert p["smem"] <= SMEM_LIMIT
    assert p["stage_bytes"] % 1024 == 0  # swizzle atoms stay aligned
    _check_boxes(p["box_x"], p["box_w"])
    assert p["box_x"][1] * p["box_x"][2] == p["rows"] == 128
    assert p["chain"] % 8 == 0 and p["chain"] <= 256
    assert p["w_boxes"] * p["box_w"][0] == p["chain"]
    assert p["k_steps"] * p["box_x"][0] >= d
    assert p["padded_rows"] == p["rows"] - 4 * s >= 0


@pytest.mark.parametrize("b,s,d,k", DBOF_SHAPES)
def test_dbof_tiles_cover_videos_and_clusters_once(b, s, d, k):
    """The persistent blocks' walks (tile blockIdx.x + i * grid) cover
    every (video, cluster) once; the K tile runs fastest."""
    p = tdbof.plan(b, s, d, k)
    seen = np.zeros((b, k), np.int32)
    for blk in range(p["grid"]):
        for t in range(blk, p["tiles"], p["grid"]):
            videos, cols = tdbof.tile_of(t, p)
            seen[videos.start:min(videos.stop, b),
                 cols.start:min(cols.stop, k)] += 1
    assert (seen == 1).all()
    assert tdbof.tile_of(1, p)[0] == tdbof.tile_of(0, p)[0] or \
        p["cluster_tiles"] == 1


def _tiled_dbof(x, w, s_in, b_in, s_act, b_act, mask=True):
    """The kernel's tiling in plain PyTorch: 4 videos at a pitch of 32
    rows (rows past S and videos past B zero, as TMA fills them), one
    product a (row tile, cluster tile), the affine, rows past S masked to
    -inf, the max over each video's 32 rows, the clamp at 0."""
    b, s, d = x.shape
    k = w.shape[1]
    p = tdbof.plan(b, s, d, k)
    xa = (x.to(torch.float32) * s_in + b_in).to(w.dtype).to(torch.float32)
    pad = torch.zeros(p["row_tiles"] * 4, 32, d)
    pad[:b, :s] = xa
    live = torch.arange(32) < s
    out = torch.empty(b, k)
    wf = w.to(torch.float32)
    for t in range(p["tiles"]):
        videos, clusters = tdbof.tile_of(t, p)
        cl = slice(clusters.start, min(clusters.stop, k))
        rows = pad[videos.start:videos.stop].reshape(128, d)
        act = (rows @ wf[:, cl]) * s_act[cl] + b_act[cl]
        act = act.reshape(4, 32, -1)
        if mask:
            act = torch.where(live[None, :, None], act,
                              torch.tensor(float("-inf")))
        pooled = torch.clamp_min(torch.amax(act, dim=1), 0.0)
        nv = min(videos.stop, b) - videos.start
        out[videos.start:videos.start + nv, cl] = pooled[:nv]
    return out


def _dbof_args(seed, b, s, d, k):
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (b, s, d), generator=g, dtype=torch.uint8)
    s_in = (4.0 / 255.0) * (0.5 + torch.rand(d, generator=g))
    b_in = 0.1 * torch.randn(d, generator=g) - 2.0
    w = (torch.randn(d, k, generator=g) * d ** -0.5).to(torch.bfloat16)
    s_act = 0.5 + torch.rand(k, generator=g)
    b_act = 0.1 * torch.randn(k, generator=g)
    return x, w, s_in, b_in, s_act, b_act


@pytest.mark.parametrize("b,s,d,k", [(7, 5, 64, 200), (9, 32, 96, 136),
                                     (6, 31, 128, 520), (5, 1, 64, 264)])
def test_dbof_tiling_equals_the_plain_version(b, s, d, k):
    args = _dbof_args(b + s + k, b, s, d, k)
    want = tdbof.dbof_cluster_maxpool_plain(*args)
    got = _tiled_dbof(*args)
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item() + 1e-6, err


def test_dbof_tiling_masks_the_padded_rows_exactly():
    """Every real row is negative before the ReLU: the plain version and
    the masked tiling give 0 exactly; without the mask a zero padding
    row would give relu(act_bias) = 3."""
    x, w, s_in, b_in, s_act, b_act = _dbof_args(0, 6, 30, 64, 64)
    w = torch.full_like(w, -1.0)
    s_in, b_in = torch.ones_like(s_in), torch.ones_like(b_in)
    b_act = torch.full_like(b_act, 3.0)
    args = (x, w, s_in, b_in, s_act, b_act)
    assert torch.all(tdbof.dbof_cluster_maxpool_plain(*args) == 0)
    assert torch.all(_tiled_dbof(*args) == 0)
    assert torch.all(_tiled_dbof(*args, mask=False) == 3.0)


@pytest.mark.parametrize("m", range(1, 17))
def test_moe_plan_fits_the_card(m):
    for b, h, c in ((512, 2048, 4716), (2048, 1024, 4716), (37, 96, 83),
                    (130, 64, 33)):
        p = tmoe.plan(b, h, c, m)
        assert p["smem"] <= SMEM_LIMIT
        _check_boxes(p["box_x"], p["box_w"])
        for n in (p["gate"], p["expert"]):
            assert n % 8 == 0 and 8 <= n <= 256
        assert p["gate_cols"] <= p["gate"] and p["expert_cols"] <= p["expert"]
        assert (p["gate_boxes"] - 1) * tmoe.BOX_COLS < p["gate"] <= \
            p["gate_boxes"] * tmoe.BOX_COLS
        assert (p["expert_boxes"] - 1) * tmoe.BOX_COLS < p["expert"] <= \
            p["expert_boxes"] * tmoe.BOX_COLS
        assert p["staged_bytes"] <= p["ring_bytes"]
        assert p["stage_ld"] % 32 == 8 and p["stage_ld"] >= p["gate"] + \
            p["expert"]
        assert p["accumulators"] <= 136  # beside the 232 registers a thread
        # Row tiles and class tiles cover B and C once.
        gb, gc = p["grid"]
        assert (gb - 1) * tmoe.ROWS < b <= gb * tmoe.ROWS
        assert (gc - 1) * p["classes"] < c <= gc * p["classes"]
        assert p["k_steps"] * tmoe.DEPTH >= h


@pytest.mark.parametrize("rows,cols", [(64, 166), (96, 132), (32, 48),
                                       (1, 9)])
def test_pitched_view_keeps_values_and_pads_with_zeros(rows, cols):
    w = torch.randn(rows, cols).to(torch.bfloat16)
    v = tmoe.pitched(w)
    assert v.shape == w.shape and torch.equal(v, w)
    assert v.stride(1) == 1 and v.stride(0) % 8 == 0
    assert v.stride(0) == -(-cols // 8) * 8
    buf = v.as_strided((rows, v.stride(0)), (v.stride(0), 1))
    assert torch.all(buf[:, cols:] == 0)
    tmoe.check_pitched("w", v, (rows, cols))


def _moe_inputs(seed, b, h, c, m):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(b, h))).astype(np.float32)
    wg = (rng.normal(size=(h, c * (m + 1))) / np.sqrt(h)).astype(np.float32)
    we = (rng.normal(size=(h, c * m)) / np.sqrt(h)).astype(np.float32)
    be = (rng.normal(size=(c * m,)) * 0.1).astype(np.float32)
    return x, wg, we, be


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_moe_plain_on_pitched_views_equals_contiguous(dtype, m):
    x, wg, we, be = map(torch.from_numpy, _moe_inputs(m, 9, 32, 83, m))
    wg, we = wg.to(dtype), we.to(dtype)
    want = tmoe.moe_head_plain(x, wg, we, be, m)
    got = tmoe.moe_head_plain(x, tmoe.pitched(wg), tmoe.pitched(we), be, m)
    assert torch.equal(got, want)


def _moe_head(seed, h, c, m, dtype):
    head = MoeHead(h, vocab_size=c, num_mixtures=m, dtype=dtype)
    _, wg, we, be = _moe_inputs(seed, 1, h, c, m)
    with torch.no_grad():
        head.gates_kernel.copy_(torch.from_numpy(wg))
        head.experts_kernel.copy_(torch.from_numpy(we))
        head.experts_bias.copy_(torch.from_numpy(be))
    return head.eval(), wg, we, be


@pytest.mark.parametrize("m", [1, 2, 4])
def test_moe_head_serves_pitched_constants_as_jax(m):
    """MoeHead's serving constants are pitched views; serving on them
    gives the contiguous weights' bits and meets JAX's kernel."""
    b, h, c = 11, 32, 83
    head, wg, we, be = _moe_head(m, h, c, m, torch.bfloat16)
    consts = head.serving_constants()
    for key, w in (("gates", wg), ("experts", we)):
        v = consts[key]
        assert v.stride(0) % 8 == 0 and v.stride(1) == 1
        assert torch.equal(v, torch.from_numpy(w).to(torch.bfloat16))
    x = np.abs(np.random.default_rng(m).normal(size=(b, h))).astype(
        np.float32)
    got = head(torch.from_numpy(x))["predictions"]
    contiguous = tmoe.moe_head_plain(
        torch.from_numpy(x), consts["gates"].contiguous(),
        consts["experts"].contiguous(), torch.from_numpy(be), m)
    assert torch.equal(got, contiguous)
    want = jax_moe(*map(jnp.asarray, (x, wg, we, be)), m,
                   dtype=jnp.bfloat16, interpret=True, block_b=16,
                   block_c=32)
    err = np.max(np.abs(got.numpy().astype(np.float64) - np.asarray(want)))
    assert err <= 1e-5 * np.max(np.abs(np.asarray(want))) + 1e-7, err


def test_moe_card_path_refuses_unpitched_weights(monkeypatch):
    """The card path checks the weights' strides before it launches: a
    contiguous weight whose row is no multiple of 8 columns raises and
    names the helper; the pitched views pass the check."""
    b, h, c, m = 4, 32, 83, 1
    x, wg, we, be = map(torch.from_numpy, _moe_inputs(0, b, h, c, m))
    wg, we = wg.to(torch.bfloat16), we.to(torch.bfloat16)
    monkeypatch.setattr(tmoe, "on_cpu", lambda *ts: False)
    with pytest.raises(ValueError, match="pitched"):
        tmoe.moe_head_serving(x, wg, we, be, m)
    with pytest.raises(ValueError, match="pitched"):
        tmoe.check_pitched("gate_kernel", wg.t().contiguous().t(),
                           (h, c * (m + 1)))
    with pytest.raises(ValueError):
        tmoe.check_pitched("gate_kernel", tmoe.pitched(wg.float()),
                           (h, c * (m + 1)))
    tmoe.check_pitched("gate_kernel", tmoe.pitched(wg), (h, c * (m + 1)))
    tmoe.check_pitched("expert_kernel", tmoe.pitched(we), (h, c * m))
