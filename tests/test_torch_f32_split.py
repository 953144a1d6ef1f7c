"""The 3xTF32 product of the f32 routes of DBoF v2, the MoE head,
NetVLAD and attention pooling.

At --compute_dtype=float32 the card multiplies f32 operands on the TF32
tensor cores: each operand v split into big = tf32(v) and small =
tf32(v - big) (kernels/tf32.py), three products a_small b_big + a_big
b_small + a_big b_big summed in f32 (csrc/hopper_gemm.cuh :: consume3).
The CPU has no TF32 product, so these tests emulate the card's
arithmetic: TF32 as round-to-nearest, ties away from zero, to a 10-bit
mantissa (`tf32.round_tf32`, held here to an independent float64
rounding), the three products each an f32 matmul and summed in f32. The
emulated routes are held against the JAX kernels at dtype=float32 in
interpret mode, at the shapes of tests/test_torch_f32.py, within the
card's f32 tolerance, 1e-5 * max|ref| + 1e-5: the split itself fits it.
Then the split weight constants (big + small rebuilds each weight within
2^-21 relative, the K-major layout, the zero pad), the models' f32
serving constants and their export, the f32 MoE tiling at M = 1..200
(no class past its tile, a fill no worse than the bf16 route's) and the
f32 DBoF walk (every tile once, W's groups in order). NetVLAD's and
attention pooling's routes, emulated the same way (both products split,
the softmax in f32), are held against their JAX kernels at f32 at
tests/test_torch_f32.py's shapes (NetVLAD within 1e-5 * max|ref| + 1e-8,
the card's NetVLAD tolerance); the aggregation's 32-frame stage sums are
modelled over 300 frames; the four NetVLAD models carry Wc's split copy
at f32 and the f32 flagship's export carries it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.kernels.attention_pool import attention_pool as jax_attention
from yt8m_tpu.kernels.dbof import dbof_cluster_maxpool_v2 as jax_dbof_v2
from yt8m_tpu.kernels.moe_head import moe_head_serving as jax_moe
from yt8m_tpu.kernels.netvlad import netvlad_aggregate as jax_netvlad
from yt8m_tpu_torch.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.kernels import moe_head as tmoe
from yt8m_tpu_torch.kernels import tf32
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.models.frame_utils import l2_normalize

F32 = jnp.float32
REL, ABS = 1e-5, 1e-5  # the card's f32 tolerance (chip_smoke.py F32_REL)


def _close(got, want, rel=REL, abs_=ABS):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want))
    bound = rel * np.max(np.abs(want)) + abs_
    assert err <= bound, (err, bound)


def _tf32_reference(v: np.ndarray) -> np.ndarray:
    """Round-to-nearest, ties away from zero, to 11 significant bits, in
    float64 arithmetic (exact at these widths)."""
    v = v.astype(np.float64)
    mant, exp = np.frexp(np.abs(v))  # |v| = mant 2^exp, mant in [0.5, 1)
    # float32's subnormals share the exponent of its smallest normal.
    exp = np.maximum(exp, -125)
    ulp = np.ldexp(1.0, exp - 11)
    return np.copysign(np.floor(np.abs(v) / ulp + 0.5) * ulp, v).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The split
# ---------------------------------------------------------------------------


def test_round_tf32_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.normal(size=4000).astype(np.float32),
        (rng.normal(size=1000) * 1e-30).astype(np.float32),
        (rng.normal(size=1000) * 1e30).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, 3.4e38, 1e-45, -1e-45], np.float32),
    ])
    # Exact ties: 1 + (2k + 1) 2^-11, halfway between two TF32 values.
    ties = (1.0 + (2 * np.arange(8) + 1) * 2.0 ** -11).astype(np.float32)
    v = np.concatenate([v, ties, -ties])
    got = tf32.round_tf32(torch.from_numpy(v)).numpy()
    assert np.all(got.view(np.uint32) & 0x1FFF == 0)
    want = _tf32_reference(v[np.abs(v) < 3e38])
    assert np.array_equal(got[np.abs(v) < 3e38].view(np.uint32),
                          want.view(np.uint32))
    # Ties go away from zero.
    t = tf32.round_tf32(torch.from_numpy(ties)).numpy().astype(np.float64)
    assert np.all(t > ties)
    t = tf32.round_tf32(torch.from_numpy(-ties)).numpy().astype(np.float64)
    assert np.all(t < -ties)
    special = torch.tensor([float("inf"), float("-inf"), float("nan")])
    out = tf32.round_tf32(special)
    assert out[0] == float("inf") and out[1] == float("-inf")
    assert torch.isnan(out[2])


@pytest.mark.parametrize("depth,cols", [(1152, 40), (37, 11), (2048, 9),
                                        (5, 300)])
def test_split_weights_rebuild_the_weights(depth, cols, monkeypatch):
    """[2, cols, depth rounded up to 4]: w transposed, big and small TF32
    values whose sum is w within 2^-21 relative, zeros past the depth; the
    same in steps of a few columns (the card's large weights)."""
    rng = np.random.default_rng(depth + cols)
    w = torch.from_numpy(
        (rng.normal(size=(depth, cols)) * depth ** -0.5).astype(np.float32))
    w[0, 0] = 0.0
    s = tf32.split_weights(w)
    dp = -(-depth // 4) * 4
    assert s.shape == (2, cols, dp) and s.dtype == torch.float32
    assert s.is_contiguous()
    assert torch.all(s[:, :, depth:] == 0)
    big, small = s[0, :, :depth].t(), s[1, :, :depth].t()
    for half in (big, small):
        assert torch.all(half.contiguous().view(torch.int32) & 0x1FFF == 0)
    assert torch.equal(big, tf32.round_tf32(w))
    rebuilt = (big.double() + small.double())
    err = (rebuilt - w.double()).abs()
    assert torch.all(err <= 2.0 ** -21 * w.double().abs())
    assert torch.all(small.abs() <= 2.0 ** -11 * w.abs())
    monkeypatch.setattr(tf32, "_CHUNK", 3 * depth)
    assert torch.equal(tf32.split_weights(w), s)
    # A strided view (the pitched layout) splits as its values.
    padded = torch.zeros(depth, cols + 5)
    padded[:, :cols] = w
    assert torch.equal(tf32.split_weights(padded[:, :cols]), s)


# ---------------------------------------------------------------------------
# The emulated 3xTF32 routes against the JAX kernels at dtype=float32
# ---------------------------------------------------------------------------


def _product_3xtf32(a, b):
    """a @ b as the card's f32 routes compute it: both split, three f32
    products summed in f32, the small terms first."""
    ab, a_s = tf32.split(a)
    bb, b_s = tf32.split(b)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _frames(rng, shape, x_dtype):
    if x_dtype == "uint8":
        return rng.integers(0, 256, size=shape, dtype=np.uint8)
    return rng.normal(size=shape).astype(np.float32)


# tests/test_torch_f32.py's shapes, and DbofModel's D at a small batch.
DBOF_SHAPES = [(3, 5, 32, 24), (4, 7, 37, 100), (2, 1, 64, 8),
               (5, 33, 33, 17), (2, 30, 1152, 64)]


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,s,d,k", DBOF_SHAPES)
def test_dbof_3xtf32_matches_jax(b, s, d, k, x_dtype):
    rng = np.random.default_rng(b + s + d + k)
    x = _frames(rng, (b, s, d), x_dtype)
    w = rng.normal(0, d ** -0.5, (d, k)).astype(np.float32)
    unit = 4.0 / 255.0 if x_dtype == "uint8" else 1.0
    in_scale = (unit * rng.uniform(0.5, 1.5, d)).astype(np.float32)
    in_bias = rng.normal(0, 0.3, d).astype(np.float32)
    act_scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    act_bias = rng.normal(0, 0.3, k).astype(np.float32)
    args = (x, w, in_scale, in_bias, act_scale, act_bias)
    xt, wt, s_in, b_in, s_act, b_act = (torch.from_numpy(a) for a in args)
    xa = xt.to(torch.float32) * s_in + b_in  # the affine, two roundings
    act = _product_3xtf32(xa, wt)
    got = torch.amax(torch.relu(act * s_act + b_act), dim=1)
    want = jax_dbof_v2(*map(jnp.asarray, args), interpret=True, block_b=2,
                       dtype=F32)
    _close(got.numpy(), want)


MOE_SHAPES = [(5, 32, 7, 2), (3, 37, 11, 1), (4, 20, 9, 4), (2, 64, 5, 16),
              (6, 1000, 13, 2), (4, 2048, 6, 2)]


def _moe_args(rng, b, h, c, m):
    x = rng.normal(size=(b, h)).astype(np.float32)
    gates = rng.normal(0, h ** -0.5, (h, c * (m + 1))).astype(np.float32)
    experts = rng.normal(0, h ** -0.5, (h, c * m)).astype(np.float32)
    bias = rng.normal(0, 0.3, c * m).astype(np.float32)
    return x, gates, experts, bias


@pytest.mark.parametrize("b,h,c,m", MOE_SHAPES)
def test_moe_3xtf32_matches_jax(b, h, c, m):
    rng = np.random.default_rng(b + h + c + m)
    args = _moe_args(rng, b, h, c, m)
    x, wg, we, be = (torch.from_numpy(a) for a in args)
    g = _product_3xtf32(x, wg)
    e = _product_3xtf32(x, we) + be
    eg = torch.exp(torch.clamp(g, -80.0, 80.0)).reshape(b, c, m + 1)
    num = torch.sum(eg[..., :m] * torch.sigmoid(e.reshape(b, c, m)), -1)
    got = num / torch.sum(eg, -1)
    want = jax_moe(*map(jnp.asarray, args), m, dtype=F32, interpret=True,
                   block_b=4, block_c=4)
    _close(got.numpy(), want)


def _num_frames(rng, b, f):
    """Ragged counts with F, 0 and 1 planted."""
    nf = rng.integers(1, f + 1, size=b).astype(np.int32)
    nf[: min(b, 3)] = np.array([f, 0, 1], np.int32)[: min(b, 3)]
    return nf


def _frames_f32(frames):
    """The frames as the card's routes read them: uint8 dequantized in
    f32 with the plain version's two roundings."""
    x = frames.to(torch.float32)
    if frames.dtype == torch.uint8:
        x = x * DEQUANT_SCALE + DEQUANT_BIAS
    return x


def _vlad_3xtf32(frames, nf, wc, scale, bias, centers):
    """NetVLAD as the card's f32 route computes it: both products split
    (x @ Wc, then assign^T @ x with frames past num_frames zero), the
    softmax, the column sums and the norms in f32."""
    x = _frames_f32(frames)
    f = x.shape[1]
    live = torch.arange(f)[None, :] < nf.to(torch.int64)[:, None]
    act = _product_3xtf32(x, wc) * scale + bias
    act = act - torch.amax(act, dim=-1, keepdim=True)
    e = torch.exp(act)
    assign = torch.where(live[..., None], e / torch.sum(e, -1, keepdim=True),
                         torch.zeros_like(e))
    xm = torch.where(live[..., None], x, torch.zeros_like(x))
    vlad = _product_3xtf32(assign.transpose(1, 2), xm)
    vlad = vlad - assign.sum(1)[..., None] * centers
    return l2_normalize(l2_normalize(vlad, dim=2), dim=(1, 2))


def _attention_3xtf32(frames, nf, query):
    """Attention pooling as the card's f32 route computes it: both
    products split, the masked softmax over the frames in f32."""
    x = _frames_f32(frames)
    f = x.shape[1]
    live = torch.arange(f)[None, :] < nf.to(torch.int64)[:, None]
    scores = torch.where(live[..., None], _product_3xtf32(x, query),
                         torch.tensor(-1e9))
    attn = torch.softmax(scores, dim=1)
    return _product_3xtf32(attn.transpose(1, 2), x)


# tests/test_torch_f32.py's shapes.
VLAD_SHAPES = [(4, 13, 24, 8), (3, 70, 37, 100), (4, 16, 64, 17),
               (5, 65, 33, 256)]
ATTN_SHAPES = [(4, 16, 32, 4), (3, 24, 37, 3), (4, 8, 64, 16),
               (3, 16, 8, 19), (4, 40, 1152, 8)]


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,f,d,k", VLAD_SHAPES)
def test_netvlad_3xtf32_matches_jax(b, f, d, k, x_dtype):
    rng = np.random.default_rng(b + f + d + k)
    frames = _frames(rng, (b, f, d), x_dtype)
    nf = _num_frames(rng, b, f)
    wc = rng.normal(0, d ** -0.5, (d, k)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, k).astype(np.float32)
    bias = rng.normal(0, 0.3, k).astype(np.float32)
    centers = rng.normal(0, 0.5, (k, d)).astype(np.float32)
    args = (frames, nf, wc, scale, bias, centers)
    got = _vlad_3xtf32(*(torch.from_numpy(a) for a in args))
    want = jax_netvlad(*map(jnp.asarray, args), interpret=True, dtype=F32)
    _close(got.numpy(), want, abs_=1e-8)
    assert np.all(got[1].numpy() == 0)  # num_frames = 0: a zero descriptor


@pytest.mark.parametrize("x_dtype", ["uint8", "float32"])
@pytest.mark.parametrize("b,f,d,h", ATTN_SHAPES)
def test_attention_3xtf32_matches_jax(b, f, d, h, x_dtype):
    rng = np.random.default_rng(b + f + d + h)
    frames = _frames(rng, (b, f, d), x_dtype)
    nf = _num_frames(rng, b, f)
    query = rng.normal(0, d ** -0.5, (d, h)).astype(np.float32)
    got = _attention_3xtf32(*(torch.from_numpy(a)
                              for a in (frames, nf, query)))
    want = jax_attention(*map(jnp.asarray, (frames, nf, query)),
                         interpret=True, dtype=F32)
    _close(got.numpy(), want)


# ---------------------------------------------------------------------------
# The models' f32 serving constants
# ---------------------------------------------------------------------------


def _hp(**kw):
    return ModelHParams(vocab_size=20, feature_dim=64, max_frames=12,
                        dbof_cluster_size=48, dbof_hidden_size=24,
                        iterations=6, moe_num_mixtures=2, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_models_build_the_split_at_float32_only(dtype):
    """DbofModel's and MoeHead's serving constants carry the split copies
    of their weights at --compute_dtype=float32 (and the bf16 route's
    pitched views only at bfloat16), made from the weights as they are."""
    model = get_model("DbofModel", _hp(compute_dtype=dtype))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.eval()
    consts = model.serving_constants()
    head = model.video_classifier.serving_constants()
    if dtype == "float32":
        assert len(consts["cluster_w_split"]) == 1
        assert torch.equal(consts["cluster_w_split"][0],
                           tf32.split_weights(model.cluster_kernel))
        gates, experts = head["split"]
        clf = model.video_classifier
        assert torch.equal(gates, tf32.split_weights(clf.gates_kernel))
        assert torch.equal(experts, tf32.split_weights(clf.experts_kernel))
        assert "buffers" not in head
    else:
        assert consts["cluster_w_split"] == []
        assert "split" not in head and "buffers" in head
    # The four NetVLAD models share NetVladAggregation: Wc's split copy at
    # float32 only.
    for name in ("NetVladModel", "GatedNetVladModel", "NetVladLstmModel",
                 "ChainNetVladModel"):
        model = get_model(name, _hp(compute_dtype=dtype,
                                    netvlad_cluster_size=8,
                                    netvlad_hidden_size=16, lstm_cells=16))
        model.reset_parameters(torch.Generator().manual_seed(1))
        model.eval()
        split = model.vlad.serving_constants()["cluster_w_split"]
        if dtype == "float32":
            assert len(split) == 1, name
            assert torch.equal(split[0], tf32.split_weights(
                model.vlad.cluster_weights)), name
        else:
            assert split == [], name


def test_f32_export_carries_the_split_and_serves_as_eager(tmp_path):
    """A DbofModel exported at f32 on the CPU carries the split constants
    of the weights it was given and serves the eager step's top-k bit for
    bit (the split is the card's operand; the CPU serves the plain
    versions)."""
    from yt8m_tpu_torch.infer.export import export_model, load_serving
    from yt8m_tpu_torch.infer.predict import make_serving_step

    hp = _hp(compute_dtype="float32")
    model = get_model("DbofModel", hp)
    model.reset_parameters(torch.Generator().manual_seed(3))
    model.eval()
    export_model(str(tmp_path), "DbofModel", hp, model)
    program = torch.export.load(str(tmp_path / "program.pt2"))
    consts = list(program.constants.values()) + list(
        program.state_dict.values())
    want = [tf32.split_weights(model.cluster_kernel),
            tf32.split_weights(model.video_classifier.gates_kernel),
            tf32.split_weights(model.video_classifier.experts_kernel)]
    for w in want:
        assert any(c.shape == w.shape and torch.equal(c, w)
                   for c in consts), tuple(w.shape)
    serve, _ = load_serving(str(tmp_path), device="cpu")
    step = make_serving_step(model, csv_top_k=20)
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (5, 12, 64), generator=g, dtype=torch.uint8)
    nf = torch.randint(1, 13, (5,), generator=g, dtype=torch.int32)
    got = serve(x, nf)
    eager = step(x, nf, generator=torch.Generator().manual_seed(0))["csv"]
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


def test_f32_flagship_export_carries_the_split_and_serves_as_eager(
        tmp_path):
    """The f32 flagship (NetVladLstmModel, its LSTM the scan graph)
    exported on the CPU carries Wc's split copy among its constants and
    serves the eager step's top-k bit for bit."""
    from yt8m_tpu_torch.infer.export import export_model, load_serving
    from yt8m_tpu_torch.infer.predict import make_serving_step

    hp = _hp(compute_dtype="float32", netvlad_cluster_size=8,
             netvlad_hidden_size=16, lstm_cells=16, lstm_layers=2)
    model = get_model("NetVladLstmModel", hp)
    model.reset_parameters(torch.Generator().manual_seed(5))
    model.eval()
    export_model(str(tmp_path), "NetVladLstmModel", hp, model)
    program = torch.export.load(str(tmp_path / "program.pt2"))
    consts = list(program.constants.values()) + list(
        program.state_dict.values())
    want = tf32.split_weights(model.vlad.cluster_weights)
    assert any(c.shape == want.shape and torch.equal(c, want)
               for c in consts)
    serve, _ = load_serving(str(tmp_path), device="cpu")
    step = make_serving_step(model, csv_top_k=20)
    g = torch.Generator().manual_seed(6)
    x = torch.randint(0, 256, (5, 12, 64), generator=g, dtype=torch.uint8)
    nf = torch.tensor([12, 0, 1, 7, 3], dtype=torch.int32)
    got = serve(x, nf)
    eager = step(x, nf, generator=torch.Generator().manual_seed(0))["csv"]
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The f32 MoE tiling and the f32 DBoF walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,c", [(512, 2048, 4716), (37, 96, 83),
                                   (2048, 1024, 4716)])
def test_moe_f32_plan_at_mixtures_1_to_200(b, h, c):
    """At every M in 1..200 the f32 route's tile holds its classes (every
    class's gate and expert columns inside its chains, from exact starts),
    its ring fits the card, and its chains are at least as full as the
    bf16 route's (which lose up to 7 columns to a rounded start)."""
    for m in range(1, 201):
        f = tmoe.plan(b, h, c, m, f32=True)
        p = tmoe.plan(b, h, c, m)
        assert f["smem"] <= tmoe.SMEM_LIMIT and f["stages"] >= 2, m
        assert f["chunks"] == p["chunks"], m
        assert f["gate_cols"] <= f["gate"] and f["expert_cols"] <= f["expert"]
        gb, gc = f["grid"]
        assert (gc - 1) * f["classes"] < c <= gc * f["classes"], m
        assert f["k_steps"] * tmoe.F32_DEPTH >= h
        fill = (f["gate_cols"] + f["expert_cols"]) / (f["gate"] + f["expert"])
        bf16 = (p["gate_cols"] + p["expert_cols"]) / (p["gate"] + p["expert"])
        assert fill >= bf16, (m, fill, bf16)
        if f["chunks"] == 1:
            assert f["classes"] * m <= 128  # the bias slot
            # No class past its tile: class k of a block, gates k (M + 1)
            # .. and experts k M .., inside the chains.
            nc = f["classes"]
            assert (nc - 1) * (m + 1) + m + 1 <= f["gate"]
            assert (nc - 1) * m + m <= f["expert"]
        else:
            assert f["classes"] == 1 and m > tmoe.RUNTIME_MIXTURES
            assert tmoe.CHUNK_MIXTURES + 1 <= f["gate"]
            assert tmoe.CHUNK_MIXTURES <= f["expert"]


@pytest.mark.parametrize("b,k", [(2048, 8192), (7, 200), (130, 1000),
                                 (9, 2056), (1, 8)])
def test_dbof_f32_walk_takes_every_tile_once_in_groups(b, k):
    """The f32 route's persistent walk: every (video tile, cluster tile)
    once; the tiles of a group of 8 cluster tiles before the next group;
    within a group the cluster tile fastest. The bf16 route's walk is
    one group (the cluster tile fastest over all of K)."""
    for f32 in (True, False):
        p = tdbof.plan(b, 30, 1152, k, f32=f32)
        seen = [tdbof.walk(t, p) for t in range(p["tiles"])]
        assert sorted(seen) == [(r, c) for r in range(p["row_tiles"])
                                for c in range(p["cluster_tiles"])]
        group = p["group"]
        groups = [c // group for _, c in seen]
        assert groups == sorted(groups)
        if not f32:
            assert seen[:p["cluster_tiles"]] == [
                (0, c) for c in range(p["cluster_tiles"])]
    p = tdbof.plan(2048, 30, 1152, 8192, f32=True)
    assert p["smem"] <= 232448 and p["stages"] == 2 and p["group"] == 8
    assert p["k_steps"] == 36


# ---------------------------------------------------------------------------
# The accumulation: the tensor core's round-toward-zero sums
# ---------------------------------------------------------------------------


def _rz32(v: np.ndarray) -> np.ndarray:
    """float64 v rounded toward zero to float32."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    return np.where(over, np.nextafter(f, np.float32(0)), f)


def _wgmma_3xtf32(a, b, stage):
    """a @ b (one column b) as the 3xTF32 wgmmas sum it: each k8 step of
    each of the three products added to its f32 accumulator rounding
    toward zero (as Hopper's tensor core adds an f32 sum); every `stage`
    deep (0: never) the accumulator starts afresh and is added to an f32
    running sum rounded to nearest (hopper_gemm.cuh :: consume3)."""
    ab = tf32.round_tf32(torch.from_numpy(a)).numpy()
    a_s = tf32.round_tf32(torch.from_numpy(a - ab)).numpy()
    bb = tf32.round_tf32(torch.from_numpy(b)).numpy()
    b_s = tf32.round_tf32(torch.from_numpy(b - bb)).numpy()
    total = np.zeros(a.shape[0], np.float32)
    acc = np.zeros(a.shape[0], np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in ((a_s, bb), (ab, b_s), (ab, bb)):
            part = x[:, k:k + 8].astype(np.float64) @ y[k:k + 8].astype(
                np.float64)
            acc = _rz32(acc.astype(np.float64) + part)
        if stage and (k + 8) % stage == 0:
            total = total + acc
            acc = np.zeros_like(acc)
    return total + acc


@pytest.mark.parametrize("d", [1152, 4096])
def test_stage_sums_keep_the_product_at_the_f32_error(d):
    """One chain of round-toward-zero wgmmas over the whole depth drifts
    toward zero in proportion to D, past the card's f32 tolerance at
    D = 4096; summing each 32-deep stage afresh and adding the stages in
    f32 (the design of consume3) keeps the error within 2x the f32
    matmul's own at both depths."""
    rng = np.random.default_rng(d)
    a = rng.normal(size=(512, d)).astype(np.float32)
    b = (rng.normal(size=d) * d ** -0.5).astype(np.float32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    graph = np.max(np.abs((a @ b).astype(np.float64) - exact))
    chain = np.max(np.abs(_wgmma_3xtf32(a, b, 0) - exact))
    stages = np.max(np.abs(_wgmma_3xtf32(a, b, 32) - exact))
    top = np.max(np.abs(exact))
    assert stages <= 2 * graph + 1e-7, (stages, graph)
    assert chain > 8 * stages, (chain, stages)
    if d == 4096:
        assert chain > REL * top, (chain, top)


def test_aggregation_stage_sums_over_300_frames():
    """NetVLAD's f32 aggregation, assign^T x over a video's frames, on
    the wgmma in 3xTF32: each 32-frame stage (four k8 steps, twelve
    tensor core sums rounding toward zero) summed afresh and the stages
    added in f32. Over 300 frames the stage sums stay within 4x the f32
    graph's own error here (numpy's f32 sum, pairwise: more accurate
    than the card's), where one chain over all the frames drifts to more
    than 5x the stage sums' error; the card's float64 witness holds the
    whole route."""
    rng = np.random.default_rng(300)
    f, k = 300, 256
    logits = rng.normal(size=(f, k))
    assign = np.exp(logits - logits.max(1, keepdims=True))
    assign = (assign / assign.sum(1, keepdims=True)).astype(np.float32)
    x = (rng.integers(0, 256, size=f).astype(np.float32)
         * np.float32(DEQUANT_SCALE) + np.float32(DEQUANT_BIAS))
    a = np.ascontiguousarray(assign.T)  # [K, frames]
    exact = a.astype(np.float64) @ x.astype(np.float64)
    graph = np.max(np.abs((a @ x).astype(np.float64) - exact))
    chain = np.max(np.abs(_wgmma_3xtf32(a, x, 0) - exact))
    stages = np.max(np.abs(_wgmma_3xtf32(a, x, 32) - exact))
    assert stages <= 4 * graph + 1e-8, (stages, graph)
    assert chain > 5 * stages, (chain, stages)


@pytest.mark.parametrize("x_dtype", [torch.uint8, torch.float32])
def test_f32_vlad_and_attention_plans_fit_the_card(x_dtype):
    """The f32 routes' launches fit an H100's shared memory with at least
    two stages: NetVLAD's assignment (32-deep stages of both halves of
    the x tiles and the split Wc rows; the registers' softmax up to K =
    256, the wide path above) at every K of the card checks, and
    attention pooling's f32 instance (eight heads a launch) at the
    serving shape. Both halves of Q kept in shared memory would leave
    f32 frames at D = 1152 one stage: the kernel splits Q as it loads
    it."""
    from yt8m_tpu_torch.kernels import attention_pool as tap
    from yt8m_tpu_torch.kernels import netvlad as tvlad

    for k in (8, 64, 128, 136, 256, 264, 512, 1024, 2048):
        p = tvlad.plan(512, 300, 1152, k, x_dtype, f32=True)
        assert p["assign_smem"] <= tvlad.SMEM_LIMIT, k
        assert p["assign_stages"] >= 2 and not p["split"], k
        assert p["wide"] == (k > tvlad.F32_CLUSTERS), k
        assert p["k_steps"] == 1152 // tvlad.F32_DEPTH
        assert p["agg_frames"] == tvlad.F32_AGG_FRAMES
        assert p["agg_smem"] <= tvlad.SMEM_LIMIT
    for h in (1, 8, 16):
        p = tap.plan(300, 1152, h, x_dtype, b=512, f32=True)
        assert p["stages"] >= 2 and p["smem"] <= tap.SMEM_LIMIT, h
        assert p["n_tiles"] == 1 and p["launches"] == -(-h // 8)
        assert p["q_bytes"] == 32 * 1152
    if x_dtype == torch.float32:
        p = tap.plan(300, 1152, 8, x_dtype, f32=True)
        room = (tap.SMEM_LIMIT - tap.ALIGN - (p["smem"] - tap.ALIGN
                - p["stages"] * p["stage_bytes"]) - p["q_bytes"])
        assert room // p["stage_bytes"] < 2  # a split Q's second half
