"""The port's int8 DBoF serving path (--dbof_int8_serving) against the
JAX package: the kernel module's plain version against the Pallas kernel
in interpret mode, its constants against a numpy copy of the TPU
wrapper's formulas, DbofModel against the JAX model
(YT8M_PALLAS_INTERPRET=1), the dispatch, and the inference and eval
CLIs on the CPU. tests/test_torch_cuda.py holds the CUDA kernel against
the plain version on the card.

Tolerances:
  * kernel module: max|diff| <= 1e-5 * max|ref|. Both sides get the same
    f32 vectors and quantize them with the same elementwise ops (w8
    equal); the integer sums are exact on both; only c = in_bias @ W sums
    in another order.
  * constants against numpy: w8 and a_col exactly (the same correctly
    rounded elementwise ops); b_col within the f32 error bound of the
    length-D sum c = in_bias @ W, D * 2^-24 * sum|in_bias * W|, carried
    through its two roundings.
  * DbofModel: the JAX model's tolerance for its compute dtype (1e-5 f32,
    3e-3 bf16) plus the flip bound. The two packages fold the BatchNorms
    with rsqrts that can differ by one ulp; where w'/gamma lies within
    that ulp of a .5 boundary, w8 differs by one step, which moves a
    pooled activation by at most 128 * gamma_k * |act_scale_k|. The test
    counts the flips of its own weights and carries that bound through
    the head with absolute weights (see `_flip_bound`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_model as model_tests
from yt8m_tpu.data.quantize import DEQUANT_BIAS, DEQUANT_SCALE
from yt8m_tpu.kernels.dbof import (
    dbof_cluster_maxpool_int8 as jax_int8,
    dbof_cluster_maxpool_reference,
)
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu_torch.cli import eval as eval_cli
from yt8m_tpu_torch.cli import inference as cli
from yt8m_tpu_torch.convert import save_checkpoint
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.infer.predict import format_lines, make_topk_predict_step
from yt8m_tpu_torch.kernels import dbof as tdbof
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.models import frame as tframe


def _inputs(seed, b, s, d, k):
    """Raw uint8 frames and the folded f32 vectors of a DbofModel with
    dequantization folded in (s_in around 4/255, b_in around -2)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=(b, s, d), dtype=np.uint8)
    w = (rng.normal(size=(d, k)) / np.sqrt(d)).astype(np.float32)
    s_in = (DEQUANT_SCALE * rng.uniform(0.5, 1.5, d)).astype(np.float32)
    b_in = rng.normal(-2.0, 0.1, d).astype(np.float32)
    s_act = rng.uniform(0.5, 1.5, k).astype(np.float32)
    b_act = (0.1 * rng.normal(size=k)).astype(np.float32)
    return x, w, s_in, b_in, s_act, b_act


def _numpy_constants(w, s_in, b_in, s_act, b_act):
    """A numpy copy of yt8m_tpu/kernels/dbof.py:315-323."""
    w_prime = s_in[:, None] * w
    gamma = np.maximum(np.max(np.abs(w_prime), axis=0),
                       np.float32(1e-12)) / np.float32(127.0)
    w8 = np.clip(np.round(w_prime / gamma[None, :]), -127, 127)
    colsum = np.sum(w8, axis=0, dtype=np.float32)
    c = b_in @ w
    a_col = gamma * s_act
    b_col = (np.float32(128.0) * colsum * gamma + c) * s_act + b_act
    return w8.astype(np.int8), gamma, colsum, c, a_col, b_col


def _port_constants(args):
    return tdbof.int8_serving_constants(*map(torch.from_numpy, args[1:]))


SHAPES = [(5, 7, 64, 48), (3, 30, 96, 200), (4, 1, 32, 16),
          (2, 64, 128, 136)]


@pytest.mark.parametrize("b,s,d,k", SHAPES)
def test_int8_plain_matches_pallas_interpret(b, s, d, k):
    args = _inputs(b + s + k, b, s, d, k)
    want = np.asarray(jax_int8(*map(jnp.asarray, args), interpret=True,
                               block_b=2, block_k=k))
    got = tdbof.dbof_cluster_maxpool_int8(torch.from_numpy(args[0]),
                                          *_port_constants(args)).numpy()
    assert got.shape == (b, k) and got.dtype == np.float32
    err = np.max(np.abs(got.astype(np.float64) - want))
    assert err <= 1e-5 * np.max(np.abs(want)) + 1e-7, err


@pytest.mark.parametrize("seed,d,k", [(0, 64, 48), (1, 1152, 256),
                                      (2, 96, 8)])
def test_int8_constants_match_numpy_copy(seed, d, k):
    args = _inputs(seed, 1, 1, d, k)
    w8, a_col, b_col = _port_constants(args)
    w8_np, gamma, colsum, c, a_np, b_np = _numpy_constants(*args[1:])
    assert w8.dtype == torch.int8 and tuple(w8.shape) == (d, k)
    np.testing.assert_array_equal(w8.numpy(), w8_np)
    np.testing.assert_array_equal(a_col.numpy(), a_np)
    # b_col = (128 colsum gamma + c) s_act + b_act: only c sums in another
    # order; bound its error and carry it through the two roundings.
    _, w, _, b_in, s_act, _ = args
    c_err = d * 2.0 ** -24 * (np.abs(b_in) @ np.abs(w))
    got = b_col.numpy().astype(np.float64)
    bound = (c_err * np.abs(s_act)
             + 4 * 2.0 ** -24 * np.abs(b_np.astype(np.float64)) + 1e-30)
    assert np.all(np.abs(got - b_np) <= bound)


def test_int8_constants_quantize_per_column_symmetrically():
    args = _inputs(3, 1, 1, 64, 32)
    w8, _, _ = _port_constants(args)
    w8 = w8.numpy().astype(np.int32)
    # Each column reaches +-127 at its largest |w'| and stays inside.
    assert np.all(np.max(np.abs(w8), axis=0) == 127)
    zero = tdbof.int8_serving_constants(
        torch.zeros(64, 4), torch.ones(64), torch.zeros(64), torch.ones(4),
        torch.zeros(4))
    assert torch.all(zero[0] == 0) and torch.all(torch.isfinite(zero[1]))


def test_int8_near_bf16_reference():
    """The JAX test's bound (tests/test_dbof_kernel.py): max|int8 - bf16
    oracle| under 10% of mean|oracle|."""
    args = _inputs(7, 16, 7, 256, 256)
    got = tdbof.dbof_cluster_maxpool_int8(torch.from_numpy(args[0]),
                                          *_port_constants(args)).numpy()
    want = np.asarray(dbof_cluster_maxpool_reference(
        jnp.asarray(args[0]).astype(jnp.float32),
        *map(jnp.asarray, args[1:])))
    assert np.max(np.abs(got - want)) < 0.10 * np.mean(np.abs(want))


def test_int8_frames_in_chunks_of_32_equal_one_pass():
    """The card's wrapper pools S > 32 in chunks of 32 frames and takes
    the max of the chunks: exactly the one-pass max."""
    x, *rest = _inputs(4, 3, 70, 64, 40)
    consts = _port_constants((x, *rest))
    x = torch.from_numpy(x)
    want = tdbof.dbof_cluster_maxpool_int8_plain(x, *consts)
    got = tdbof.max_over_frame_chunks(tdbof.dbof_cluster_maxpool_int8_plain,
                                      x, *consts)
    assert torch.equal(got, want)


def test_int8_padded_row_hazard():
    """Every real row is negative before the ReLU; a zero int8 row (raw
    byte 128, here the input 0 after the affine) would give relu(b_col),
    about 3. Both packages give 0."""
    x, w, s_in, b_in, s_act, b_act = _inputs(5, 4, 9, 32, 16)
    w = -np.abs(w)
    s_in = np.full_like(s_in, 1.0)
    b_in = np.full_like(b_in, -128.0)
    b_act = np.full_like(b_act, 3.0)
    x = np.maximum(x, 200).astype(np.uint8)
    args = (x, w, s_in, b_in, s_act, b_act)
    w8, a_col, b_col = _port_constants(args)
    assert torch.all(b_col > 0)  # the zero row's value
    got = tdbof.dbof_cluster_maxpool_int8(torch.from_numpy(x), w8, a_col,
                                          b_col)
    want = jax_int8(*map(jnp.asarray, args), interpret=True, block_b=2)
    assert torch.all(got == 0) and np.all(np.asarray(want) == 0)


def test_int8_rejects_float_frames_and_counts_no_cpu_launch():
    args = _inputs(6, 2, 3, 32, 16)
    consts = _port_constants(args)
    with pytest.raises(ValueError, match="uint8"):
        tdbof.dbof_cluster_maxpool_int8(
            torch.from_numpy(args[0]).to(torch.float32), *consts)
    with pytest.raises(ValueError):
        tdbof.dbof_cluster_maxpool_int8(torch.from_numpy(args[0])[0],
                                        *consts)
    before = tdbof.dbof_cluster_maxpool_int8.launches
    tdbof.dbof_cluster_maxpool_int8(torch.from_numpy(args[0]), *consts)
    assert tdbof.dbof_cluster_maxpool_int8.launches == before


# --- DbofModel --------------------------------------------------------------

INT8_CONFIGS = {
    "f32": dict(compute_dtype="float32", dbof_int8_serving=True),
    "f32_no_bn": dict(compute_dtype="float32", dbof_add_batch_norm=False,
                      dbof_int8_serving=True),
    "bf16": dict(compute_dtype="bfloat16", dbof_int8_serving=True),
}


def _jax_w8(variables, bn):
    """w8 and gamma as the JAX model computes them: its BN folds
    (jax.lax.rsqrt), dequantization folded in, the TPU wrapper's
    quantization (numpy copy)."""
    p, st = variables["params"], variables.get("batch_stats", {})
    w = np.asarray(p["cluster_kernel"])
    d, k = w.shape
    if bn:
        s_in = p["input_bn_scale"] * jax.lax.rsqrt(
            jnp.asarray(st["input_bn_var"]) + 1e-3)
        b_in = p["input_bn_bias"] - st["input_bn_mean"] * s_in
        s_act = p["cluster_bn_scale"] * jax.lax.rsqrt(
            jnp.asarray(st["cluster_bn_var"]) + 1e-3)
    else:
        s_in, b_in = jnp.ones(d), jnp.zeros(d)
        s_act = jnp.ones(k)
    b_in = DEQUANT_BIAS * s_in + b_in
    s_in = DEQUANT_SCALE * s_in
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    w8, gamma, *_ = _numpy_constants(w, f32(s_in), f32(b_in), f32(s_act),
                                     np.zeros(k, np.float32))
    return w8, gamma, f32(s_act)


def _flip_bound(model, variables):
    """Bound on |port - JAX| of the probabilities from the w8 entries
    that differ between the packages. A step of w8[d, k] moves pooled k by
    at most 128 gamma_k |act_scale_k|; that carries through the hidden FC
    and its BN with absolute weights, ReLU is 1-Lipschitz, and a
    probability sum_m softmax(g)_m sigmoid(e_m) moves by at most 2
    max|dg| + max|de| / 4. The bf16 roundings on the way scale it by
    less than (1 + 2^-6)."""
    hp = model.hp
    w8_jax, gamma, s_act = _jax_w8(variables, hp.dbof_add_batch_norm)
    w8_port = model.serving_constants()["int8"][0].numpy()
    steps = np.abs(w8_jax.astype(np.int32) - w8_port.astype(np.int32))
    e_pool = steps.sum(axis=0) * 128.0 * gamma * np.abs(s_act)
    if not np.any(e_pool):
        return 0.0
    np64 = lambda t: t.detach().double().numpy()  # noqa: E731
    e_hidden = e_pool @ np.abs(np64(model.hidden_kernel))
    if hp.dbof_add_batch_norm:
        bn = model.hidden_bn
        e_hidden *= np.abs(np64(bn.scale)) / np.sqrt(np64(bn.var) + bn.eps)
    head = model.video_classifier
    dg = e_hidden @ np.abs(np64(head.gates_kernel))
    de = e_hidden @ np.abs(np64(head.experts_kernel))
    return (1 + 2.0 ** -6) * (2 * dg.max() + de.max() / 4)


@pytest.mark.parametrize("config", sorted(INT8_CONFIGS))
def test_int8_model_matches_jax(config, monkeypatch):
    cfg = INT8_CONFIGS[config]
    feats = model_tests._features("uint8")
    jmodel = jax_get_model("DbofModel",
                           model_tests._hparams(JaxHParams, **cfg))
    variables = model_tests._jax_variables(jmodel, feats)
    want = model_tests._jax_predict(jmodel, variables, feats, monkeypatch,
                                    True)
    model = model_tests._port_model(cfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(feats),
                    torch.from_numpy(model_tests.NUM_FRAMES))
    tol = model_tests.TOL[cfg["compute_dtype"]] + _flip_bound(model,
                                                              variables)
    np.testing.assert_allclose(got["predictions"].numpy(), want, rtol=0,
                               atol=tol)


def test_int8_model_differs_from_bf16_path():
    """The flag changes the arithmetic: the int8 and bf16 paths give
    different (but close) probabilities for the same weights."""
    feats = torch.from_numpy(model_tests._features("uint8"))
    nf = torch.from_numpy(model_tests.NUM_FRAMES)
    a = get_model("DbofModel", model_tests._hparams(ModelHParams)).eval()
    b = get_model("DbofModel", model_tests._hparams(
        ModelHParams, dbof_int8_serving=True)).eval()
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        pa = a(feats, nf, u=torch.zeros(5, 1))["predictions"]
        pb = b(feats, nf, u=torch.zeros(5, 1))["predictions"]
    assert not torch.equal(pa, pb)
    assert (pa - pb).abs().max() < 0.05


def test_int8_constants_come_from_the_f32_cluster_kernel():
    """Quantizing the bf16 serving copy would give other w8 entries."""
    model = get_model("DbofModel", model_tests._hparams(
        ModelHParams, dbof_int8_serving=True, dbof_cluster_size=512)).eval()
    model.reset_parameters(torch.Generator().manual_seed(2))
    c = model.serving_constants()
    want = tdbof.int8_serving_constants(model.cluster_kernel,
                                        *c["affine_u8"], *c["act_affine"])
    from_bf16 = tdbof.int8_serving_constants(
        c["cluster_w"].to(torch.float32), *c["affine_u8"], *c["act_affine"])
    for got, ref in zip(c["int8"], want):
        assert torch.equal(got, ref)
    assert not torch.equal(c["int8"][0], from_bf16[0])


def _counting(monkeypatch, name):
    calls = []
    real = getattr(tframe, name)

    def wrapper(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(tframe, name, wrapper)
    return calls


@pytest.mark.parametrize("frames,training,use_pallas,want", [
    ("uint8", False, True, "int8"), ("float32", False, True, "v2"),
    ("uint8", True, True, "plain"), ("uint8", False, False, "v2")])
def test_int8_flag_dispatch(frames, training, use_pallas, want, monkeypatch):
    """The JAX model's condition: serving, max pooling, uint8 frames and
    --dbof_use_pallas; without the last, the bf16 function (JAX's unfused
    graph), not the int8 one."""
    int8 = _counting(monkeypatch, "dbof_cluster_maxpool_int8")
    v2 = _counting(monkeypatch, "dbof_cluster_maxpool_v2")
    model = get_model("DbofModel", model_tests._hparams(
        ModelHParams, dbof_int8_serving=True,
        dbof_use_pallas=use_pallas)).train(training)
    feats = torch.from_numpy(model_tests._features(frames))
    out = model(feats, torch.from_numpy(model_tests.NUM_FRAMES))
    assert torch.isfinite(out["predictions"]).all()
    assert (len(int8), len(v2)) == {"int8": (1, 0), "v2": (0, 1),
                                    "plain": (0, 0)}[want]
    if want == "int8":
        assert int8 == [torch.uint8]
    if not training:
        assert ("int8" in model.serving_constants()) == use_pallas


def test_inference_and_eval_cli_int8(tmp_path, monkeypatch):
    hp = ModelHParams(vocab_size=40, feature_dim=96, max_frames=20,
                      dbof_cluster_size=64, dbof_hidden_size=32,
                      iterations=8)
    data = str(tmp_path / "data")
    write_dataset(data, "test", num_shards=2, videos_per_shard=5,
                  frame_level=True, num_classes=40, seed=1, rgb_dim=64,
                  audio_dim=32, max_frames=20)
    model = get_model("DbofModel", hp)
    model.reset_parameters(torch.Generator().manual_seed(0))
    run = str(tmp_path / "run")
    save_checkpoint(run, model, "DbofModel", hp, frame_features=True,
                    feature_names="rgb,audio", feature_sizes="64,32",
                    num_classes=40, max_frames=20,
                    label_loss="CrossEntropyLoss")
    out = str(tmp_path / "out.csv")
    int8 = _counting(monkeypatch, "dbof_cluster_maxpool_int8")
    stats = cli.main([f"--input_data_pattern={data}/test-*.tfrecord",
                      f"--train_dir={run}", f"--output_file={out}",
                      "--batch_size=4", "--top_k=5", "--device=cpu",
                      "--dbof_int8_serving"])
    assert stats["num_videos"] == 10 and stats["nonfinite_predictions"] == 0
    assert len(int8) == 3  # one a batch: 4 + 4 + 2 videos

    # The CSV is the int8 model's own top-k for the CLI's sampling seed.
    int8_model = get_model("DbofModel", hp.replace(dbof_int8_serving=True))
    int8_model.load_state_dict(model.state_dict())
    step = make_topk_predict_step(int8_model.eval(), 5)
    gen = torch.Generator().manual_seed(0)
    rc = ReaderConfig("rgb,audio", "64,32", frame_features=True,
                      num_classes=40, max_frames=20)
    want = ["VideoId,LabelConfidencePairs\n"]
    for batch in BatchIterator(f"{data}/test-*.tfrecord", rc, batch_size=4):
        v, i = step(torch.from_numpy(batch["features"]),
                    torch.from_numpy(batch["num_frames"]), gen)
        keep = batch["batch_mask"] > 0
        ids = [x for x, k in zip(batch["id"], keep) if k]
        want += format_lines(ids, v.numpy()[keep], i.numpy()[keep])
    assert open(out).read() == "".join(want)

    # cli.eval serves the same run on the int8 path: a finite GAP.
    del int8[:]
    res = eval_cli.main([f"--eval_data_pattern={data}/test-*.tfrecord",
                         f"--train_dir={run}", "--run_once", "--batch_size=4",
                         "--device=cpu", "--dbof_int8_serving"])
    assert len(int8) == 3 and res["nonfinite_predictions"] == 0
    assert 0.0 <= res["gap"] <= 1.0
