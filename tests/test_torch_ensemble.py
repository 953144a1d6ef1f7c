"""The port's ensembles, distillation and boosting (yt8m_tpu_torch/
ensemble/, infer/ensemble_serve.py, cli/ensemble.py,
utils/convert_prediction.py, the trainer's --distill_data_pattern and
--boost_weights_file, the inference dumps) against the JAX package's,
on inputs made from numpy seeds, at small widths on the CPU.

Tolerances:
  * the numpy modules (average, fit_weights_by_gap, bagging, boost
    weights, BoostedIterator, the distill records, the ensemble CSV, the
    JSON conversion): exact, bit for bit or byte for byte (copies of the
    same numpy code on the same inputs);
  * EnsembleServe against JAX EnsembleServe.apply on converted weights,
    float32: <= 1e-5 * max|ref| (tests/test_torch_zoo.py's float32
    bound: summation order, the BN folds);
  * the first training loss with a teacher and with example weights
    against the JAX step's, float32: 1e-5 relative (the trajectory bound
    of tests/test_torch_trainer.py);
  * the on-device ensemble's dump against the host average of its
    members' dumps: 1e-6 * max|ref| (one f32 sum of two products against
    numpy's float64 sum rounded to f32).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yt8m_tpu.cli import ensemble as jax_cli_ensemble
from yt8m_tpu.data.pipeline import make_batch_iterator as jax_batches
from yt8m_tpu.data.readers import ReaderConfig as JaxReaderConfig
from yt8m_tpu.ensemble import average as jax_average
from yt8m_tpu.ensemble import bagging as jax_bagging
from yt8m_tpu.ensemble import boosting as jax_boosting
from yt8m_tpu.ensemble import distill as jax_distill
from yt8m_tpu.infer.ensemble_serve import EnsembleServe as JaxEnsembleServe
from yt8m_tpu.models import ModelHParams as JaxHParams
from yt8m_tpu.models import get_model as jax_get_model
from yt8m_tpu.train import losses as jax_losses
from yt8m_tpu.train.state import TrainState as JaxTrainState
from yt8m_tpu.train.state import make_optimizer as jax_make_optimizer
from yt8m_tpu.train.step import make_train_step as jax_make_train_step
from yt8m_tpu.utils import convert_prediction as jax_convert
from yt8m_tpu_torch.cli import ensemble as cli_ensemble
from yt8m_tpu_torch.cli import eval as cli_eval
from yt8m_tpu_torch.cli import inference as cli_inference
from yt8m_tpu_torch.cli import train as cli_train
from yt8m_tpu_torch.config import InferenceConfig
from yt8m_tpu_torch.convert import state_dict_from_jax
from yt8m_tpu_torch.data.pipeline import make_batch_iterator
from yt8m_tpu_torch.data.readers import BatchIterator, ReaderConfig
from yt8m_tpu_torch.data.synthetic import write_dataset
from yt8m_tpu_torch.ensemble import average, bagging, boosting, distill
from yt8m_tpu_torch.ensemble.checkpoints import (
    average_checkpoint_weights,
    ensemble_checkpoint_predictions,
)
from yt8m_tpu_torch.infer.ensemble_serve import EnsembleServe, build_ensemble
from yt8m_tpu_torch.models import ModelHParams, get_model
from yt8m_tpu_torch.train import losses as tlosses
from yt8m_tpu_torch.train.checkpoint import step_dirs
from yt8m_tpu_torch.train.loop import to_device
from yt8m_tpu_torch.train.state import TrainState
from yt8m_tpu_torch.train.step import make_train_step
from yt8m_tpu_torch.utils import convert_prediction

C, D_RGB, D_AUDIO, MAXF = 12, 12, 4, 20
D = D_RGB + D_AUDIO
READER = ["--frame_features", "--feature_names=rgb,audio",
          f"--feature_sizes={D_RGB},{D_AUDIO}", f"--num_classes={C}",
          f"--max_frames={MAXF}", "--device=cpu"]
MEMBERS = {
    "vlad": ["--model=NetVladModel", "--netvlad_cluster_size=8",
             "--netvlad_hidden_size=16", "--compute_dtype=float32"],
    "dbof": ["--model=DbofModel", "--dbof_cluster_size=16",
             "--dbof_hidden_size=8", "--iterations=6",
             "--compute_dtype=float32"],
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ensemble_data"))
    for split, seed in (("train", 4), ("validate", 5)):
        write_dataset(root, split, num_shards=2, videos_per_shard=8,
                      frame_level=True, num_classes=C, seed=seed,
                      rgb_dim=D_RGB, audio_dim=D_AUDIO, max_frames=2 * MAXF,
                      min_frames=1)
    return root


def _dump_dirs(root, seed=0, n=24):
    """Three members' dumps of the same n ids: dense, dense in another id
    order and in two chunks, and sparse top-5."""
    rng = np.random.default_rng(seed)
    ids = np.asarray([f"vid{i:03d}" for i in range(n)])
    dirs = []
    for m in range(3):
        d = os.path.join(root, f"member{m}")
        os.makedirs(d)
        preds = rng.random((n, C)).astype(np.float32)
        if m == 0:
            np.savez_compressed(os.path.join(d, "predictions-00000.npz"),
                                ids=ids, predictions=preds)
        elif m == 1:
            perm = rng.permutation(n)
            for c, part in enumerate(np.array_split(perm, 2)):
                np.savez_compressed(
                    os.path.join(d, f"predictions-{c:05d}.npz"),
                    ids=ids[part], predictions=preds[part])
        else:
            idx = np.argsort(-preds, axis=1)[:, :5].astype(np.int32)
            np.savez_compressed(
                os.path.join(d, "predictions-00000.npz"), ids=ids,
                values=np.take_along_axis(preds, idx, 1), indices=idx,
                num_classes=np.int32(C))
        dirs.append(d)
    return dirs


def test_average_and_fitted_weights_match_jax(tmp_path, data):
    dirs = _dump_dirs(str(tmp_path))
    members = [average.load_prediction_dir(d) for d in dirs]
    jmembers = [jax_average.load_prediction_dir(d) for d in dirs]
    for (ids, p), (jids, jp) in zip(members, jmembers):
        assert ids == jids
        np.testing.assert_array_equal(p, jp)
    ids, aligned = average.align_members(members)
    jids, jaligned = jax_average.align_members(jmembers)
    assert ids == jids
    for a, b in zip(aligned, jaligned):
        np.testing.assert_array_equal(a, b)
    for w in (None, [1.0, 2.0, 0.5]):
        np.testing.assert_array_equal(average.weighted_average(aligned, w),
                                      jax_average.weighted_average(
                                          jaligned, w))
    labels = (np.random.default_rng(1).random((len(ids), C)) < 0.2
              ).astype(np.float32)
    assert (average.fit_weights_by_gap(aligned, labels, top_k=5)
            == jax_average.fit_weights_by_gap(jaligned, labels, top_k=5))
    pattern = os.path.join(data, "validate-*.tfrecord")
    got = average.labels_from_tfrecords(pattern, True, C)
    want = jax_average.labels_from_tfrecords(pattern, True, C)
    assert sorted(got) == sorted(want)
    for vid in want:
        np.testing.assert_array_equal(got[vid], want[vid])
    for w in (None, [1.0, 0.0, 2.0]):
        out, jout = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
        a = average.ensemble_directories(dirs, w, out, top_k=4)
        b = jax_average.ensemble_directories(dirs, w, jout, top_k=4)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        with open(out) as f, open(jout) as g:
            assert f.read() == g.read()


def test_bagging_matches_jax(data):
    pattern = os.path.join(data, "*.tfrecord")
    for bags in (2, 3):
        for i in range(bags):
            for holdout in (False, True):
                assert (bagging.bag_files(pattern, bags, i, holdout)
                        == jax_bagging.bag_files(pattern, bags, i, holdout))


def test_boost_weights_and_boosted_iterator_match_jax(tmp_path, data):
    rng = np.random.default_rng(2)
    ids = [f"v{i}".encode() for i in range(30)]
    preds = rng.random((30, C)).astype(np.float32)
    labels = (rng.random((30, C)) < 0.3).astype(np.float32)
    for beta, clip in ((1.0, 5.0), (3.0, 2.0)):
        got = boosting.fit_boost_weights(ids, preds, labels, beta, clip)
        assert got == jax_boosting.fit_boost_weights(ids, preds, labels,
                                                     beta, clip)
    path = str(tmp_path / "w.npz")
    boosting.save_boost_weights(path, got)
    assert boosting.load_boost_weights(path) == \
        jax_boosting.load_boost_weights(path)
    pattern = os.path.join(data, "train-*.tfrecord")
    vids = [v.decode() for b in BatchIterator(pattern, _reader(), 16)
            for v in b["id"]]
    weights = {v: float(w) for v, w in zip(vids, rng.uniform(0.2, 3.0, 16))}
    rc = _reader()
    jrc = JaxReaderConfig("rgb,audio", f"{D_RGB},{D_AUDIO}", True,
                          num_classes=C, max_frames=MAXF)
    got = list(boosting.BoostedIterator(
        make_batch_iterator(pattern, rc, 5, shuffle=True, seed=1), weights))
    want = list(jax_boosting.BoostedIterator(
        jax_batches(pattern, jrc, 5, shuffle=True, seed=1), weights))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g["id"] == w["id"]
        np.testing.assert_array_equal(g["example_weights"],
                                      w["example_weights"])
        np.testing.assert_array_equal(g["features"], w["features"])


def _reader(**kw):
    return ReaderConfig("rgb,audio", f"{D_RGB},{D_AUDIO}", True,
                        num_classes=C, max_frames=MAXF, **kw)


def test_distill_records_match_jax(tmp_path, data):
    pattern = os.path.join(data, "train-*.tfrecord")
    rng = np.random.default_rng(3)
    vids = [v.decode() for b in BatchIterator(pattern, _reader(), 16)
            for v in b["id"]]
    teacher = {v: rng.random(C).astype(np.float32) for v in vids[:-3]}
    for k in (None, 5):
        port_dir = str(tmp_path / f"port{k}")
        jax_dir = str(tmp_path / f"jax{k}")
        n = distill.write_distill_dataset(pattern, teacher, port_dir, True, k)
        assert n == jax_distill.write_distill_dataset(pattern, teacher,
                                                      jax_dir, True, k)
        assert n == len(vids) - 3
        for name in sorted(os.listdir(jax_dir)):
            with open(os.path.join(port_dir, name), "rb") as f, \
                    open(os.path.join(jax_dir, name), "rb") as g:
                assert f.read() == g.read()
    # The port's readers read the teacher back (zeros for the three
    # videos without one), as JAX's do.
    rc = _reader(distill_feature="predictions", distill_dim=C)
    jrc = JaxReaderConfig("rgb,audio", f"{D_RGB},{D_AUDIO}", True,
                          num_classes=C, max_frames=MAXF,
                          distill_feature="predictions", distill_dim=C)
    pattern = os.path.join(str(tmp_path / "port5"), "*.tfrecord")
    want = list(jax_batches(pattern, jrc, 16))
    for got in (list(make_batch_iterator(pattern, rc, 16)),
                list(BatchIterator(pattern, rc, 16))):
        assert len(got) == len(want) == 1
        np.testing.assert_array_equal(got[0]["teacher"], want[0]["teacher"])
    assert np.count_nonzero(want[0]["teacher"].sum(axis=1) == 0) == 3
    assert set(np.count_nonzero(want[0]["teacher"], axis=1)) <= {0, 5}
    dump = str(tmp_path / "dump")
    os.makedirs(dump)
    np.savez_compressed(os.path.join(dump, "predictions-00000.npz"),
                        ids=np.asarray(list(teacher)),
                        predictions=np.stack(list(teacher.values())))
    got = distill.teacher_from_prediction_dir(dump)
    want = jax_distill.teacher_from_prediction_dir(dump)
    assert sorted(got) == sorted(want)
    for v in want:
        np.testing.assert_array_equal(got[v], want[v])


def test_convert_prediction_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "preds.json"
    with open(path, "w") as f:
        for i in range(6):
            idx = rng.permutation(40)[:25].tolist()
            f.write(json.dumps({"video_id": f"v{i}", "class_indexes": idx,
                                "predictions": rng.random(25).tolist()})
                    + "\n\n")
    got, want = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    assert (convert_prediction.convert(str(path), got, 20)
            == jax_convert.convert(str(path), want, 20) == 6)
    with open(got) as f, open(want) as g:
        assert f.read() == g.read()


WIDTHS = dict(vocab_size=C, feature_dim=D, max_frames=MAXF,
              dbof_cluster_size=16, dbof_hidden_size=8, iterations=MAXF,
              sample_random_frames=False, netvlad_cluster_size=8,
              netvlad_hidden_size=16, compute_dtype="float32")


def _inputs(seed=0, b=5):
    rng = np.random.default_rng(seed)
    feats = rng.integers(0, 256, size=(b, MAXF, D), dtype=np.uint8)
    nf = rng.integers(1, MAXF + 1, size=b).astype(np.int32)
    nf[0] = MAXF
    return feats, nf


def _jax_members(names, feats, nf):
    models, variables = [], []
    for i, name in enumerate(names):
        jmodel = jax_get_model(name, JaxHParams(**WIDTHS))
        v = jmodel.init({"params": jax.random.PRNGKey(i),
                         "sample": jax.random.PRNGKey(9)},
                        jnp.asarray(feats), jnp.asarray(nf), train=False)
        rng = np.random.default_rng(10 + i)
        # BN statistics and 1-D parameters drawn, so that each acts
        v = jax.tree_util.tree_map_with_path(
            lambda p, a: (rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
                          if str(getattr(p[-1], "key", p[-1])).endswith("var")
                          else (np.asarray(a) + 0.3 * rng.normal(
                              size=a.shape)).astype(np.float32)
                          if np.ndim(a) == 1 else np.asarray(a)), v)
        models.append(jmodel)
        variables.append(v)
    return models, variables


def test_ensemble_serve_matches_jax(monkeypatch):
    monkeypatch.delenv("YT8M_PALLAS_INTERPRET", raising=False)
    names = ("NetVladModel", "DbofModel")
    feats, nf = _inputs()
    jmodels, jvars = _jax_members(names, feats, nf)
    weights = [0.7, 1.9]
    want = np.asarray(JaxEnsembleServe(jmodels, weights).apply(
        {"params": tuple(v["params"] for v in jvars),
         "batch_stats": tuple(v.get("batch_stats", {}) for v in jvars)},
        jnp.asarray(feats), jnp.asarray(nf), train=False,
        rngs={"sample": jax.random.PRNGKey(3)})["predictions"])
    members = []
    for name, v in zip(names, jvars):
        m = get_model(name, ModelHParams(**WIDTHS))
        m.load_state_dict(state_dict_from_jax(v))
        members.append(m)
    ens = EnsembleServe(members, weights).eval()
    assert ens.weights == pytest.approx([0.7 / 2.6, 1.9 / 2.6])
    with torch.inference_mode():
        got = ens(torch.from_numpy(feats), torch.from_numpy(nf))[
            "predictions"].numpy()
    assert got.dtype == np.float32 and got.shape == (5, C)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="inference-only"):
        ens.train()(torch.from_numpy(feats), torch.from_numpy(nf))
    with pytest.raises(ValueError, match="sum to > 0"):
        EnsembleServe(members, [0.0, 0.0])


@pytest.mark.parametrize("loss", ["MixedCrossEntropyDistillLoss",
                                  "CrossEntropyLoss"])
def test_first_loss_with_teacher_and_example_weights_matches_jax(
        tmp_path, data, loss):
    """A batch of distill records, boosted, through to_device: the teacher
    and the example weights reach the step, whose loss is JAX's."""
    pattern = os.path.join(data, "train-*.tfrecord")
    rng = np.random.default_rng(6)
    vids = [v.decode() for b in BatchIterator(pattern, _reader(), 16)
            for v in b["id"]]
    teacher = {v: rng.random(C).astype(np.float32) for v in vids}
    distill.write_distill_dataset(pattern, teacher, str(tmp_path), True, 6)
    weights = {v: float(w) for v, w in zip(vids, rng.uniform(0.2, 3, 16))}
    rc = _reader(distill_feature="predictions", distill_dim=C)
    batch = next(iter(boosting.BoostedIterator(make_batch_iterator(
        str(tmp_path / "*.tfrecord"), rc, 7, shuffle=True, seed=2),
        weights)))
    tb = to_device(batch, torch.device("cpu"))
    assert set(tb) == {"features", "labels", "num_frames", "batch_mask",
                       "teacher", "example_weights"}
    np.testing.assert_array_equal(tb["teacher"].numpy(), batch["teacher"])
    np.testing.assert_array_equal(tb["example_weights"].numpy(),
                                  batch["example_weights"])
    kw = {"alpha": 0.3} if loss != "CrossEntropyLoss" else {}
    jmodel = jax_get_model("NetVladModel", JaxHParams(**WIDTHS))
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(batch["features"]), jnp.asarray(batch["num_frames"]),
        train=False)
    jstate = JaxTrainState.create(
        apply_fn=jmodel.apply, params=variables["params"],
        batch_stats=variables.get("batch_stats", {}),
        tx=jax_make_optimizer(optimizer="SgdOptimizer",
                              base_learning_rate=0.01,
                              global_batch_size=7))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items() if k != "id"}
    _, jm = jax_make_train_step(jmodel, jax_losses.get_loss(loss, **kw),
                                donate=False)(jstate, jbatch,
                                              jax.random.PRNGKey(0))
    model = get_model("NetVladModel", ModelHParams(**WIDTHS))
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)))
    state = TrainState(model, optimizer="SgdOptimizer",
                       base_learning_rate=0.01, global_batch_size=7)
    _, pm = make_train_step(tlosses.get_loss(loss, **kw))(state, tb)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    # Without them the loss is another one.
    plain = {k: v for k, v in tb.items()
             if k not in ("teacher", "example_weights")}
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)))
    _, pm2 = make_train_step(tlosses.get_loss(loss, **kw))(
        TrainState(model, optimizer="SgdOptimizer"), plain)
    assert abs(float(pm2["loss"]) - float(jm["loss"])) > 1e-3


@pytest.fixture(scope="module")
def members(data, tmp_path_factory):
    """Two members trained 3 steps through cli.train (a checkpoint a
    step), each with its train-split dump, dense, from cli.inference."""
    root = str(tmp_path_factory.mktemp("members"))
    out = {}
    for name, flags in MEMBERS.items():
        run = os.path.join(root, name)
        assert cli_train.main([
            f"--train_data_pattern={data}/train-*.tfrecord",
            f"--train_dir={run}", "--batch_size=8", "--max_steps=3",
            "--save_checkpoint_every_n_steps=1", "--log_every_n_steps=1",
            "--optimizer=SgdOptimizer", "--base_learning_rate=0.1",
            *flags, *READER]) == 3
        dump = os.path.join(root, f"{name}_train_probs")
        stats = cli_inference.main([
            f"--input_data_pattern={data}/train-*.tfrecord",
            f"--train_dir={run}", f"--output_probabilities_dir={dump}",
            "--output_file=", "--batch_size=5", "--device=cpu"])
        assert stats["num_videos"] == 16 and stats["reader"] in (
            "native", "python")
        out[name] = (run, dump)
    return root, out


def test_dumps_hold_the_models_probabilities(members, data, tmp_path):
    root, runs = members
    run, dump = runs["vlad"]
    ids, dense = average.load_prediction_dir(dump)
    assert len(ids) == 16 and dense.shape == (16, C)
    assert len(os.listdir(dump)) == 4  # batches of 5 over 16 videos
    cfg = InferenceConfig(train_dir=run, device="cpu")
    from yt8m_tpu_torch.convert import load_model
    from yt8m_tpu_torch.utils.flags import apply_recorded_model_flags

    apply_recorded_model_flags(cfg, [])
    model = load_model(run, cfg.model, cfg.resolved_hparams(), "cpu")
    # The dump's batches of 5, computed again by the model.
    want, want_ids = [], []
    for batch in BatchIterator(f"{data}/train-*.tfrecord", _reader(), 5):
        keep = batch["batch_mask"] > 0
        with torch.inference_mode():
            want.append(model(torch.from_numpy(batch["features"]),
                              torch.from_numpy(batch["num_frames"]))[
                "predictions"].numpy()[keep])
        want_ids += [v.decode() for v, m in zip(batch["id"], keep) if m]
    assert ids == want_ids
    np.testing.assert_array_equal(dense, np.concatenate(want))
    # The sparse top-4 dump in float16 densifies to those values.
    sparse = str(tmp_path / "sparse")
    cli_inference.main([
        f"--input_data_pattern={data}/train-*.tfrecord", f"--train_dir={run}",
        f"--output_probabilities_dir={sparse}", "--output_file=",
        "--output_probabilities_topk=4", "--output_probabilities_dtype=float16",
        "--batch_size=5", "--device=cpu"])
    with np.load(os.path.join(sparse, "predictions-00000.npz")) as z:
        assert z["values"].dtype == np.float16 and int(z["num_classes"]) == C
        assert z["indices"].shape == (5, 4)
    sids, sdense = average.load_prediction_dir(sparse)
    assert sids == ids
    top = np.sort(dense, axis=1)[:, ::-1][:, :4]
    np.testing.assert_array_equal(np.sort(sdense, axis=1)[:, ::-1][:, :4],
                                  top.astype(np.float16).astype(np.float32))
    with pytest.raises(SystemExit, match="output_probabilities_dir"):
        cli_inference.main([f"--input_data_pattern={data}/train-*.tfrecord",
                            f"--train_dir={run}", "--device=cpu"])


def test_cli_ensemble_matches_jax_and_the_served_ensemble(members, data,
                                                          tmp_path, capsys):
    root, runs = members
    dumps = ",".join(runs[n][1] for n in MEMBERS)
    labels = f"--eval_labels_pattern={data}/train-*.tfrecord"
    got_csv, want_csv = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    out = cli_ensemble.main([f"--member_dirs={dumps}", "--fit_weights",
                             labels, "--frame_features", f"--num_classes={C}",
                             f"--output_file={got_csv}", "--top_k=5"])
    jax_cli_ensemble.main([f"--member_dirs={dumps}", "--fit_weights", labels,
                           "--frame_features", f"--num_classes={C}",
                           f"--output_file={want_csv}", "--top_k=5"])
    printed = capsys.readouterr().out.split()
    assert printed[0::2] == ["GAP", "GAP"] and printed[1] == printed[3]
    assert out["num_videos"] == 16 and 0.0 <= out["gap"] <= 1.0
    with open(got_csv) as f, open(want_csv) as g:
        assert f.read() == g.read()
    # Served on the device: the same two members (the DbofModel member
    # over all its frames), weighted 1:3, dumped dense.
    served = str(tmp_path / "served")
    flags = [f"--ensemble_train_dirs={runs['vlad'][0]},{runs['dbof'][0]}",
             "--ensemble_weights=1,3", *READER[:-1], "--device=cpu"]
    stats = cli_inference.main([
        f"--input_data_pattern={data}/train-*.tfrecord",
        f"--output_probabilities_dir={served}",
        f"--output_file={tmp_path / 'served.csv'}", "--batch_size=16",
        *flags])
    assert stats["num_videos"] == 16 and stats["nonfinite_predictions"] == 0
    ids, ens = average.load_prediction_dir(served)
    members_dumps = [average.load_prediction_dir(runs[n][1]) for n in MEMBERS]
    # The DbofModel member samples frames: its dump is from another draw,
    # so hold the ensemble to its members served with one generator.
    vlad_ids, vlad = members_dumps[0]
    assert ids == vlad_ids
    model = build_ensemble(InferenceConfig(**_cfg_kw(), ensemble_train_dirs=(
        f"{runs['vlad'][0]},{runs['dbof'][0]}"), ensemble_weights="1,3",
        device="cpu"), torch.device("cpu"))
    batch = next(iter(BatchIterator(f"{data}/train-*.tfrecord", _reader(),
                                    16)))
    feats = torch.from_numpy(batch["features"])
    nf = torch.from_numpy(batch["num_frames"])
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        parts = [m(feats, nf, generator=gen)["predictions"].numpy()
                 for m in model.members]
    host = average.weighted_average(parts, [1, 3])
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        dev = model(feats, nf, generator=gen)["predictions"].numpy()
    np.testing.assert_allclose(dev, host, rtol=0,
                               atol=1e-6 * np.abs(host).max())
    order = [ids.index(v.decode()) for v in batch["id"]]
    np.testing.assert_array_equal(ens[order], dev)
    # cli.eval of the ensemble: step None, no summary in a member's dir.
    res = cli_eval.main([f"--eval_data_pattern={data}/validate-*.tfrecord",
                         *flags, "--batch_size=8", "--top_k=5"])
    assert res["step"] is None and 0.0 <= res["gap"] <= 1.0
    assert res["reader"] == stats["reader"]
    for run, _ in runs.values():
        assert not os.path.exists(os.path.join(run, "eval"))


def _cfg_kw():
    return dict(frame_features=True, feature_names="rgb,audio",
                feature_sizes=f"{D_RGB},{D_AUDIO}", num_classes=C,
                max_frames=MAXF)


def test_build_ensemble_rebuilds_each_member_and_refuses_mismatch(
        members, tmp_path):
    root, runs = members
    dirs = f"{runs['vlad'][0]},{runs['dbof'][0]}"
    model = build_ensemble(InferenceConfig(
        **_cfg_kw(), ensemble_train_dirs=dirs, device="cpu"), "cpu")
    assert [type(m).__name__ for m in model.members] == ["NetVladModel",
                                                         "DbofModel"]
    assert model.weights == [0.5, 0.5] and model.checkpoint_step is None
    assert model.members[1].hp.dbof_cluster_size == 16
    for kw, match in ((dict(num_classes=C + 1), "vocab_size"),
                      (dict(max_frames=MAXF + 1), "max_frames"),
                      (dict(ensemble_weights="1"), "ensemble_weights"),
                      (dict(ensemble_models="DbofModel"), "ensemble_models")):
        with pytest.raises(SystemExit, match=match):
            build_ensemble(InferenceConfig(**{**_cfg_kw(), **kw},
                                           ensemble_train_dirs=dirs), "cpu")
    with pytest.raises(SystemExit, match="ema_decay"):
        build_ensemble(InferenceConfig(**_cfg_kw(), ensemble_train_dirs=dirs,
                                       use_ema_weights=True), "cpu")
    # Weights only: a member without optimizer state serves.
    bare = str(tmp_path / "bare")
    shutil.copytree(runs["vlad"][0], bare)
    for s in step_dirs(bare):
        os.remove(os.path.join(bare, str(s), "optimizer.pt"))
    model = build_ensemble(InferenceConfig(
        **_cfg_kw(), ensemble_train_dirs=f"{bare},{bare}",
        checkpoint_step=2), "cpu")
    assert len(model.members) == 2


def test_boosted_and_distilled_training_through_the_cli(members, data,
                                                        tmp_path, caplog):
    root, runs = members
    weights = str(tmp_path / "boost.npz")
    boosting.main([f"--predictions_dir={runs['vlad'][1]}",
                   f"--train_data_pattern={data}/train-*.tfrecord",
                   f"--output={weights}", f"--num_classes={C}"])
    jweights = str(tmp_path / "jax_boost.npz")
    jax_boosting.main([f"--predictions_dir={runs['vlad'][1]}",
                       f"--train_data_pattern={data}/train-*.tfrecord",
                       f"--output={jweights}", f"--num_classes={C}"])
    assert (boosting.load_boost_weights(weights)
            == jax_boosting.load_boost_weights(jweights))
    assert len(boosting.load_boost_weights(weights)) == 16
    caplog.set_level("INFO", logger="yt8m_tpu_torch")
    assert cli_train.main([
        f"--train_data_pattern={data}/train-*.tfrecord",
        f"--train_dir={tmp_path / 'boosted'}", "--batch_size=8",
        "--max_steps=2", "--log_every_n_steps=1",
        f"--boost_weights_file={weights}", *MEMBERS["dbof"], *READER]) == 2
    teacher = distill.teacher_from_prediction_dir(runs["vlad"][1])
    assert distill.write_distill_dataset(
        f"{data}/train-*.tfrecord", teacher, str(tmp_path / "distill"),
        frame_level=True, top_k_sparsify=4) == 16
    assert cli_train.main([
        f"--train_data_pattern={tmp_path / 'distill'}/train-*.tfrecord",
        f"--train_dir={tmp_path / 'student'}", "--batch_size=8",
        "--max_steps=2", "--log_every_n_steps=1",
        "--distill_data_pattern=teacher",
        "--label_loss=MixedCrossEntropyDistillLoss", "--num_readers=2",
        *MEMBERS["vlad"], *READER]) == 2
    readers = [r.getMessage() for r in caplog.records
               if "reader" in r.getMessage() and "reading" in r.getMessage()]
    assert len(readers) == 2
    kinds = {m.split(" with the ")[1].split()[0] for m in readers}
    assert kinds <= {"native", "threaded", "python"}
    losses = [float(r.getMessage().split("Loss: ")[1].split()[0])
              for r in caplog.records if "Loss: " in r.getMessage()]
    assert len(losses) == 4 and all(np.isfinite(losses))


def test_checkpoint_ensembles(members, data, tmp_path):
    root, runs = members
    run = runs["vlad"][0]
    steps = step_dirs(run)
    assert steps[-2:] == [2, 3]
    cfg = InferenceConfig(**_cfg_kw(), train_dir=run, model="NetVladModel",
                          input_data_pattern=f"{data}/train-*.tfrecord",
                          batch_size=16, device="cpu", top_k=5)
    cfg.hparams = ModelHParams(netvlad_cluster_size=8, netvlad_hidden_size=16,
                               compute_dtype="float32")
    model = get_model("NetVladModel", cfg.resolved_hparams())
    average_checkpoint_weights(run, model, last_n=2)
    states = [torch.load(os.path.join(run, str(s), "model.pt"),
                         weights_only=True) for s in (2, 3)]
    for name, value in model.state_dict().items():
        want = ((states[0][name].double() + states[1][name].double()) / 2
                ).to(value.dtype)
        assert torch.equal(value, want), name
    csv = str(tmp_path / "ckpt.csv")
    ids, avg = ensemble_checkpoint_predictions(
        cfg, last_n=2, output_dir=str(tmp_path / "ckpts"), output_csv=csv)
    assert len(ids) == 16 and avg.shape == (16, C)
    assert sorted(os.listdir(tmp_path / "ckpts")) == ["step2", "step3"]
    with open(csv) as f:
        assert len(f.read().splitlines()) == 17
    # The averaged model serves through the inference loop.
    from yt8m_tpu_torch.infer.predict import inference

    cfg.output_file = str(tmp_path / "avg.csv")
    stats = inference(cfg, model=model.eval())
    assert stats["num_videos"] == 16 and stats["nonfinite_predictions"] == 0
