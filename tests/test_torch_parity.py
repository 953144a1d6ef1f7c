"""The port's parity CLI (yt8m_tpu_torch/cli/parity.py) against the JAX
package's (yt8m_tpu/cli/parity.py).

Both CLIs run on the same files, made from a seed with numpy (the
synthetic split of tests/test_parity_harness.py): submission CSVs (plain
and gzipped), dense and sparse .npz dumps, labels from a CSV and from
TFRecords (video-level Examples and frame-level SequenceExamples, the
port's own reader beside JAX's). Each must print the same last JSON line
(every number within 1e-12: the same float64 arithmetic on the same
values, both packages' EvaluationMetrics) and return the same exit code,
0 for a pass and 1 for a fail of the bar.
"""

import gzip
import json
import os

import numpy as np
import pytest

import test_parity_harness as harness
from yt8m_tpu.cli import parity as jax_parity
from yt8m_tpu.data.synthetic import write_dataset
from yt8m_tpu_torch.cli import parity

C, K = harness.C, harness.K


def _write_dense_npz(path, preds):
    vids = sorted(preds)
    dense = np.zeros((len(vids), C), np.float32)
    for row, vid in enumerate(vids):
        idx, val = preds[vid]
        dense[row, idx] = val
    np.savez_compressed(path, ids=np.asarray(vids), predictions=dense)


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for key in a:
            _close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(a - b) <= 1e-12, (path, a, b)
    else:
        assert a == b, (path, a, b)


def _run_both(capsys, argv):
    rcs, reports = [], []
    for cli in (parity, jax_parity):
        rcs.append(cli.main(argv))
        reports.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
    _close(reports[0], reports[1])
    assert rcs[0] == rcs[1]
    return rcs[0], reports[0]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    labels, ref = harness._make_split(seed=7)
    bad = harness._degrade(ref, frac=0.6, seed=8)
    near = harness._degrade(ref, frac=0.002, seed=9)
    out = {"labels_csv": str(root / "labels.csv")}
    harness._write_labels_csv(out["labels_csv"], labels)
    for name, preds in (("ref", ref), ("bad", bad), ("near", near)):
        out[f"{name}_csv"] = str(root / f"{name}.csv")
        harness._write_csv(out[f"{name}_csv"], preds)
        out[f"{name}_sparse"] = str(root / f"{name}_sparse.npz")
        harness._write_sparse_npz(out[f"{name}_sparse"], preds)
        out[f"{name}_dense"] = str(root / f"{name}_dense.npz")
        _write_dense_npz(out[f"{name}_dense"], preds)
    with open(out["ref_csv"], "rb") as f, \
            gzip.open(str(root / "ref.csv.gz"), "wb") as g:
        g.write(f.read())
    out["ref_gz"] = str(root / "ref.csv.gz")
    return out


@pytest.mark.parametrize("ours,want_rc", [
    ("ref_csv", 0), ("ref_gz", 0), ("ref_sparse", 0), ("ref_dense", 0),
    ("near_csv", None), ("bad_csv", 1), ("bad_sparse", 1), ("bad_dense", 1),
])
def test_both_parity_clis_print_the_same_line(files, capsys, ours, want_rc):
    rc, report = _run_both(capsys, [
        f"--reference_predictions={files['ref_csv']}",
        f"--our_predictions={files[ours]}",
        f"--labels={files['labels_csv']}", f"--num_classes={C}",
        f"--top_k={K}"])
    if want_rc is not None:
        assert rc == want_rc and report["pass"] is (want_rc == 0)
    if want_rc == 0:
        assert all(abs(v) < 1e-12 for v in report["delta"].values())
    assert report["videos_compared"] == harness.N


def test_bar_and_inner_join_match(files, tmp_path, capsys):
    """A tighter --bar fails what the default passes, the same way in
    both; a reference missing videos joins on the rest."""
    argv = [f"--reference_predictions={files['ref_csv']}",
            f"--our_predictions={files['near_csv']}",
            f"--labels={files['labels_csv']}", f"--num_classes={C}"]
    loose, _ = _run_both(capsys, argv + ["--bar=0.5"])
    tight, report = _run_both(capsys, argv + ["--bar=0"])
    assert loose == 0
    assert tight == (0 if report["delta"]["gap"] == 0 else 1)
    with open(files["ref_csv"]) as f:
        lines = f.read().splitlines()
    short = str(tmp_path / "short.csv")
    with open(short, "w") as f:
        f.write("\n".join(lines[:-50]) + "\n")
    rc, report = _run_both(capsys, [
        f"--reference_predictions={short}",
        f"--our_predictions={files['ref_sparse']}",
        f"--labels={files['labels_csv']}", f"--num_classes={C}"])
    assert rc == 0 and report["videos_compared"] == harness.N - 50
    assert report["videos_ours_only"] == 50


def test_labels_from_tfrecords_match_jax(tmp_path, capsys):
    """Labels read by the port's proto/tfrecord from both wire formats
    equal JAX's, and the CLIs agree on predictions joined to them."""
    data = str(tmp_path / "data")
    write_dataset(data, "video", num_shards=1, videos_per_shard=8,
                  frame_level=False, num_classes=C, seed=3, rgb_dim=8,
                  audio_dim=4)
    write_dataset(data, "frame", num_shards=1, videos_per_shard=8,
                  frame_level=True, num_classes=C, seed=4, rgb_dim=8,
                  audio_dim=4, max_frames=16)
    for split in ("video", "frame"):
        pattern = os.path.join(data, f"{split}-*.tfrecord")
        got, want = parity.load_labels(pattern), jax_parity.load_labels(
            pattern)
        assert sorted(got) == sorted(want) and len(got) == 8
        for vid in got:
            np.testing.assert_array_equal(got[vid], want[vid])
        rng = np.random.default_rng(len(split))
        preds = {vid: (np.argsort(-rng.uniform(size=C))[:K].astype(
            np.int32), np.sort(rng.uniform(size=K))[::-1].astype(np.float64))
            for vid in got}
        csv = str(tmp_path / f"{split}.csv")
        harness._write_csv(csv, preds)
        rc, report = _run_both(capsys, [
            f"--reference_predictions={csv}", f"--our_predictions={csv}",
            f"--labels={pattern}", f"--num_classes={C}"])
        assert rc == 0 and report["videos_compared"] == 8


def test_missing_inputs_raise_the_same(tmp_path):
    for cli in (parity, jax_parity):
        with pytest.raises(SystemExit, match="--labels is required"):
            cli.main(["--reference_predictions=a", "--our_predictions=b"])
        with pytest.raises(SystemExit, match="no prediction files"):
            cli.main([f"--reference_predictions={tmp_path}/none*.csv",
                      "--our_predictions=b", "--labels=c"])
