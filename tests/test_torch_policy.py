"""The port's placement policy (model, checkpoints, corpus, trainer) against
the JAX package's, on the CPU.

Stated tolerances, each on max|got - want| against the larger of 1 and
the reference value's largest magnitude (measured maxima over this
file's cases in brackets, on the CPU):
- `score`, port (torch) against the reference's numpy and jit backends:
  1e-6 [3.9e-10]. Broadcast products summed in torch's order against
  BLAS's; f32 through three layers.
- `train`, port against the reference's, 40 and 200 full-batch epochs:
  `lossFirst` and `lossFinal` (rounded to 6 digits, as the summary keeps
  them) equal; every parameter 1e-4 [2.1e-7]. The gradient sums run in
  another order, and 200 steps compound the differences.
Checkpoint bytes: identical to the reference writer's for one model, and
across two port runs of one seed. The corpus builder and bundle reader
are copies: their arrays are equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_policy
from jobset_tpu.core import features as gates
from jobset_tpu.obs import bundle as jbundle
from jobset_tpu.policy import dataset as jdataset
from jobset_tpu.policy import features as jfeatures
from jobset_tpu.policy import model as jmodel
from jobset_tpu.policy import train as jtrain
from jobset_tpu.policy.placer import LearnedPlacement
from jobset_tpu_torch.obs import bundle as tbundle
from jobset_tpu_torch.policy import dataset as tdataset
from jobset_tpu_torch.policy import features as tfeatures
from jobset_tpu_torch.policy import model as tmodel
from jobset_tpu_torch.policy import train as ttrain
from test_policy import checkpoint, corpus_bundle  # noqa: F401 (module fixtures)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCORE_TOL = 1e-6
PARAM_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port_model(model) -> tmodel.PolicyModel:
    """The reference's PolicyModel as the port's, field by field."""
    return tmodel.PolicyModel(
        params=[(w.copy(), b.copy()) for w, b in model.params],
        feat_mean=model.feat_mean.copy(),
        feat_std=model.feat_std.copy(),
        label_mean=model.label_mean,
        label_std=model.label_std,
        history=tfeatures.DomainHistory.from_arrays(*model.history.to_arrays()),
        meta=dict(model.meta),
    )


def _port_dataset(ds) -> tdataset.Dataset:
    return tdataset.Dataset(
        features=ds.features.copy(), labels=ds.labels.copy(),
        history=tfeatures.DomainHistory.from_arrays(*ds.history.to_arrays()),
        meta=dict(ds.meta))


def _within(got, want, tol):
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def _synthetic(n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((n, jfeatures.FEATURE_DIM)) * 3).astype(np.float32)
    y = ((x[:, 0] * 5 + x[:, 3] ** 2 + rng.random(n)) * 10).astype(np.float32)
    return jdataset.Dataset(features=x, labels=y, history=jfeatures.DomainHistory(),
                            meta={"synthetic": n})


def test_schema_names_match_the_reference():
    assert tfeatures.FEATURE_NAMES == jfeatures.FEATURE_NAMES
    assert tfeatures.FEATURE_DIM == jfeatures.FEATURE_DIM == 16
    assert (tfeatures.HIST_MEAN_IDX, tfeatures.HIST_RESTART_IDX) == (
        jfeatures.HIST_MEAN_IDX, jfeatures.HIST_RESTART_IDX)
    assert tbundle.BUNDLE_SCHEMA_VERSION == jbundle.BUNDLE_SCHEMA_VERSION
    assert tmodel.CHECKPOINT_SCHEMA == jmodel.CHECKPOINT_SCHEMA
    assert tmodel.DEFAULT_HIDDEN == jmodel.DEFAULT_HIDDEN
    for seed in (0, 7):
        for (a, b), (c, d) in zip(tmodel.init_params(seed), jmodel.init_params(seed)):
            assert np.array_equal(a, c) and np.array_equal(b, d)


@pytest.mark.parametrize("rows", [1, 7, 9, 64, 960])
def test_score_matches_reference_backends(checkpoint, rows):  # noqa: F811
    ref = jmodel.load_checkpoint(checkpoint)
    port = _port_model(ref)
    feats = (np.random.default_rng(rows).random((rows, 16)) * 2).astype(np.float32)
    got = tmodel.score(port, feats, device="cpu")
    assert got.shape == (rows,) and got.dtype == np.float32
    assert _within(got, jmodel.score(ref, feats, backend="numpy"), SCORE_TOL)
    assert _within(got, jmodel.score(ref, feats, backend="jax"), SCORE_TOL)
    assert np.array_equal(tmodel.score(port, feats, backend="numpy"),
                          jmodel.score(ref, feats, backend="numpy"))


@pytest.mark.parametrize("hidden", [(32, 16), (8,), (64, 32, 16)])
def test_policy_mlp_matches_forward_np(hidden):
    params = tmodel.init_params(3, 16, hidden)
    params = [(w, np.linspace(-1, 1, b.size, dtype=np.float32)) for w, b in params]
    x = np.random.default_rng(1).standard_normal((33, 16)).astype(np.float32)
    mlp = tmodel.PolicyMLP(params, device="cpu")
    with torch.no_grad():
        got = mlp(torch.from_numpy(x)).numpy()
    assert _within(got, tmodel.forward_np(params, x), SCORE_TOL)


def test_score_rejects_a_wrong_width_and_backend(checkpoint):  # noqa: F811
    port = _port_model(jmodel.load_checkpoint(checkpoint))
    with pytest.raises(ValueError, match="feature width"):
        tmodel.score(port, np.zeros((3, 5), np.float32), device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tmodel.score(port, np.zeros((3, 16), np.float32), backend="jax", device="cpu")


def test_checkpoint_bytes_match_the_reference_writer(checkpoint, tmp_path):  # noqa: F811
    ref = jmodel.load_checkpoint(checkpoint)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tmodel.save_checkpoint(ours, _port_model(ref))
    jmodel.save_checkpoint(theirs, ref)
    with open(ours, "rb") as a, open(theirs, "rb") as b, open(checkpoint, "rb") as c:
        mine = a.read()
        assert mine == b.read() == c.read()


def test_load_reads_a_reference_checkpoint(checkpoint):  # noqa: F811
    ref = jmodel.load_checkpoint(checkpoint)
    got = tmodel.load_checkpoint(checkpoint)
    assert got.dims == ref.dims and got.meta == ref.meta
    for (a, b), (c, d) in zip(got.params, ref.params):
        assert np.array_equal(a, c) and np.array_equal(b, d)
    assert np.array_equal(got.feat_mean, ref.feat_mean)
    assert np.array_equal(got.feat_std, ref.feat_std)
    assert (got.label_mean, got.label_std) == (ref.label_mean, ref.label_std)
    assert got.history.to_arrays()[0] == ref.history.to_arrays()[0]
    assert np.array_equal(got.history.to_arrays()[1], ref.history.to_arrays()[1])


def test_corrupt_checkpoint_raises_checkpoint_error(tmp_path, checkpoint):  # noqa: F811
    """tests/test_policy.py's corrupt inputs, plus a wrong schema and a
    layer whose shape disagrees with the dims."""
    garbage = tmp_path / "x.npz"
    garbage.write_bytes(b"garbage")
    bad = str(tmp_path / "y.npz")
    np.savez(bad, nonsense=np.zeros(3))
    ref = jmodel.load_checkpoint(checkpoint)
    wrong_schema = str(tmp_path / "s.npz")
    wrong_layer = str(tmp_path / "l.npz")
    arrays = dict(np.load(checkpoint))
    tmodel._write_npz_deterministic(wrong_schema, {**arrays, "schema": np.array([2], np.int32)})
    tmodel._write_npz_deterministic(wrong_layer, {**arrays, "w0": np.zeros((3, 3), np.float32)})
    for path in (str(garbage), str(tmp_path / "missing.npz"), bad, wrong_schema, wrong_layer):
        with pytest.raises(tmodel.CheckpointError):
            tmodel.load_checkpoint(path)
        with pytest.raises(jmodel.CheckpointError):
            jmodel.load_checkpoint(path)
    assert ref.dims == tmodel.load_checkpoint(checkpoint).dims


def test_corpus_builder_matches_the_reference(corpus_bundle, tmp_path):  # noqa: F811
    ref = jdataset.build_dataset([corpus_bundle])
    got = tdataset.build_dataset([corpus_bundle])
    assert np.array_equal(got.features, ref.features)
    assert np.array_equal(got.labels, ref.labels)
    assert got.meta == ref.meta
    assert got.history.to_arrays()[0] == ref.history.to_arrays()[0]
    assert tbundle.load_bundle(corpus_bundle) == jbundle.load_bundle(corpus_bundle)
    assert tdataset.discover_bundles(os.path.dirname(corpus_bundle)) == \
        jdataset.discover_bundles(os.path.dirname(corpus_bundle))


@pytest.mark.parametrize("epochs", [40, 200])
@pytest.mark.parametrize("source", ["corpus", "synthetic"])
def test_train_matches_reference(corpus_bundle, source, epochs):  # noqa: F811
    ds = jdataset.build_dataset([corpus_bundle]) if source == "corpus" else _synthetic(300)
    ref, ref_summary = jtrain.train(ds, seed=2, epochs=epochs)
    got, summary = ttrain.train(_port_dataset(ds), seed=2, epochs=epochs, device="cpu")
    assert summary == ref_summary
    assert got.meta == ref.meta
    for (a, b), (c, d) in zip(got.params, ref.params):
        assert a.dtype == np.float32 and a.shape == c.shape
        assert _within(a, c, PARAM_TOL) and _within(b, d, PARAM_TOL)
    assert np.array_equal(got.feat_mean, ref.feat_mean)
    assert np.array_equal(got.feat_std, ref.feat_std)
    assert (got.label_mean, got.label_std) == (ref.label_mean, ref.label_std)


def test_two_port_runs_give_identical_checkpoints(corpus_bundle, tmp_path):  # noqa: F811
    ds = tdataset.build_dataset([corpus_bundle])
    paths = []
    for run in range(2):
        model, _ = ttrain.train(ds, seed=4, epochs=60, device="cpu")
        paths.append(str(tmp_path / f"run{run}.npz"))
        tmodel.save_checkpoint(paths[-1], model)
    other, _ = ttrain.train(ds, seed=5, epochs=60, device="cpu")
    tmodel.save_checkpoint(str(tmp_path / "other.npz"), other)
    blobs = [open(p, "rb").read() for p in paths + [str(tmp_path / "other.npz")]]
    assert blobs[0] == blobs[1] != blobs[2]


def test_train_bundles_to_checkpoint(corpus_bundle, tmp_path):  # noqa: F811
    out = str(tmp_path / "policy.npz")
    summary = ttrain.train_bundles_to_checkpoint(
        os.path.dirname(corpus_bundle), out, seed=3, epochs=10, device="cpu")
    assert summary["checkpoint"] == out and summary["bundles"] == 1
    assert summary["examples"] > 0
    ref = jmodel.load_checkpoint(out)  # the reference reads the port's file
    assert ref.meta["seed"] == 3 and ref.meta["epochs"] == 10
    with pytest.raises(ValueError, match="no debug bundles"):
        empty = tmp_path / "empty"
        empty.mkdir()
        ttrain.train_bundles_to_checkpoint(str(empty), out, device="cpu")
    with pytest.raises(ValueError, match="epochs"):
        ttrain.train(_port_dataset(_synthetic(8)), epochs=0, device="cpu")


def test_train_module_entry_point(corpus_bundle, tmp_path):  # noqa: F811
    out = str(tmp_path / "cli.npz")
    run = subprocess.run(
        [sys.executable, "-m", "jobset_tpu_torch.policy.train", "--bundles", corpus_bundle,
         "--out", out, "--seed", "3", "--epochs", "10", "--cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    summary = json.loads(run.stdout)
    assert summary["checkpoint"] == out and summary["epochs"] == 10
    empty = tmp_path / "empty"
    empty.mkdir()
    run = subprocess.run(
        [sys.executable, "-m", "jobset_tpu_torch.policy.train", "--bundles", str(empty),
         "--out", out, "--cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert run.returncode == 1 and "policy train:" in run.stderr


def test_active_mode_placement_through_the_port(checkpoint, monkeypatch):  # noqa: F811
    """The reference's active-mode placer with its scorer replaced by the
    port's: the event stream equals the numpy-scored run's."""
    def trace():
        with gates.gate("TPUPlacementSolver", True), gates.gate("TPULearnedPlacer", True):
            cluster = test_policy._seeded_trace(
                LearnedPlacement(checkpoint_path=checkpoint, mode="active",
                                 score_backend="numpy"))
            return test_policy.event_stream(cluster), cluster

    want, _ = trace()
    calls = []

    def port_score(self, model, feats):
        calls.append(feats.shape[0])
        return tmodel.score(_port_model(model), feats, device="cpu")

    monkeypatch.setattr(LearnedPlacement, "_score", port_score)
    got, cluster = trace()
    assert calls
    assert got == want
    test_policy._assert_fully_placed(cluster, 20)
