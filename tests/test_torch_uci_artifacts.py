"""The port against the committed UCI models (examples/uci/outputs/, written
by oak_tpu in float32 with restarts=4 and 500-1000 iterations):

- autoMPG fold 0 (GPR, depth 7) and heart fold 0 (Bernoulli SVGP with
  binary and categorical dims) load into both packages at float64; on their
  seed-4 fold-0 test rows, predict (and predict_proba), get_loglik,
  get_sobol and get_prediction_components agree within 1e-9 relative;
- the seed-4 split reproduces the committed pumadyn fold 0's Y_scaled
  exactly, through chip_smoke.pumadyn_fold0 and through the torch UCI
  scripts' split.
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import oak_tpu
import oak_tpu_torch
from oak_tpu_torch.preprocessing import StandardScaler

REPO = Path(__file__).resolve().parents[1]
OUTPUTS = REPO / "examples" / "uci" / "outputs"
KW = dict(dtype=torch.float64, device="cpu")
REL = 1e-9


def _uci_modules():
    """examples/uci/datasets and examples/uci_torch/uci_common, imported
    from the checkout."""
    paths = [str(REPO / "examples" / "uci"), str(REPO / "examples" / "uci_torch")]
    sys.path[:0] = paths
    try:
        import datasets
        import uci_common
    finally:
        del sys.path[:len(paths)]
    return datasets, uci_common


def fold0_rows(dataset: str, task: str):
    """(X_train, y_train, X_test, y_test) of fold 0 of the committed run's
    split: the loader's rows permuted by numpy's seed-4 stream, then
    unshuffled 5-fold."""
    datasets, uci_common = _uci_modules()
    load = datasets.load_regression if task == "regression" else datasets.load_classification
    X, y, _ = load(dataset)
    perm, folds = uci_common.kfold_splits(len(X), 5, 4)
    X, y = X[perm], y[perm]
    train, test = folds[0]
    return X[train], y[train], X[test], y[test]


_COMMITTED = {}


def committed_pair(dataset: str, task: str):
    """(oak_tpu model, port model at float64 on the CPU, X_test, y_test) for
    the committed fold-0 model of ``dataset``, loaded once per test run and
    shared with test_torch_serving.py."""
    if dataset not in _COMMITTED:
        path = OUTPUTS / dataset / "model_oak_0.npz"
        _, _, X_test, y_test = fold0_rows(dataset, task)
        _COMMITTED[dataset] = (oak_tpu.load_oak_model(path),
                               oak_tpu_torch.load_oak_model(path, **KW), X_test, y_test)
    return _COMMITTED[dataset]


_PREDICT_F = {}


@pytest.fixture
def compiled_jax_predict(monkeypatch):
    """oak_tpu's committed models predict through their predict_f; called
    eagerly, JAX compiles every primitive at every shape, so the reference
    runs the same method compiled, once per model class."""
    from oak_tpu.models import GPR, SGPR, SVGP

    for cls in (GPR, SGPR, SVGP):
        if cls not in _PREDICT_F:
            _PREDICT_F[cls] = jax.jit(cls.predict_f, static_argnames=("full_cov",))
        monkeypatch.setattr(cls, "predict_f", _PREDICT_F[cls])


def _close(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max() / np.abs(ref).max())
    assert err < REL, err


CASES = [("autoMPG", "regression"), ("heart", "classification")]


@pytest.mark.parametrize("dataset,task", CASES, ids=[c[0] for c in CASES])
def test_committed_model_agrees_with_oak_tpu_at_f64(dataset, task, compiled_jax_predict):
    j, t, X, y = committed_pair(dataset, task)
    assert type(t.m).__name__ == {"autoMPG": "GPR", "heart": "SVGP"}[dataset]
    assert {p.dtype for p in t.m.parameters()} == {torch.float64}
    _close(t.predict(X, clip=True), j.predict(X, clip=True))
    ours, ref = t.get_loglik(X, y, clip=True), j.get_loglik(X, y, clip=True)
    assert abs(ours - ref) < REL * abs(ref), (ours, ref)
    _close(t.get_sobol(), j.get_sobol())
    assert [tuple(c) for c in t.tuple_of_indices] == [tuple(c) for c in j.tuple_of_indices]
    _close(t.get_prediction_components(X, clip=True), j.get_prediction_components(X, clip=True))
    if task == "classification":
        _close(t.predict_proba(X, clip=True), j.predict_proba(X, clip=True))


def test_seed4_split_reproduces_the_committed_pumadyn_fold0():
    """chip_smoke.pumadyn_fold0 permutes with numpy's seed-4 stream and
    takes the first ceil(n/5) rows as the test fold, as the UCI scripts do:
    its training targets, standardised, are the committed fold 0's
    Y_scaled to the bit, and the torch scripts' split gives the same rows."""
    Xtr, ytr, Xte, yte = chip_smoke.pumadyn_fold0()
    assert (len(Xtr), len(Xte)) == (6553, 1639)
    with np.load(OUTPUTS / "pumadyn" / "model_oak_0.npz") as f:
        committed = f["Y_scaled"]
    assert np.array_equal(StandardScaler().fit(ytr).transform(ytr), committed)
    Xtr2, ytr2, Xte2, yte2 = fold0_rows("pumadyn", "regression")
    for a, b in ((Xtr, Xtr2), (ytr, ytr2), (Xte, Xte2), (yte, yte2)):
        assert np.array_equal(a, b)
