"""The port's experiment configs (oak_tpu_torch.experiment) against
oak_tpu's, and the port's package namespace against oak_tpu's:

- a config's JSON written by either package loads in the other to the same
  ``dataclasses.asdict``, and so does every committed
  ``examples/uci/outputs/*/config.json``;
- ``ModelConfig.build`` gives the port's ``oak_model`` the constructor
  arguments ``oak_tpu``'s build gives its own;
- ``FitConfig.run`` equals an explicit fit and optimise (full batch and
  minibatch);
- ``artifact_provenance`` reads every committed ``out_*.npz`` as
  ``oak_tpu``'s does;
- every name ``oak_tpu/__init__.py`` exports resolves on ``oak_tpu_torch``.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import oak_tpu
import oak_tpu.experiment as jexp
import oak_tpu_torch
import oak_tpu_torch.experiment as texp

REPO = Path(__file__).resolve().parents[1]
OUTPUTS = REPO / "examples" / "uci" / "outputs"
CONFIGS = sorted(OUTPUTS.glob("*/config.json"))
ARTIFACTS = sorted(OUTPUTS.glob("*/out_*.npz"))
KW = dict(dtype=torch.float64, device="cpu")
CTOR = ("max_interaction_depth", "num_inducing", "lengthscale_bounds", "binary_feature",
        "categorical_feature", "empirical_measure", "use_sparsity_prior", "gmm_measure",
        "sparse", "use_normalising_flow", "share_var_across_orders", "likelihood",
        "optimizer")


def _rich(pkg):
    return pkg.ExperimentConfig(
        dataset_name="servo", task="regression", k_folds=3, seed=11,
        data_provenance={"data_provenance": "synthetic_standin", "path": None,
                         "generator_seed": 0, "shape": [167, 4]},
        model=pkg.ModelConfig(max_interaction_depth=3, num_inducing=64, binary_feature=[0],
                              categorical_feature=[2], lengthscale_bounds=[1e-2, 1e2],
                              gmm_measure=[0, 2, 0, 0], likelihood="bernoulli"),
        fit=pkg.FitConfig(max_iters=77, restarts=2, minibatch=True, batch_size=32, steps=10),
    )


@pytest.mark.parametrize("writer,reader", [(jexp, texp), (texp, jexp)],
                         ids=["oak_tpu_to_port", "port_to_oak_tpu"])
def test_config_json_round_trips_between_packages(writer, reader, tmp_path):
    cfg = _rich(writer)
    path = tmp_path / "config.json"
    cfg.save(path)
    loaded = reader.ExperimentConfig.load(path)
    assert dataclasses.asdict(loaded) == dataclasses.asdict(cfg)
    assert loaded.to_json() == cfg.to_json()
    assert reader.ExperimentConfig.from_json(loaded.to_json()) == loaded


@pytest.mark.parametrize("path", CONFIGS, ids=[p.parent.name for p in CONFIGS])
def test_committed_config_loads_alike_and_builds_the_same_model(path):
    assert len(CONFIGS) == 5
    j = jexp.ExperimentConfig.load(path)
    t = texp.ExperimentConfig.load(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    jm, tm = j.build_model(), t.build_model(**KW)
    for name in CTOR:
        assert getattr(tm, name) == getattr(jm, name), name
    assert (tm.dtype, tm.device) == (torch.float64, torch.device("cpu"))
    # the defaults: float32 on the card, without touching it
    default = t.model.build()
    assert (default.dtype, default.device.type) == (torch.float32, "cuda")


def _data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    return X, (np.sin(X[:, 0]) + X[:, 1]).reshape(-1, 1)


def test_fit_config_run_equals_an_explicit_fit_and_optimise():
    X, y = _data()
    cfg = texp.ExperimentConfig(model=texp.ModelConfig(max_interaction_depth=2),
                                fit=texp.FitConfig(max_iters=20))
    ran = cfg.run_fold(X, y, **KW)
    by_hand = texp.ModelConfig(max_interaction_depth=2).build(**KW)
    by_hand.fit(X, y, optimise=False)
    by_hand.optimise(max_iters=20, restarts=0)
    np.testing.assert_array_equal(ran.predict(X), by_hand.predict(X))
    assert np.sqrt(np.mean((ran.predict(X) - y[:, 0]) ** 2)) < np.std(y)
    # optimise=False leaves the model as fit built it
    untrained = texp.FitConfig(optimise=False).run(cfg.build_model(**KW), X, y)
    assert untrained.timings.get("optimise") is None


def test_fit_config_minibatch_run_equals_optimise_minibatch():
    X, y = _data(80, seed=1)
    y = (X[:, 0] > 0).astype(np.float64)
    model = texp.ModelConfig(max_interaction_depth=1, num_inducing=8,
                             likelihood="bernoulli", use_normalising_flow=False)
    fit = texp.FitConfig(minibatch=True, batch_size=16, steps=5, learning_rate=2e-2, seed=3)
    ran = fit.run(model.build(**KW), X, y)
    by_hand = model.build(**KW)
    by_hand.fit(X, y, optimise=False)
    by_hand.optimise_minibatch(batch_size=16, steps=5, lr=2e-2, seed=3)
    np.testing.assert_array_equal(ran.predict_proba(X), by_hand.predict_proba(X))


@pytest.mark.parametrize("path", ARTIFACTS,
                         ids=[f"{p.parent.name}-{p.stem}" for p in ARTIFACTS])
def test_artifact_provenance_reads_committed_outputs_alike(path):
    assert texp.artifact_provenance(path) == jexp.artifact_provenance(path)


def test_artifact_provenance_of_a_reference_layout_file(tmp_path):
    path = tmp_path / "out_0.npz"
    np.savez(path, rmse=0.1, nll=0.2)
    assert texp.artifact_provenance(path) == jexp.artifact_provenance(path) == {
        "synthetic": None, "generator_seed": None, "source": "reference-layout",
        "fields": ["nll", "rmse"]}


def test_every_oak_tpu_export_resolves_on_the_port():
    """oak_tpu/__init__.py's names, read from its source: the submodules,
    classes and functions, each with its oak_tpu namesake's kind, and the
    version."""
    tree = ast.parse((REPO / "oak_tpu" / "__init__.py").read_text())
    names = [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom)
             and node.level == 1 for a in node.names]
    assert len(names) == 52
    missing = [n for n in names if not hasattr(oak_tpu_torch, n)]
    assert not missing, missing
    for n in names:
        ours, theirs = getattr(oak_tpu_torch, n), getattr(oak_tpu, n)
        assert type(ours).__name__ == type(theirs).__name__ or callable(ours), n
        if type(theirs).__name__ == "module":
            assert ours.__name__ == f"oak_tpu_torch.{n}"
    assert oak_tpu_torch.__version__ == oak_tpu.__version__
