"""The port's serving export (oak_tpu_torch.serving and
``oak_model.export_predict``) at float64 on the CPU: the cases of
tests/test_serving.py, where the port's artifact keeps the model's float64
and so matches the live predict to 1e-12 (oak_tpu's float32 artifact is
held to 1e-4), with the multi-platform case as a CPU artifact loaded with
``device="cpu"``; then the port's artifact of the committed autoMPG and
heart fold-0 models against oak_tpu's live predict within 1e-10, a 1-row
request, and ``torch.library.opcheck`` of the registered forward op on CPU
tensors."""

import numpy as np
import pytest
import torch

from oak_tpu_torch import load_oak_model
from oak_tpu_torch.model import oak_model
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.serving import deserialize_predict, serialize_predict
from oak_tpu_torch.testing import counted, prescaled_inputs
from oak_tpu_torch.utils import profiling
from tests.test_torch_uci_artifacts import CASES, committed_pair, compiled_jax_predict  # noqa: F401

KW = dict(dtype=torch.float64, device="cpu")
TOL = dict(rtol=1e-12, atol=1e-12)


def _fit(likelihood="gaussian"):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 3))
    if likelihood == "bernoulli":
        # 25 Adam steps move q(u) off its start; what is served is the point
        # (L-BFGS on an SVGP would first take 300 warm-up Adam steps)
        y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float).reshape(-1, 1)
        oak = oak_model(max_interaction_depth=2, likelihood="bernoulli", optimizer="adam", **KW)
        oak.fit(X, y, optimise=False)
        oak.optimise(max_iters=25)
    else:
        y = (np.sin(X[:, 0]) + 0.3 * X[:, 1]).reshape(-1, 1) + 0.05 * rng.normal(size=(60, 1))
        oak = oak_model(max_interaction_depth=2, **KW)
        oak.fit(X, y, optimise=False)
        oak.optimise(max_iters=40)
    return oak, X


def _served(likelihood, tmp_path_factory):
    """(model, X, mean-only artifact path, (mean, std) artifact bytes): two
    exports per model, shared by the tests."""
    oak, X = _fit(likelihood)
    path = tmp_path_factory.mktemp(likelihood) / "predict.pt2"
    blob = serialize_predict(oak, path=path)
    assert path.read_bytes() == blob
    return oak, X, path, serialize_predict(oak, include_var=True)


@pytest.fixture(scope="module")
def gaussian(tmp_path_factory):
    return _served("gaussian", tmp_path_factory)


@pytest.fixture(scope="module")
def bernoulli(tmp_path_factory):
    return _served("bernoulli", tmp_path_factory)


def _np(t):
    return t.detach().cpu().numpy()


def test_torch_serialized_predict_matches_live(gaussian):
    oak, X, path, _ = gaussian
    f = deserialize_predict(path.read_bytes())
    live = oak.predict(X, clip=True)
    served = f(X)
    assert served.dtype == torch.float64 and served.shape == (60,)
    np.testing.assert_allclose(_np(served), live, **TOL)
    # one artifact, any batch size (dynamic batch dimension), 1 row included
    for n in (1, 7, 33):
        np.testing.assert_allclose(_np(f(X[:n])), live[:n], **TOL)


def test_torch_serialized_predict_from_disk(gaussian):
    oak, X, path, _ = gaussian
    np.testing.assert_allclose(_np(deserialize_predict(path)(X)), oak.predict(X, clip=True),
                               **TOL)
    np.testing.assert_allclose(_np(deserialize_predict(str(path))(torch.as_tensor(X))),
                               oak.predict(X, clip=True), **TOL)


def test_torch_serialized_bernoulli_probs(bernoulli):
    oak, X, path, _ = bernoulli
    served = _np(deserialize_predict(path)(X))
    np.testing.assert_allclose(served, oak.predict(X, clip=True), **TOL)
    assert served.min() >= 0.0 and served.max() <= 1.0


def test_torch_serialized_predict_with_uncertainty(gaussian):
    oak, X, _, with_std = gaussian
    mean, std = (_np(a) for a in deserialize_predict(with_std)(X))
    np.testing.assert_allclose(mean, oak.predict(X, clip=True), **TOL)
    # std in the target's units: the latent std times the y scale
    with torch.no_grad():
        _, var = oak.m.predict_f(oak._tensor(oak._scaled_input(X, True)))
    expect = np.sqrt(_np(var))[:, 0] * oak.scaler_y.scale_[0]
    np.testing.assert_allclose(std, expect, **TOL)
    assert (std > 0).all()


def test_torch_serialized_bernoulli_uncertainty(bernoulli):
    oak, X, _, with_std = bernoulli
    p, std = (_np(a) for a in deserialize_predict(with_std)(X))
    np.testing.assert_allclose(std, np.sqrt(p * (1 - p)), **TOL)


def test_torch_bernoulli_artifacts_mirror_live_apis(bernoulli):
    # mean-only == predict (plug-in invlink); (mean, std) == predict_proba
    # (posterior predictive): deliberately different probabilities
    oak, X, path, with_std = bernoulli
    plug = _np(deserialize_predict(path)(X))
    post = _np(deserialize_predict(with_std)(X)[0])
    np.testing.assert_allclose(plug, oak.predict(X, clip=True), **TOL)
    np.testing.assert_allclose(post, oak.predict_proba(X, clip=True), **TOL)
    assert np.abs(plug - post).max() > 1e-6


def test_torch_cpu_artifact_loads_with_device_cpu(gaussian):
    # the counterpart of oak_tpu's multi-platform artifact: a CPU artifact,
    # loaded with device="cpu"; "tpu" names no torch device
    oak, X, _, _ = gaussian
    f = deserialize_predict(serialize_predict(oak, device="cpu"), device="cpu")
    served = f(X)
    assert served.device.type == "cpu"
    np.testing.assert_allclose(_np(served), oak.predict(X, clip=True), **TOL)
    with pytest.raises(ValueError, match="tpu"):
        serialize_predict(oak, device="tpu")


def test_torch_checkpoint_reload_then_serialize_matches(gaussian, tmp_path):
    # train -> save -> reload in a "new process" -> serialize -> serve
    oak, X, _, _ = gaussian
    ck = tmp_path / "model.npz"
    oak.save(ck)
    f = deserialize_predict(serialize_predict(load_oak_model(ck, **KW)))
    np.testing.assert_allclose(_np(f(X)), oak.predict(X, clip=True), **TOL)


def test_torch_mixed_feature_types_serving():
    # binary + categorical + continuous features, and an empirical measure
    # (its scaler) through the whole serving chain
    rng = np.random.default_rng(1)
    n = 80
    Xc = rng.normal(size=(n, 2))
    Xb = (rng.random(n) > 0.4).astype(float)
    Xcat = rng.integers(0, 3, size=n).astype(float)
    X = np.column_stack([Xc, Xb, Xcat])
    y = (np.sin(X[:, 0]) + 0.5 * Xb + 0.3 * Xcat).reshape(-1, 1) + 0.05 * rng.normal(size=(n, 1))
    oak = oak_model(max_interaction_depth=2, binary_feature=[2], categorical_feature=[3],
                    empirical_measure=[1], **KW)
    oak.fit(X, y, optimise=False)
    oak.optimise(max_iters=30)
    f = deserialize_predict(serialize_predict(oak))
    np.testing.assert_allclose(_np(f(X)), oak.predict(X, clip=True), **TOL)


def test_torch_unflowed_scalers_serving():
    # use_normalising_flow=False: the continuous scaler, after the empirical
    # one on the same column, both built per column in the graph
    rng = np.random.default_rng(2)
    X = rng.normal(size=(50, 3)) * [1.0, 3.0, 0.5] + [0.0, 2.0, -1.0]
    y = (np.sin(X[:, 0]) + 0.2 * X[:, 1]).reshape(-1, 1)
    oak = oak_model(max_interaction_depth=2, use_normalising_flow=False,
                    empirical_measure=[1], **KW)
    oak.fit(X, y, optimise=False)
    f = deserialize_predict(serialize_predict(oak, include_var=True))
    np.testing.assert_allclose(_np(f(X)[0]), oak.predict(X, clip=True), **TOL)


@pytest.mark.parametrize("dataset,task", CASES, ids=[c[0] for c in CASES])
def test_torch_artifact_of_committed_model_matches_oak_tpu_live(dataset, task,
                                                              compiled_jax_predict):
    """The committed fold-0 model, loaded into the port at float64 and
    served from its artifact, against oak_tpu's live predict of the same
    file (and, for heart, the (p, std) artifact against predict_proba) on
    the fold's test rows, within 1e-10 relative; a 1-row request too."""
    j, t, X, _ = committed_pair(dataset, task)
    f = deserialize_predict(serialize_predict(t))
    live = np.asarray(j.predict(X, clip=True))
    served = _np(f(X))
    assert np.abs(served - live).max() < 1e-10 * np.abs(live).max()
    assert np.abs(_np(f(X[:1])) - live[:1]).max() < 1e-10 * np.abs(live).max()
    if task == "classification":
        proba = np.asarray(j.predict_proba(X, clip=True))
        p, _ = deserialize_predict(serialize_predict(t, include_var=True))(X)
        assert np.abs(_np(p) - proba).max() < 1e-10 * np.abs(proba).max()


def test_torch_registered_forward_op_passes_opcheck_on_cpu():
    """oak_tpu_torch::oak_gram_fwd on CPU tensors: the schema, the fake
    against the CPU implementation (the plain version), AOT dispatch with
    dynamic shapes; and it launches nothing."""
    args = prescaled_inputs(77, 4, 12, 9, 1, 3, torch.device("cpu"))
    with profiling.recording():
        torch.library.opcheck(og.oak_gram_fwd_op, (*args, 3))
        out = og.oak_gram_fwd_op(*args, 3)
    assert torch.equal(out, og.oak_gram_plain(*args, 3)) and counted("k1.launches") == 0


def _graph_ops(blob):
    import io

    ep = torch.export.load(io.BytesIO(blob))
    return {n.target for n in ep.graph.nodes if n.op == "call_function"}


@pytest.fixture(scope="module")
def float32_cpu():
    """A float32 model on the CPU, its rows and its artifact (one export,
    shared by the two tests below)."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(40, 3))
    y = (np.sin(X[:, 0]) + 0.3 * X[:, 1]).reshape(-1, 1)
    oak = oak_model(max_interaction_depth=2, dtype=torch.float32, device="cpu")
    oak.fit(X, y, optimise=False)
    return oak, X, serialize_predict(oak)


def test_torch_card_route_traces_the_registered_op(monkeypatch, float32_cpu):
    """The graph holds the route of the device it was traced on. On the CPU
    a float32 model takes the per-dim route, so its graph has no
    oak_tpu_torch::oak_gram_fwd node. The card's route, forced here onto
    CPU tensors (the registered op, whose CPU implementation is the plain
    version), puts the node in the graph. The artifact then serves the live
    predict of that route, and the op's CPU implementation launches
    nothing."""
    from oak_tpu_torch.kernels.oak_kernel import OAKKernel

    node = torch.ops.oak_tpu_torch.oak_gram_fwd.default
    oak, X, cpu_blob = float32_cpu
    assert node not in _graph_ops(cpu_blob)

    plain_K = OAKKernel.K

    def card_route_K(self, X, X2=None):
        if X.dtype == torch.float32 and og.supports_fused(self):
            args = og._prep(self, X, X if X2 is None else X2)
            return og.oak_gram_fwd_op(*args, self.max_interaction_depth)
        return plain_K(self, X, X2)

    monkeypatch.setattr(OAKKernel, "K", card_route_K)
    blob = serialize_predict(oak)
    assert node in _graph_ops(blob)
    live = oak.predict(X, clip=True)
    with profiling.recording():
        served = _np(deserialize_predict(blob)(X))
    assert counted("k1.launches") == 0
    np.testing.assert_allclose(served, live, rtol=1e-5, atol=1e-5 * np.abs(live).max())


def test_torch_cpu_float32_artifact_refuses_the_card(float32_cpu):
    # a float32 artifact traced on the CPU holds the per-dim route: moving it
    # onto the card would serve without K1, so the loader refuses
    _, _, cpu_blob = float32_cpu
    with pytest.raises(ValueError, match="serialize the model with device='cuda'"):
        deserialize_predict(cpu_blob, device="cuda")
