"""The plain references against the port at small sizes on the CPU, in
float64: the OAK gram and its diagonal, the SVGP and SGPR losses with their
gradients, the flows and the k-means step."""

import numpy as np
import pytest
import torch

from benchmark import data
from benchmark.models import svgp as svgp_kind
from benchmark.reference import flows as ref_flows
from benchmark.reference import oak as ref_oak
from benchmark.reference import sgpr as ref_sgpr
from benchmark.reference import svgp as ref_svgp

KW = dict(dtype=torch.float64, device="cpu")
CFG = {"num_data": 300, "num_dims": 4, "num_inducing": 24, "max_interaction_depth": 3,
       "use_sparsity_prior": True, "lengthscale_bounds": [1e-3, 1e3], "noise_variance": 0.01,
       "q_diag": True, "whiten": True, "dtype": "float64", "noise_floor": 1e-6,
       "jitter": 1e-6, "order_variance_prior": [1.0, 0.2]}


def _kernel(D, depth, seed):
    from oak_tpu_torch import OAKKernel

    gen = np.random.default_rng(seed)
    k = OAKKernel.create(num_dims=D, max_interaction_depth=depth, use_sparsity_prior=True,
                         lengthscale_bounds=[1e-3, 1e3], **KW)
    ls, sig2 = gen.uniform(0.5, 2.0, D), gen.uniform(0.2, 1.0, depth + 1)
    for d, sub in enumerate(k.kernels):
        sub.lengthscale.assign(ls[d])
    for n, v in enumerate(k.variances):
        v.assign(sig2[n])
    return k, torch.as_tensor(ls, **KW), torch.as_tensor(sig2, **KW)


@pytest.mark.parametrize("D,depth", [(3, 2), (5, 3), (6, 6)])
def test_oak_gram_and_diag(D, depth):
    k, ls, sig2 = _kernel(D, depth, D)
    gen = np.random.default_rng(1)
    X, X2 = (torch.as_tensor(gen.normal(size=(n, D)), **KW) for n in (17, 11))
    with torch.no_grad():
        np.testing.assert_allclose(ref_oak.oak_gram(X, X2, ls, sig2), k.K(X, X2), rtol=1e-11,
                                   atol=1e-11)
        np.testing.assert_allclose(ref_oak.oak_diag(X, ls, sig2), k.K_diag(X), rtol=1e-11,
                                   atol=1e-11)


def _named_grads(model, loss):
    from oak_tpu_torch.params import flatten_trainable
    from oak_tpu_torch.optim.fit import value_and_grad

    vec = flatten_trainable(model).detach()
    v, g = value_and_grad(model, loss, vec)
    return float(v), svgp_kind.leaves(model, g)


def test_svgp_loss_and_gradient():
    inp = svgp_kind.inputs(CFG, 5)
    model = svgp_kind.build(CFG, inp, torch.device("cpu"))
    X = torch.as_tensor(inp["X"], **KW)
    Y = torch.as_tensor(inp["Y"], **KW)
    value, grads = _named_grads(model, lambda m: m.training_loss(X, Y[:, None]))
    leaves = ref_svgp.initial_leaves(CFG, CFG["num_inducing"])
    ref_v, ref_g = ref_oak.value_and_grad(
        lambda lv: ref_svgp.loss(CFG, X, Y, torch.as_tensor(inp["Z"], **KW), lv), leaves)
    assert abs(value - float(ref_v)) <= 1e-10 * abs(float(ref_v))
    ref_g = svgp_kind.split(ref_g)
    assert set(ref_g) == set(grads)
    for k in ref_g:
        np.testing.assert_allclose(grads[k], ref_g[k], rtol=1e-8, atol=1e-10)


def _sgpr(seed, D=3, N=1200, M=20, depth=3):
    from oak_tpu_torch import SGPR

    k, ls, sig2 = _kernel(D, depth, seed)
    gen = np.random.default_rng(seed)
    X, y = gen.normal(size=(N, D)), gen.normal(size=N)
    Z = X[:M]
    model = SGPR.create(X, y[:, None], k, Z, noise_variance=0.05, **KW)
    t = lambda a: torch.as_tensor(a, **KW)  # noqa: E731
    return model, t(X), t(y), t(Z), ls, sig2


def _raw_leaves(ls, sig2, noise):
    return {"lengthscale": torch.logit((ls - 1e-3) / (1e3 - 1e-3)),
            "variance": torch.log(torch.expm1(sig2)),
            "noise": torch.log(torch.expm1(torch.as_tensor(noise - 1e-6, **KW)))}


def test_sgpr_loss_and_gradient():
    from benchmark.models import sgpr_oak

    model, X, y, Z, ls, sig2 = _sgpr(3)
    value, grads = _named_grads(model, lambda m: m.training_loss())
    cfg = dict(CFG, num_dims=3, max_interaction_depth=3)
    ref_v, ref_g = ref_oak.value_and_grad(lambda lv: ref_sgpr.loss(cfg, X, y, Z, lv),
                                          _raw_leaves(ls, sig2, 0.05))
    assert abs(value - float(ref_v)) <= 1e-10 * abs(float(ref_v))
    ref_g = sgpr_oak.split(ref_g)
    for k in ref_g:
        np.testing.assert_allclose(grads[k], ref_g[k], rtol=1e-7, atol=1e-9)


def test_flows_transform_and_objective():
    from oak_tpu_torch.flows import fit_normalizers

    X, _ = data.synth_pumadyn(600, 3, data.rng(2, 0))
    X = X.astype(np.float64)
    flows = fit_normalizers(X, max_iters=15, **KW)
    p = {k: torch.stack([getattr(f, k).value.detach() for f in flows])
         for k in ("skewness", "tailweight", "scale", "shift")}
    p["offset"] = torch.stack([f.offset for f in flows])
    x = torch.as_tensor(X, **KW)
    with torch.no_grad():
        prog = torch.stack([f.forward(x[:, i]) for i, f in enumerate(flows)], 1)
        np.testing.assert_allclose(ref_flows.transform(x, p), prog, rtol=1e-12, atol=1e-12)
        raw = {"skewness": p["skewness"], "log_tailweight": torch.log(p["tailweight"]),
               "log_scale": torch.log(p["scale"]), "shift": p["shift"]}
        obj = sum(float(f.kl_objective(x[:, i])) for i, f in enumerate(flows))
        assert abs(float(ref_flows.objective(x, raw, p["offset"])) - obj) <= 1e-10 * abs(obj)
        init = ref_flows.initial_raw(x)
        start = [f for f in fit_normalizers(X, max_iters=0, **KW)]
        np.testing.assert_allclose(init["shift"], [float(f.shift.value) for f in start],
                                   rtol=1e-12)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -3.0 - 2.0 ** -10, 0.0])
    out = ref_oak.to_tf32(x)
    assert out.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, -3.0 - 2.0 ** -9, 0.0]
    y = torch.randn(1000)
    rel = ((ref_oak.to_tf32(y) - y).abs() / y.abs()).max()
    assert 0 < rel <= 2.0 ** -11
