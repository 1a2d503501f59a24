"""The CUDA kernels csrc/oak_gram_fwd.cu and csrc/oak_gram_bwd.cu against
their plain torch versions, on the card, at the shapes chip_smoke.py drives,
and the Sobol layer in float32 on the card against float64 on the CPU.
Marked ``gpu``; each test asks the ``cuda`` fixture, which skips when no
card is present. This file imports no JAX, so on a machine with a card and
no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from oak_tpu_torch import sobol as sb
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SVGP, Gaussian
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.testing import (KERNEL_CASES, SQUARE_CASE, kernel_error, prescaled_inputs,
                                   square_inputs)

pytestmark = pytest.mark.gpu

# the Pallas gate's bounds on the forward and on the gradient, relative to
# max |plain| (bench.py:1326-1327); past them, kernel_error's drift rule
# against float64 (deep Newton–Girard in the f32 plain version)
TOL = 1e-4
GRAD_TOL = 1e-3
NAMES = ("du1", "du2", "dc1", "dc2", "dextra", "dlogb", "dsig2")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the predict path's Kus and Kuu at the bench width, then the shared cases
CASES = [("Kus 512x8192", 32, 512, 8192, 0, 3),
         ("Kuu 512x512", 32, 512, 512, 0, 3)] + KERNEL_CASES


@pytest.mark.parametrize("name,D,N,M,E,depth", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, D, N, M, E, depth):
    args = prescaled_inputs(61, D, N, M, E, depth, cuda)
    before = og.LAUNCHES
    out = og.oak_gram_fused(*args, depth)
    torch.cuda.synchronize()
    assert og.LAUNCHES == before + 1
    ref = og.oak_gram_plain(*args, depth)
    ref64 = og.oak_gram_plain(*[a.double() for a in args], depth)
    assert out.shape == (N, M) and torch.isfinite(out).all()
    ok, _, text = kernel_error(out, ref, ref64, TOL)
    assert ok, text


@pytest.mark.parametrize("name,D,N,M,E,depth", CASES, ids=[c[0] for c in CASES])
def test_bwd_kernel_matches_plain(cuda, name, D, N, M, E, depth):
    """Every cotangent of the backward kernel against autograd of the plain
    gram and against the written-out plain backward, for a seeded gbar; a
    second launch gives the same bits (no atomics)."""
    args = prescaled_inputs(65, D, N, M, E, depth, cuda)
    gbar = torch.as_tensor(np.random.default_rng(66).normal(size=(N, M)),
                           dtype=torch.float32, device=cuda)
    before = og.BWD_LAUNCHES
    ours = og.oak_gram_bwd(*args, gbar, depth)
    again = og.oak_gram_bwd(*args, gbar, depth)
    torch.cuda.synchronize()
    assert og.BWD_LAUNCHES == before + 2
    assert all(torch.equal(o, a) for o, a in zip(ours, again))
    leaves = [a.clone().requires_grad_(True) for a in args]
    auto = torch.autograd.grad(og.oak_gram_plain(*leaves, depth), leaves, gbar,
                               allow_unused=True, materialize_grads=True)
    plain = og.oak_gram_bwd_plain(*args, gbar, depth)
    plain64 = og.oak_gram_bwd_plain(*[a.double() for a in args], gbar.double(), depth)
    for n, o, a, p, p64 in zip(NAMES, ours, auto, plain, plain64):
        assert o.shape == a.shape and torch.isfinite(o).all(), n
        if a.numel():
            for ref in (a, p):
                ok, _, text = kernel_error(o, ref, p64, GRAD_TOL)
                assert ok, (n, text)


def test_kernel_refuses_what_it_cannot_run(cuda):
    args = prescaled_inputs(62, 4, 16, 8, 0, 3, cuda)
    # inputs that require grad are taken now, through the backward kernel
    leaves = [a.clone().requires_grad_(True) for a in args]
    torch.autograd.grad(og.oak_gram_fused(*leaves, 3).sum(), leaves[:4])
    with pytest.raises(TypeError, match="float32"):
        og.oak_gram_fused(*[a.double() for a in args], 3)
    # depth clamps to the number of grams; past 64 grams and depth 64, no variant
    og.oak_gram_fused(*args[:6], torch.ones(10, device=cuda), 9)
    with pytest.raises(ValueError, match="<= 64"):
        og.oak_gram_fused(*prescaled_inputs(62, 65, 16, 8, 0, 65, cuda), 65)
    with pytest.raises(ValueError, match="contiguous"):
        og.oak_gram_fused(args[0].t().contiguous().t(), *args[1:], 3)
    with pytest.raises(ValueError, match="cpu"):
        og.oak_gram_fused(args[0].cpu(), *args[1:], 3)
    with pytest.raises(ValueError, match="shape"):
        og.oak_gram_fused(args[0], args[1], args[2][:, :-1].contiguous(), *args[3:], 3)


def test_oak_kernel_K_routes_through_kernel(cuda):
    """float32 CUDA input takes the kernel; float64 on the same card takes
    the per-dim route, and the two agree."""
    k = OAKKernel.create(num_dims=6, max_interaction_depth=3, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(63).normal(size=(300, 6)),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        before = og.LAUNCHES
        K = k.K(X[:100], X)
        torch.cuda.synchronize()
        assert og.LAUNCHES == before + 1
        K64 = k.double().K(X[:100].double(), X.double())
        assert og.LAUNCHES == before + 1
    err = float((K.double() - K64).abs().max() / K64.abs().max())
    assert err < TOL, err


def test_oak_kernel_K_deeper_than_8_runs_the_kernel(cuda):
    """Depth 9 over 10 dims qualifies for the fused route, as in oak_tpu, and
    the kernel runs it (once it raised): one K1 launch, within TOL of the
    float64 per-dim route on the same card."""
    k = OAKKernel.create(num_dims=10, max_interaction_depth=9, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(64).normal(size=(200, 10)),
                        dtype=torch.float32, device=cuda)
    assert og.supports_fused(k)
    with torch.no_grad():
        before = og.LAUNCHES
        K = k.K(X[:50], X)
        torch.cuda.synchronize()
        assert og.LAUNCHES == before + 1
        K64 = k.double().K(X[:50].double(), X.double())
    err = float((K.double() - K64).abs().max() / K64.abs().max())
    assert err < TOL, err


def test_defaults_build_on_the_card_in_float32(cuda):
    """OAKKernel.create with no dtype or device holds float32 CUDA
    parameters, as oak_tpu builds in float32 on its chip, and K launches K1."""
    k = OAKKernel.create(num_dims=32, max_interaction_depth=3)
    assert {(p.dtype, p.device.type) for p in k.parameters()} == {(torch.float32, "cuda")}
    X = torch.as_tensor(np.random.default_rng(72).normal(size=(64, 32)),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        before = og.LAUNCHES
        K = k.K(X)
        torch.cuda.synchronize()
    assert og.LAUNCHES == before + 1 and torch.isfinite(K).all()


def test_oak_kernel_K_gradient_through_kernels(cuda):
    """torch.autograd.grad of a float32 CUDA OAK gram goes through both
    kernels and agrees with the float64 per-dim route on the same card, for
    a mixed model (one binary dim, whose extra gram carries its trainable
    base variance's gradient) and X that requires grad."""
    k = OAKKernel.create(num_dims=6, max_interaction_depth=3, p0=[0.4] + [None] * 5,
                         share_var_across_orders=False, dtype=torch.float32,
                         device=cuda)
    rng = np.random.default_rng(67)
    X = rng.normal(size=(300, 6))
    X[:, 0] = rng.integers(0, 2, 300)
    G = torch.as_tensor(rng.normal(size=(100, 300)), device=cuda)

    def grads(kern, dtype):
        Xt = torch.as_tensor(X, dtype=dtype, device=cuda).requires_grad_(True)
        K = kern.K(Xt[:100], Xt)
        raws = [p for p in kern.parameters() if p.requires_grad]
        return K, torch.autograd.grad((K * G.to(dtype)).sum(), [Xt] + raws)

    before, bwd_before = og.LAUNCHES, og.BWD_LAUNCHES
    K, g32 = grads(k, torch.float32)
    torch.cuda.synchronize()
    assert og.LAUNCHES == before + 1 and og.BWD_LAUNCHES == bwd_before + 1
    K64, g64 = grads(k.double(), torch.float64)
    assert og.LAUNCHES == before + 1 and og.BWD_LAUNCHES == bwd_before + 1
    for a, b in zip((K,) + g32, (K64,) + g64):
        a, b = a.detach().double(), b.detach()
        err = float((a - b).abs().max() / b.abs().max())
        assert err < GRAD_TOL, err


def test_square_gram_kernels_match_plain(cuda):
    """K1 and K2 at the exact GP's square gram (X2 = None, u2 = u1): the
    forward is exactly symmetric and within TOL of plain, every cotangent
    within GRAD_TOL of autograd of the plain gram."""
    _, D, N, depth = SQUARE_CASE
    args = square_inputs(68, D, N, depth, cuda)
    out = og.oak_gram_fused(*args, depth)
    ref = og.oak_gram_plain(*args, depth)
    assert torch.equal(out, out.T)
    assert float((out - ref).abs().max() / ref.abs().max()) < TOL
    del out, ref
    gbar = torch.as_tensor(np.random.default_rng(69).normal(size=(N, N)),
                           dtype=torch.float32, device=cuda)
    before = og.BWD_LAUNCHES
    ours = og.oak_gram_bwd(*args, gbar, depth)
    torch.cuda.synchronize()
    assert og.BWD_LAUNCHES == before + 1
    leaves = [a.clone().requires_grad_(True) for a in args]
    auto = torch.autograd.grad(og.oak_gram_plain(*leaves, depth), leaves, gbar,
                               allow_unused=True, materialize_grads=True)
    for n, o, a in zip(NAMES, ours, auto):
        if a.numel():
            err = float((o - a).abs().max() / a.abs().max())
            assert err < GRAD_TOL, (n, err)


def test_oak_kernel_square_K_through_kernel(cuda):
    """K(X) with X2 = None launches K1 once, is exactly symmetric and
    agrees with the float64 per-dim route."""
    k = OAKKernel.create(num_dims=8, max_interaction_depth=2, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(70).normal(size=(1000, 8)),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        before = og.LAUNCHES
        K = k.K(X)
        torch.cuda.synchronize()
        assert og.LAUNCHES == before + 1
        K64 = k.double().K(X.double())
    assert torch.equal(K, K.T)
    err = float((K.double() - K64).abs().max() / K64.abs().max())
    assert err < TOL, err


def test_sobol_f32_on_card_matches_f64_cpu(cuda):
    """A small SVGP with seeded parameters: every component's normalised
    Sobol value in float32 on the card (K1 for Kuu) within 1e-3 of float64
    on the CPU; the per-component predictions sum to the mean."""
    rng = np.random.default_rng(71)
    X = rng.normal(size=(256, 6))
    kernel = OAKKernel.create(num_dims=6, max_interaction_depth=3, dtype=torch.float32,
                              device=cuda)
    m = SVGP.create(kernel, Gaussian.create(0.01, dtype=torch.float32, device=cuda),
                    X[:64], dtype=torch.float32, device=cuda)
    for kk in m.kernel.kernels:
        kk.lengthscale.assign(rng.uniform(1.0, 3.0))
    m.q_mu.assign(rng.normal(size=(64, 1)))
    before = og.LAUNCHES
    tuples, v32 = sb.compute_sobol_oak(m)
    assert og.LAUNCHES > before and len(tuples) == 41
    Xs = torch.as_tensor(X[:128], dtype=torch.float32, device=cuda)
    comps = sb.get_prediction_component(m, X=Xs)
    with torch.no_grad():
        const = float(m.posterior_alpha()[:, 0].sum() * m.kernel.variances[0].value)
        mean = m.predict_f(Xs)[0][:, 0].cpu().numpy()
    assert np.abs(comps.sum(0) + const - mean).max() < 1e-3 * np.abs(mean).max()
    _, v64 = sb.compute_sobol_oak(m.to(device="cpu", dtype=torch.float64))
    err = np.abs(sb.normalize_sobol(v32) - sb.normalize_sobol(v64)).max()
    assert err < 1e-3, err


def _oak_data(n=300, seed=73):
    """Skewed positive columns (the flows fit on the card) and a smooth
    target with one interaction."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.lognormal(0.0, 0.5, n), rng.normal(size=n), rng.gamma(3.0, 1.0, n)], 1)
    y = np.sin(X[:, 1]) + 0.3 * np.log(X[:, 0]) * X[:, 2] + 0.1 * rng.normal(size=n)
    return X, y


@pytest.fixture(scope="module")
def oak_on_card():
    """A default-built oak_model (float32 on the card) after fit(optimise=
    False) and 40 L-BFGS iterations: (model, X, y, loss at the start, fit
    result, K1 and K2 launches of the fit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from oak_tpu_torch import oak_model

    X, y = _oak_data()
    before = (og.LAUNCHES, og.BWD_LAUNCHES)
    oak = oak_model(max_interaction_depth=2).fit(X, y, optimise=False)
    with torch.no_grad():
        start = float(oak.m.training_loss())
    res = oak.optimise(max_iters=40)
    torch.cuda.synchronize()
    launches = (og.LAUNCHES - before[0], og.BWD_LAUNCHES - before[1])
    return oak, X, y, start, res, launches


def test_oak_model_fits_on_the_card_through_both_kernels(cuda, oak_on_card):
    """The default build is float32 on the card; its flows, L-BFGS and
    predictions run there, and the fit launched K1 and K2."""
    oak, X, _, start, res, launches = oak_on_card
    assert {(p.dtype, p.device.type) for p in oak.m.parameters()} == \
        {(torch.float32, "cuda")}
    assert launches[0] > 0 and launches[1] > 0
    assert np.isfinite(res.fun) and res.fun < start
    pred = oak.predict(X[:50])
    assert pred.shape == (50,) and np.isfinite(pred).all()


def test_load_oak_model_round_trips_on_the_card(cuda, oak_on_card, tmp_path):
    """A float32 save loads back on the card to bitwise-equal predictions;
    a float64 load on the card agrees within 1e-3 (predictions, NLL,
    normalised Sobol)."""
    from oak_tpu_torch import load_oak_model

    oak, X, y, _, _, _ = oak_on_card
    pred = oak.predict(X[:50])
    path = tmp_path / "oak_f32.npz"
    oak.save(path)
    again = load_oak_model(path)
    assert {(p.dtype, p.device.type) for p in again.m.parameters()} == \
        {(torch.float32, "cuda")}
    assert np.array_equal(again.predict(X[:50]), pred)
    oak64 = load_oak_model(path, dtype=torch.float64)
    assert {(p.dtype, p.device.type) for p in oak64.m.parameters()} == \
        {(torch.float64, "cuda")}
    assert np.abs(oak64.predict(X[:50]) - pred).max() < 1e-3 * np.abs(pred).max()
    assert abs(oak64.get_loglik(X[:50], y[:50]) - oak.get_loglik(X[:50], y[:50])) < 1e-3
    assert np.abs(oak64.get_sobol() - oak.get_sobol()).max() < 1e-3


def test_fit_lbfgs_on_the_card_reaches_the_cpu_f64_loss(cuda):
    """The port's L-BFGS on a float32 GPR on the card (K1 and K2 in every
    evaluation) ends within 1e-3 relative of the loss it reaches in float64
    on the CPU from the same start."""
    from oak_tpu_torch.models import GPR
    from oak_tpu_torch.optim import fit_lbfgs

    X, y = _oak_data(seed=74)
    Xs = (X - X.mean(0)) / X.std(0)
    fits = {}
    for dtype, device in ((torch.float32, cuda), (torch.float64, torch.device("cpu"))):
        k = OAKKernel.create(num_dims=3, max_interaction_depth=2, dtype=dtype, device=device)
        m = GPR.create(Xs, (y - y.mean()) / y.std(), k, noise_variance=0.05)
        fits[dtype] = fit_lbfgs(m, lambda m: m.training_loss(), max_iters=200)
    f32, f64 = fits[torch.float32].fun, fits[torch.float64].fun
    assert np.isfinite(f32) and abs(f32 - f64) < 1e-3 * abs(f64), (f32, f64)
