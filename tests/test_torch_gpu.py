"""The CUDA kernels csrc/oak_gram_fwd.cu and csrc/oak_gram_bwd.cu and the
Triton K1 (ops/oak_gram_triton.py) against their plain torch versions, on
the card, at the shapes chip_smoke.py drives, the compiled serving artifact,
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
from oak_tpu_torch.ops import oak_gram_triton as ogt
from oak_tpu_torch.testing import (KERNEL_CASES, SQUARE_CASE, counted, kernel_error,
                                   prescaled_inputs, square_inputs)
from oak_tpu_torch.utils import profiling

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
    with profiling.recording():
        out = og.oak_gram_fused(*args, depth)
        torch.cuda.synchronize()
    assert counted("k1.launches") == 1
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
    with profiling.recording():
        ours = og.oak_gram_bwd(*args, gbar, depth)
        again = og.oak_gram_bwd(*args, gbar, depth)
        torch.cuda.synchronize()
    assert counted("k2.launches") == 2
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
    the plain route, and the two agree."""
    k = OAKKernel.create(num_dims=6, max_interaction_depth=3, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(63).normal(size=(300, 6)),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad(), profiling.recording():
        K = k.K(X[:100], X)
        torch.cuda.synchronize()
        assert counted("k1.launches") == 1
        K64 = k.double().K(X[:100].double(), X.double())
        assert counted("k1.launches") == 1
    err = float((K.double() - K64).abs().max() / K64.abs().max())
    assert err < TOL, err


def test_oak_kernel_K_deeper_than_8_runs_the_kernel(cuda):
    """Depth 9 over 10 dims qualifies for the fused route, as in oak_tpu, and
    the kernel runs it (once it raised): one K1 launch, within TOL of the
    float64 plain route on the same card."""
    k = OAKKernel.create(num_dims=10, max_interaction_depth=9, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(64).normal(size=(200, 10)),
                        dtype=torch.float32, device=cuda)
    assert og.supports_fused(k)
    with torch.no_grad(), profiling.recording():
        K = k.K(X[:50], X)
        torch.cuda.synchronize()
        assert counted("k1.launches") == 1
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
    with torch.no_grad(), profiling.recording():
        K = k.K(X)
        torch.cuda.synchronize()
    assert counted("k1.launches") == 1 and torch.isfinite(K).all()


def test_oak_kernel_K_gradient_through_kernels(cuda):
    """torch.autograd.grad of a float32 CUDA OAK gram goes through both
    kernels and agrees with the float64 plain route on the same card, for
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

    with profiling.recording():
        K, g32 = grads(k, torch.float32)
        torch.cuda.synchronize()
        assert counted("k1.launches") == 1 and counted("k2.launches") == 1
        K64, g64 = grads(k.double(), torch.float64)
    assert counted("k1.launches") == 1 and counted("k2.launches") == 1
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
    with profiling.recording():
        ours = og.oak_gram_bwd(*args, gbar, depth)
        torch.cuda.synchronize()
    assert counted("k2.launches") == 1
    leaves = [a.clone().requires_grad_(True) for a in args]
    auto = torch.autograd.grad(og.oak_gram_plain(*leaves, depth), leaves, gbar,
                               allow_unused=True, materialize_grads=True)
    for n, o, a in zip(NAMES, ours, auto):
        if a.numel():
            err = float((o - a).abs().max() / a.abs().max())
            assert err < GRAD_TOL, (n, err)


def test_oak_kernel_square_K_through_kernel(cuda):
    """K(X) with X2 = None launches K1 once, is exactly symmetric and
    agrees with the float64 plain route."""
    k = OAKKernel.create(num_dims=8, max_interaction_depth=2, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(70).normal(size=(1000, 8)),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad(), profiling.recording():
        K = k.K(X)
        torch.cuda.synchronize()
        assert counted("k1.launches") == 1
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
    with profiling.recording():
        tuples, v32 = sb.compute_sobol_oak(m)
    assert counted("k1.launches") > 0 and len(tuples) == 41
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
    with profiling.recording():
        oak = oak_model(max_interaction_depth=2).fit(X, y, optimise=False)
        with torch.no_grad():
            start = float(oak.m.training_loss())
        res = oak.optimise(max_iters=40)
        torch.cuda.synchronize()
    launches = (counted("k1.launches"), counted("k2.launches"))
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


def _package_request(f, X):
    """f(X) under torch.profiler: (its output, launches of the Triton K1 and
    of the CUDA K1, by kernel name). A window that records no kernel (the
    profiler can lose them) runs f again, up to five times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = f(X)
            torch.cuda.synchronize()
        names = {e.key: e.count for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.count}
        if any(not k.startswith(("Memcpy", "Memset")) for k in names):
            break
    return (out, sum(c for k, c in names.items() if ogt.KERNEL_NAME in k),
            sum(c for k, c in names.items() if "oak_gram_fwd_kernel" in k))


def _card_program(blob):
    """The traced program a card artifact holds (its PROGRAM record), run
    on the card: its gram is the registered op, the CUDA K1."""
    import io

    from oak_tpu_torch import serving

    module = torch.export.load(io.BytesIO(serving._program(blob))).module()
    return lambda X: module(torch.as_tensor(X, dtype=torch.float32, device="cuda"))


def test_exported_predict_on_the_card_matches_live_and_launches_k1(cuda, tmp_path):
    """A small default-built oak_model (float32 on the card) serialized with
    serving.serialize_predict and loaded back. The traced program the blob
    holds, run on the card: every batch size, 1 row included, equals the
    live predict within 1e-5 of max |live| (the same float32 arithmetic,
    the scalers in float32 here and float64 in the live path), each call
    launches K1 once, and the (mean, std) program's mean equals the
    mean-only one. The compiled package deserialize_predict serves: within
    1e-4 of max |live| (chip_smoke.py's served gate: Inductor's fused
    float32 arithmetic is not eager's), each call launching the package's
    Triton K1 once and the CUDA K1 not at all. The card's artifact moved to
    the CPU runs its traced program with the op's plain version, and an
    artifact traced on the CPU the plain route; both launch nothing and
    agree within 1e-3."""
    from oak_tpu_torch import deserialize_predict, oak_model, serialize_predict

    X, y = _oak_data(n=200, seed=75)
    oak = oak_model(max_interaction_depth=2).fit(X, y, optimise=False)
    oak.optimise(max_iters=10)
    blob = serialize_predict(oak, tmp_path / "predict.pt2")
    blob_v = serialize_predict(oak, include_var=True)
    f, fv = deserialize_predict(tmp_path / "predict.pt2"), deserialize_predict(blob_v)
    program, program_v = _card_program(blob), _card_program(blob_v)
    live = oak.predict(X, clip=True)
    for rows in (1, 2, 37, 200):
        with profiling.recording():
            traced = program(X[:rows])
            torch.cuda.synchronize()
        assert counted("k1.launches") == 1, rows
        err = np.abs(traced.cpu().numpy() - live[:rows]).max() / np.abs(live).max()
        assert err < 1e-5, (rows, err)
        with profiling.recording():
            served, triton, cuda_k1 = _package_request(f, X[:rows])
        assert counted("k1.launches") == 0 and (triton, cuda_k1) == (1, 0), rows
        assert served.is_cuda and served.shape == (rows,)
        err = np.abs(served.cpu().numpy() - live[:rows]).max() / np.abs(live).max()
        assert err < 1e-4, (rows, err)
    assert torch.equal(program_v(X)[0], program(X))
    mean, std = fv(X)
    assert bool((std > 0).all())
    assert np.abs(mean.cpu().numpy() - live).max() < 1e-4 * np.abs(live).max()
    # the CPU copy runs the plain gram and LAPACK in float32: the card's
    # float32 against the CPU's, under phase 3's end-to-end bound of
    # chip_smoke.py (1e-3 of max |live|)
    for cpu in (deserialize_predict(tmp_path / "predict.pt2", device="cpu"),
                deserialize_predict(serialize_predict(oak, device="cpu"))):
        with profiling.recording():
            on_cpu = cpu(X).numpy()
        assert counted("k1.launches") == 0
        assert np.abs(on_cpu - live).max() < 1e-3 * np.abs(live).max()


def test_cpu_model_serialized_for_the_card_traces_k1(cuda):
    """A float32 model on the CPU serialized with device="cuda" is traced on
    the card from a moved copy: its traced program holds the registered
    op, each served call of its package launches the Triton K1 once (and
    the CUDA K1 not at all), and it agrees with the CPU's live predict
    within 1e-3 (phase 3's end-to-end bound of chip_smoke.py)."""
    import io

    from oak_tpu_torch import deserialize_predict, oak_model, serialize_predict, serving

    X, y = _oak_data(n=200, seed=77)
    oak = oak_model(max_interaction_depth=2, dtype=torch.float32, device="cpu")
    oak.fit(X, y, optimise=False)
    blob = serialize_predict(oak, device="cuda")
    ep = torch.export.load(io.BytesIO(serving._program(blob)))
    assert torch.ops.oak_tpu_torch.oak_gram_fwd.default in {n.target for n in ep.graph.nodes}
    f = deserialize_predict(blob)
    with profiling.recording():
        served, triton, cuda_k1 = _package_request(f, X)
    assert served.is_cuda and counted("k1.launches") == 0 and (triton, cuda_k1) == (1, 0)
    live = oak.predict(X, clip=True)
    assert np.abs(served.cpu().numpy() - live).max() < 1e-3 * np.abs(live).max()


def test_card_artifact_serves_in_a_process_without_the_port(cuda, tmp_path):
    """A card artifact's package loaded with torch._inductor.aoti_load_package
    alone, in a python -I process started from an empty directory, which
    first shows that it cannot import oak_tpu_torch: it serves what
    deserialize_predict serves here, bitwise."""
    import subprocess
    import sys

    from oak_tpu_torch import deserialize_predict, oak_model, serialize_predict

    X, y = _oak_data(n=200, seed=78)
    oak = oak_model(max_interaction_depth=2).fit(X, y, optimise=False)
    (tmp_path / "predict.pt2").write_bytes(serialize_predict(oak, include_var=True))
    np.save(tmp_path / "x.npy", X.astype(np.float32))
    (tmp_path / "empty").mkdir()
    code = """
try:
    import oak_tpu_torch
except ImportError:
    pass
else:
    raise SystemExit("oak_tpu_torch is importable")
import numpy, torch
f = torch._inductor.aoti_load_package("../predict.pt2")
mean, std = f(torch.as_tensor(numpy.load("../x.npy"), device="cuda"))
numpy.save("../mean.npy", mean.cpu().numpy())
numpy.save("../std.npy", std.cpu().numpy())
"""
    run = subprocess.run([sys.executable, "-I", "-c", code], cwd=tmp_path / "empty",
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    mean, std = deserialize_predict(tmp_path / "predict.pt2")(X)
    assert np.array_equal(np.load(tmp_path / "mean.npy"), mean.cpu().numpy())
    assert np.array_equal(np.load(tmp_path / "std.npy"), std.cpu().numpy())


# (name, D, N, M, E, depth): depths 1, 3, 8, 16, 32 and 64, with 0 or 8 extra
# grams, a 1-row and a ragged batch, and a non-batch axis of 9000 rows
TRITON_CASES = [("Kus 512x8192 P=3", 32, 512, 8192, 0, 3),
                ("1 row P=1", 8, 500, 1, 0, 1),
                ("ragged 1000x77 E=8 P=8", 8, 1000, 77, 8, 8),
                ("1 row E=8 P=4", 5, 200, 1, 8, 4),
                ("ragged 300x37 P=16", 32, 300, 37, 0, 16),
                ("ragged 1000x77 P=32", 32, 1000, 77, 0, 32),
                ("D=60 E=8 300x200 P=64", 60, 300, 200, 8, 64),
                ("9000x37 P=3", 32, 9000, 37, 0, 3),
                ("9000x1 E=8 P=8", 8, 9000, 1, 8, 8)]


@pytest.mark.parametrize("name,D,N,M,E,depth", TRITON_CASES, ids=[c[0] for c in TRITON_CASES])
def test_triton_kernel_matches_plain(cuda, name, D, N, M, E, depth):
    """The Triton K1 (the compiled artifact's gram) against the plain
    version under the kernels' rule, and bitwise equal to the CUDA K1."""
    args = prescaled_inputs(62, D, N, M, E, depth, cuda)
    with profiling.recording():
        out = ogt.oak_gram_triton_op(*args, depth)
        torch.cuda.synchronize()
    assert counted("k1_triton.launches") == 1
    ref = og.oak_gram_plain(*args, depth)
    ref64 = og.oak_gram_plain(*[a.double() for a in args], depth)
    assert out.shape == (N, M) and torch.isfinite(out).all()
    ok, _, text = kernel_error(out, ref, ref64, TOL)
    assert ok, text
    assert torch.equal(out, og.oak_gram_fused(*args, depth))


def test_registered_forward_op_passes_opcheck_on_the_card(cuda):
    """torch.library.opcheck of oak_tpu_torch::oak_gram_fwd on CUDA tensors:
    the schema, the fake against the kernel, and AOT dispatch with dynamic
    shapes."""
    args = prescaled_inputs(76, 6, 40, 24, 1, 3, cuda)
    torch.library.opcheck(og.oak_gram_fwd_op, (*args, 3))


def test_checked_reaches_the_cuda_backward_and_passes_both_kernels(cuda):
    """utils.checked on the card: an inf made in a backward, which autograd
    runs on a worker thread for CUDA tensors, raises; a clean forward and
    backward through K1 and K2 passes, both launched inside."""
    from oak_tpu_torch.utils import checked

    x = torch.tensor([4.0, 0.0], device=cuda, requires_grad=True)
    with pytest.raises(FloatingPointError):
        checked(lambda: torch.autograd.grad(torch.sqrt(x).sum(), x))()
    args = [t.requires_grad_(True) for t in prescaled_inputs(75, 6, 40, 24, 1, 3, cuda)]

    def gram_and_grads():
        g = og.oak_gram_fused(*args, 3)
        return g, torch.autograd.grad(g.sum(), args)

    with profiling.recording():
        out, grads = checked(gram_and_grads)()
        torch.cuda.synchronize()
    assert counted("k1.launches") > 0 and counted("k2.launches") > 0
    assert bool(torch.isfinite(out).all()) and all(bool(torch.isfinite(g).all()) for g in grads)


DP_RANK = """
import sys
import numpy as np, torch, torch.distributed as dist
rank, folder = int(sys.argv[1]), sys.argv[2]
sys.path.insert(0, sys.argv[3])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{folder}/store", rank=rank, world_size=2)
from oak_tpu_torch.optim.fit import value_and_grad
from oak_tpu_torch.parallel import data_parallel_elbo_step, make_mesh, shard_batch
from oak_tpu_torch.parallel.mesh import Axis
from oak_tpu_torch.parallel.sharding import mesh_loss
from oak_tpu_torch.params import flatten_trainable
with np.load(f"{folder}/data.npz") as f:
    X, Y, Z = (torch.as_tensor(f[k], device="cuda") for k in ("X", "Y", "Z"))
sys.path.insert(0, sys.argv[4])
from test_torch_gpu import _dp_model
model = _dp_model(X, Y, Z)
mesh = make_mesh()
loss, grad = value_and_grad(model, mesh_loss(model, Axis.of(mesh, "data"), X, Y),
                            flatten_trainable(model).detach())
step, (vec, opt_state, _) = data_parallel_elbo_step(model, mesh)
vec1, _, step_loss = step(vec, opt_state, *shard_batch(mesh, X, Y))
np.savez(f"{folder}/rank{rank}.npz", loss=loss.cpu().numpy(), grad=grad.cpu().numpy(),
         step_loss=step_loss.cpu().numpy(), vec1=vec1.cpu().numpy())
dist.destroy_process_group()
"""


def _dp_model(X, Y, Z):
    """A float32 SVGP on the card with seeded parameters (q_mu N(0, 1))."""
    model = SVGP.create(OAKKernel.create(num_dims=X.shape[1], max_interaction_depth=2,
                                         use_sparsity_prior=True, dtype=torch.float32,
                                         device=X.device),
                        Gaussian.create(0.05, dtype=torch.float32, device=X.device), Z,
                        num_data=X.shape[0])
    model.q_mu.assign(np.random.default_rng(3).normal(size=(Z.shape[0], 1)))
    return model


def test_data_parallel_step_on_two_gloo_ranks_matches_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card: the sharded loss and gradient (K1
    and K2 at the shard's Kuf) and one data-parallel Adam step against one
    process, the loss within 1e-5 relative and the gradient within 1e-4 of
    max |g|; the ranks are killed if either fails or runs past 300 s."""
    import os
    import subprocess
    import sys
    import time
    from pathlib import Path

    from oak_tpu_torch.optim.fit import value_and_grad
    from oak_tpu_torch.params import flatten_trainable

    rng = np.random.default_rng(5)
    X = rng.normal(size=(2048, 8)).astype(np.float32)
    Y = (np.sin(X[:, :1]) + 0.1 * rng.normal(size=(2048, 1))).astype(np.float32)
    np.savez(tmp_path / "data.npz", X=X, Y=Y, Z=X[:64])
    here = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, "-c", DP_RANK, str(r), str(tmp_path),
                               str(here.parent), str(here)],
                              env=dict(os.environ, LOCAL_RANK="0"),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    deadline = time.monotonic() + 300
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    logs = [p.communicate()[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    Xc, Yc = torch.as_tensor(X, device=cuda), torch.as_tensor(Y, device=cuda)
    model = _dp_model(Xc, Yc, Xc[:64])
    loss, grad = value_and_grad(model, lambda m: m.training_loss(Xc, Yc),
                                flatten_trainable(model).detach())
    g = grad.double().cpu().numpy()
    for r in range(2):
        with np.load(tmp_path / f"rank{r}.npz") as f:
            assert abs(float(f["loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
            assert np.abs(f["grad"] - g).max() <= 1e-4 * np.abs(g).max()
            assert abs(float(f["step_loss"]) - float(loss)) <= 1e-5 * abs(float(loss))


def test_grouped_route_matches_the_per_dim_loop_on_the_card(cuda):
    """The grouped evaluation of the per-dim forms in float32 on the card
    (one group of 8 dims and, in a second model, binary and categorical
    dims between RBF-form groups) against chip_smoke.py's per-dim loop:
    _prep, K through the kernels, K_diag, the loss gradient and the Sobol
    values, within TOL (GRAD_TOL for the gradient) of max |per-dim|."""
    import sys
    from pathlib import Path

    from oak_tpu_torch.optim.fit import value_and_grad
    from oak_tpu_torch.params import flatten_trainable

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import _per_dim_route

    rng = np.random.default_rng(71)
    X = rng.normal(size=(1024, 8))
    X[:, 2], X[:, 5] = rng.integers(0, 2, 1024), rng.integers(0, 3, 1024)
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(1024, 1))
    interleaved = dict(p0=[None, None, 0.4] + [None] * 5,
                       p=[None] * 5 + [np.array([0.3, 0.3, 0.4])] + [None] * 2,
                       empirical_locations=[None] * 6 + [np.linspace(-2, 2, 7)] + [None])
    for kw in ({}, interleaved):
        k = OAKKernel.create(num_dims=8, max_interaction_depth=3, use_sparsity_prior=True,
                             lengthscale_bounds=[1e-3, 1e3], dtype=torch.float32,
                             device=cuda, **kw)
        Xc = torch.as_tensor(X, dtype=torch.float32, device=cuda)
        Yc = torch.as_tensor(Y, dtype=torch.float32, device=cuda)
        model = SVGP.create(k, Gaussian.create(0.01, dtype=torch.float32, device=cuda),
                            X[:64], num_data=1024, dtype=torch.float32, device=cuda)

        def outputs():
            Z = model.Z.value.detach()
            with torch.no_grad():
                out = list(og._prep(k, Z, Xc)) + [k.K(Z, Xc), k.K_diag(Xc)]
            out.append(value_and_grad(model, lambda m: m.training_loss(Xc, Yc),
                                      flatten_trainable(model).detach())[1])
            out.append(torch.as_tensor(sb.compute_sobol_oak(model)[1]))
            return out

        grouped = outputs()
        with _per_dim_route():
            per_dim = outputs()
        for i, (a, b) in enumerate(zip(grouped, per_dim)):
            assert a.shape == b.shape
            if b.numel():
                err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                assert err < (GRAD_TOL if i == len(grouped) - 2 else TOL), (i, err)


# (name, D, N, M, E, depth, shared inputs): lanes through one launch of each kernel
LANE_CASES = [("pumadyn Kuf 500x6553", 8, 500, 6553, 0, 8, ()),
              ("mixed E=2 ragged", 30, 300, 77, 2, 3, ()),
              ("shared u2, c2", 32, 512, 700, 0, 3, ("u2", "c2")),
              ("deep P=12", 32, 300, 200, 0, 12, ("sig2",)),
              # K2's 35 tiles of 32 x 32 at P 3 leave a lane's workspace an
              # odd number of floats before its rounding to 4, which keeps
              # lane 1's 8-byte partial stores aligned
              ("D 3, P 3, odd tiles", 3, 20, 1100, 0, 3, ()),
              ("heart Kuf 200x237, E 8", 5, 200, 237, 8, 4, ())]


@pytest.mark.parametrize("name,D,N,M,E,depth,shared", LANE_CASES,
                         ids=[c[0] for c in LANE_CASES])
def test_lane_batched_kernels_match_one_lane_launches(cuda, name, D, N, M, E, depth, shared):
    """K1 and K2 launched once for 4 lanes through the ops' vmap rules: each
    lane bitwise equal to a one-lane launch where the batched launch takes
    the same tile, and within the gates of the plain version either way."""
    from oak_tpu_torch.testing import LANE_NAMES, lane_inputs

    lanes = 4
    inputs = lane_inputs(71, lanes, D, N, M, E, depth, cuda, shared=shared)
    dims = tuple(None if n in shared else 0 for n in LANE_NAMES)
    gbar = torch.as_tensor(np.random.default_rng(72).normal(size=(lanes, N, M)),
                           dtype=torch.float32, device=cuda)
    with profiling.recording():
        out = torch.vmap(og.oak_gram_fwd_op, in_dims=dims + (None,))(*inputs, depth)
        grads = torch.vmap(lambda *a: og.oak_gram_bwd_op(*a, depth, True),
                           in_dims=dims + (0,))(*inputs, gbar)
        torch.cuda.synchronize()
    assert (counted("k1.launches"), counted("k2.launches")) == (1, 1)
    P = og.clamped_depth(depth, D, E)
    same = [og._variant(e, P, N, M, cuda, lanes) == og._variant(e, P, N, M, cuda)
            for e in ("oak_gram_fwd_tile", "oak_gram_bwd_tile")]
    for r in range(lanes):
        lane = [t if d is None else t[r] for t, d in zip(inputs, dims)]
        one = og.oak_gram_fused(*lane, depth)
        one_grads = og.oak_gram_bwd(*lane, gbar[r], depth)
        if same[0]:
            assert torch.equal(out[r], one)
        ok, _, text = kernel_error(out[r], og.oak_gram_plain(*lane, depth),
                                   og.oak_gram_plain(*[t.double() for t in lane], depth), TOL)
        assert ok, text
        plain = og.oak_gram_bwd_plain(*lane, gbar[r], depth)
        plain64 = og.oak_gram_bwd_plain(*[t.double() for t in lane], gbar[r].double(), depth)
        for gname, g, o, p, p64 in zip(NAMES, grads, one_grads, plain, plain64):
            if same[1]:
                assert torch.equal(g[r], o), gname
            if p.numel():
                ok, _, text = kernel_error(g[r], p, p64, GRAD_TOL)
                assert ok, f"{gname}: {text}"


def test_vmapped_gradient_launches_each_kernel_once_per_gram(cuda):
    """The vmapped loss and gradient of 4 lanes of a float32 SVGP on the
    card launch K1 and K2 as often as one lane's, and agree with the lanes
    one by one."""
    from oak_tpu_torch.optim import fit
    from oak_tpu_torch.optim.multistart import _make_starts
    from oak_tpu_torch.params import flatten_trainable

    rng = np.random.default_rng(73)
    X = torch.as_tensor(rng.normal(size=(600, 8)), dtype=torch.float32, device=cuda)
    Y = torch.sin(X[:, :1]) + 0.1 * torch.as_tensor(rng.normal(size=(600, 1)),
                                                    dtype=torch.float32, device=cuda)
    model = SVGP.create(OAKKernel.create(num_dims=8, max_interaction_depth=3,
                                         dtype=torch.float32, device=cuda),
                        Gaussian.create(0.1, dtype=torch.float32, device=cuda), X[:50],
                        num_data=600)
    loss_fn = lambda m: m.training_loss(X, Y)  # noqa: E731
    starts = _make_starts(flatten_trainable(model).detach(), 4, 0.3, 0, True)
    with profiling.recording():
        fit.value_and_grad(model, loss_fn, starts[0])
    one = counted("k1.launches"), counted("k2.launches")
    with profiling.recording():
        values, grads = fit.LaneLoss(model, loss_fn).value_and_grad(starts)
        torch.cuda.synchronize()
    assert (counted("k1.launches"), counted("k2.launches")) == one and 0 not in one
    for r in range(4):
        v, g = fit.value_and_grad(model, loss_fn, starts[r])
        assert abs(float(values[r] - v)) <= 1e-4 * abs(float(v))
        assert float((grads[r] - g).abs().max()) <= GRAD_TOL * float(g.abs().max())


def test_launch_counters_agree_over_a_step(cuda):
    """One SVGP Adam step on the card, recorded (``utils.profiling``): each
    launch site counts its counter once a launch, so the counters read the
    step's launches, ``k1.launches`` and ``k2.launches`` 2 (Kuu and Kuf)
    and ``solve.launches`` 4 (the wide solve forward and transposed, and
    the two transposed solves of Kuu's Cholesky's reverse pass); every span
    of the step is recorded with the step's one evaluation, and K2's spans,
    opened on autograd's device thread, have no parent there and count
    inside the evaluation's self time."""
    from oak_tpu_torch.optim import fit

    rng = np.random.default_rng(71)
    X = torch.as_tensor(rng.normal(size=(600, 6)), dtype=torch.float32, device=cuda)
    Y = torch.sin(X[:, :1])
    k = OAKKernel.create(num_dims=6, max_interaction_depth=3, dtype=torch.float32,
                         device=cuda)
    m = SVGP.create(k, Gaussian.create(0.1, dtype=torch.float32, device=cuda), X[:64],
                    num_data=600)
    vec = fit._leaf(m)
    opt = fit.adam(vec)
    loss_fn = lambda mm: mm.training_loss(X, Y)  # noqa: E731
    fit._adam_step(m, loss_fn, vec, opt)  # warm
    with profiling.recording():
        fit._adam_step(m, loss_fn, vec, opt)
        torch.cuda.synchronize()
    rec = profiling.record()
    c = rec.counters
    assert (c["k1.launches"], c["k2.launches"], c["solve.launches"]) == (2, 2, 4)
    assert {s.name for s in rec.spans} == {"oak.eval", "oak.bound", "oak.prep",
                                           "oak.gram.fwd", "oak.gram.bwd", "oak.linalg",
                                           "oak.update"}
    assert {s.eval for s in rec.spans} == {1}
    ev = next(s for s in rec.spans if s.name == "oak.eval")
    for s, own in zip(rec.spans, rec.self_ns()):
        assert 0 <= own <= s.end_ns - s.start_ns
        if s.name == "oak.gram.bwd":
            assert s.parent == -1 and s.thread != ev.thread
            assert ev.start_ns <= s.start_ns <= s.end_ns <= ev.end_ns


# ---------------------------------------------------------------------------
# The training bounds' triangular solve (csrc/tri_solve.cu, ops/tri_solve.py)
# ---------------------------------------------------------------------------
# (M, N, lanes): the two cells' shapes, the sizes where the lanes build of K1
# and K2 faults at small sizes, M not a multiple of 32 with odd N, a single
# narrow panel, and an M past one panel's shared memory (split in two)
SOLVE_CASES = [(512, 8192, 1), (500, 6553, 4), (20, 1100, 4), (40, 2100, 4), (37, 9, 1),
               (33, 131, 2), (100, 64, 1), (1600, 300, 1)]


def _solve_inputs(M, N, lanes, seed, device):
    """A lower-triangular L of a well-conditioned SPD matrix and a B, float32
    on ``device``, each [lanes, ...]."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(lanes, M, M, generator=g, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.mT / M + 0.05 * torch.eye(M, dtype=torch.float64))
    B = torch.randn(lanes, M, N, generator=g, dtype=torch.float64)
    return L.float().contiguous().to(device), B.float().to(device)


def _rel(x, ref):
    return float((x.double() - ref).abs().max() / ref.abs().max())


# The kernel rounds a blocked substitution with inverted 32 x 32 diagonal
# blocks in FP32, the library a substitution of its own order: its error
# against float64 at the same float32 inputs may be a few times the
# library's, never of another order (a wrong index reads O(1)); 4x the
# library's error, and under 1e-5 of max |X|.
def _solve_ok(x, lib, ref):
    err, lib_err = _rel(x, ref), _rel(lib, ref)
    return err <= min(4 * lib_err + 1e-7, 1e-5), f"kernel {err:.2e}, library {lib_err:.2e}"


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transposed"])
@pytest.mark.parametrize("M,N,lanes", SOLVE_CASES, ids=[f"{m}x{n}x{r}" for m, n, r in SOLVE_CASES])
def test_tri_solve_kernel_matches_float64(cuda, M, N, lanes, transpose):
    """Both forms, one launch for all lanes, against the float64 solve of
    the same float32 inputs."""
    from oak_tpu_torch.ops import tri_solve as ts

    L, B = _solve_inputs(M, N, lanes, M + N + lanes, cuda)
    with profiling.recording():
        X = ts._launch(L, B, transpose, lanes, (True, True)) if lanes > 1 else \
            ts._launch(L[0], B[0], transpose)[None]
        torch.cuda.synchronize()
    assert counted("solve.launches") > 0
    ok, text = _solve_ok(X, ts.tri_solve_plain(L, B, transpose),
                         ts.tri_solve_plain(L.double(), B.double(), transpose))
    assert ok, text


def test_tri_solve_kernel_reads_the_lower_triangle_and_passes_nan(cuda):
    """An upper triangle of NaN is never read; an all-NaN L (a failed
    Cholesky) gives an all-NaN X in both forms, and a NaN in B reaches X."""
    from oak_tpu_torch.ops import tri_solve as ts

    L, B = _solve_inputs(70, 333, 1, 5, cuda)
    L, B = L[0], B[0]
    garbage = (L + torch.full_like(L, float("nan")).triu(1)).contiguous()
    for transpose in (False, True):
        ok, text = _solve_ok(ts._launch(garbage, B, transpose), ts.tri_solve_plain(L, B, transpose),
                             ts.tri_solve_plain(L.double(), B.double(), transpose))
        assert ok, text
        assert torch.isnan(ts._launch(torch.full_like(L, float("nan")), B, transpose)).all()
        Bn = B.clone()
        Bn[40, 7] = float("nan")
        assert torch.isnan(ts._launch(L, Bn, transpose)[:, 7]).any()


def test_tri_solve_gradient_through_the_kernel(cuda):
    """TriSolve's gradients for a non-contiguous cotangent dA, against
    float64 autograd of the library solve, as close as the library's own
    float32 gradients are: one forward and one transposed launch."""
    from oak_tpu_torch.ops import psd

    L, B = _solve_inputs(500, 2049, 1, 9, cuda)
    L, B = L[0], B[0]
    G = torch.randn(2049, 500, generator=torch.Generator().manual_seed(10)).to(cuda).mT
    assert not G.is_contiguous()

    def grads(fn, L_, B_):
        Lr, Br = L_.clone().requires_grad_(True), B_.clone().requires_grad_(True)
        return torch.autograd.grad(fn(Lr, Br), (Lr, Br), G.to(L_.dtype))

    with profiling.recording():
        ours = grads(psd.solve_lower_wide, L, B)
        torch.cuda.synchronize()
    assert counted("solve.launches") == 2
    lib = grads(lambda a, b: torch.linalg.solve_triangular(a, b, upper=False), L, B)
    ref = grads(lambda a, b: torch.linalg.solve_triangular(a, b, upper=False),
                L.double(), B.double())
    assert torch.equal(ours[0].triu(1), torch.zeros_like(ours[0]))  # dL is lower
    for name, o, li, r in zip(("dL", "dB"), ours, lib, ref):
        ok, text = _solve_ok(o, li, r)
        assert ok, (name, text)


def test_tri_solve_routes_by_dtype(cuda):
    """float32 launches the kernel, float64 on the card takes the library's
    solve (no launch) and agrees, float16 raises."""
    from oak_tpu_torch.ops import psd

    L, B = _solve_inputs(64, 300, 1, 11, cuda)
    L, B = L[0], B[0]
    with profiling.recording():
        X = psd.solve_lower_wide(L, B)
        X64 = psd.solve_lower_wide(L.double(), B.double())
        torch.cuda.synchronize()
    assert counted("solve.launches") == 1
    assert _rel(X, X64) < 1e-5
    with pytest.raises(TypeError, match="float32"):
        psd.solve_lower_wide(L.half(), B.half())


def test_vmapped_lanes_launch_each_solve_once(cuda):
    """The vmapped loss and gradient of 4 lanes of a float32 SGPR on the card
    launch each solve once for all lanes, as one lane does: the wide solve
    forward and transposed, and the two transposed solves of each of the
    two Choleskys' reverse passes (6); they agree with the lanes one by one;
    predict_f launches none."""
    from oak_tpu_torch.models import SGPR
    from oak_tpu_torch.optim import fit
    from oak_tpu_torch.optim.multistart import _make_starts
    from oak_tpu_torch.params import flatten_trainable

    rng = np.random.default_rng(74)
    X = rng.normal(size=(3000, 6))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(3000, 1))
    kw = dict(dtype=torch.float32, device=cuda)
    model = SGPR.create(X, Y, OAKKernel.create(num_dims=6, max_interaction_depth=3, **kw),
                        X[:100], noise_variance=0.1, **kw)
    loss_fn = lambda m: m.training_loss()  # noqa: E731
    starts = _make_starts(flatten_trainable(model).detach(), 4, 0.3, 0, True)
    with profiling.recording():
        fit.value_and_grad(model, loss_fn, starts[0])
        assert counted("solve.launches") == 6
        values, grads = fit.LaneLoss(model, loss_fn).value_and_grad(starts)
        torch.cuda.synchronize()
    assert counted("solve.launches") == 12
    for r in range(4):
        v, g = fit.value_and_grad(model, loss_fn, starts[r])
        assert abs(float(values[r] - v)) <= 1e-4 * abs(float(v))
        assert float((grads[r] - g).abs().max()) <= GRAD_TOL * float(g.abs().max())
    with torch.no_grad(), profiling.recording():
        model.predict_f(torch.as_tensor(X[:500], **kw))
    assert counted("solve.launches") == 0


# ---------------------------------------------------------------------------
# The Cholesky's reverse pass (ops/psd.py CholeskyVjp) on the solve kernel
# ---------------------------------------------------------------------------
# (M, lanes): sgpr8-fit4's Kuu and I + AAᵀ, svgp32-train's Kuu, heart-fit4's Kuu
VJP_CASES = [(500, 4), (512, 1), (200, 4)]


@pytest.mark.parametrize("M,lanes", VJP_CASES, ids=[f"{r}x{m}" for m, r in VJP_CASES])
def test_cholesky_vjp_through_the_kernel(cuda, M, lanes):
    """The gradient of a random cotangent through ``cholesky_lower``, vmapped
    over the lanes as a multistart's are, against float64 autograd of the
    library's Cholesky, as close as the library's own float32 backward is
    (``_solve_ok``): two launches of the solve for all lanes, one
    ``chol.vjp``, and a factor bitwise the library's."""
    from oak_tpu_torch.ops import psd

    L0, _ = _solve_inputs(M, 1, lanes, 3 * M + lanes, cuda)
    A = (L0 @ L0.mT).contiguous()
    G = torch.randn(lanes, M, M, generator=torch.Generator().manual_seed(M)).to(cuda)

    def vjp(a, g):
        L, pull = torch.func.vjp(psd.cholesky_lower, a)
        return L, pull(g)[0]

    with profiling.recording():
        L, ours = torch.func.vmap(vjp)(A, G)
        torch.cuda.synchronize()
    assert counted("solve.launches") == 2 and counted("chol.vjp") == 1
    assert torch.equal(L, torch.linalg.cholesky(A))

    def library(a):
        a = a.clone().requires_grad_(True)
        return torch.autograd.grad(torch.linalg.cholesky_ex(a)[0], a, G.tril().to(a.dtype))[0]

    with profiling.recording():
        lib, ref = library(A), library(A.double())
    assert counted("solve.launches") == 0
    ok, text = _solve_ok(ours, lib, ref)
    assert ok, text


def test_cholesky_vjp_keeps_the_library_past_one_panel_and_in_float64(cuda):
    """A GPR at N 1,600 (past one panel of the solve kernel) and a float64
    Cholesky on the card take autograd's backward: no solve launched, no
    ``chol.vjp``; the float32 GPR's gradient agrees with float64 within
    chip_smoke.py's training gate (1e-2 of max |g|)."""
    from oak_tpu_torch.models import GPR
    from oak_tpu_torch.ops import psd
    from oak_tpu_torch.ops import tri_solve as ts
    from oak_tpu_torch.optim import fit
    from oak_tpu_torch.params import flatten_trainable

    assert ts._panel(1600, 1600, 1, cuda) == 0 and ts._panel(1504, 1504, 1, cuda) > 0
    rng = np.random.default_rng(75)
    X = rng.normal(size=(1600, 4))
    Y = np.sin(X[:, :1]) + 0.1 * rng.normal(size=(1600, 1))
    kw = dict(dtype=torch.float32, device=cuda)
    model = GPR.create(X, Y, OAKKernel.create(num_dims=4, max_interaction_depth=2, **kw),
                       noise_variance=0.1, **kw)
    loss_fn = lambda m: m.training_loss()  # noqa: E731
    with profiling.recording():
        _, g = fit.value_and_grad(model, loss_fn, flatten_trainable(model).detach())
        A = torch.eye(300, dtype=torch.float64, device=cuda).requires_grad_(True)
        torch.autograd.grad(psd.cholesky_lower(A).sum(), A)
        torch.cuda.synchronize()
    assert counted("solve.launches") == 0 and counted("chol.vjp") == 0
    model64 = model.to(dtype=torch.float64)
    _, g64 = fit.value_and_grad(model64, loss_fn, flatten_trainable(model64).detach())
    assert float((g.double() - g64).abs().max()) <= 1e-2 * float(g64.abs().max())


def test_natural_gradient_lanes_launch_each_solve_once(cuda):
    """Two vmapped natural-gradient steps over 3 lanes of a full-q float32
    SVGP with 2 latent GPs and 100 inducing points on the card: q's
    [R, M, M] Cholesky folds its lanes and R into one launch per solve, so
    a step launches 6 (the wide solve forward and transposed, two for Kuu's
    factor, two for q's), as a lane stepped alone does. The losses agree with the lanes stepped one by
    one, and the iterates are as close to the float64 steps as those are
    (float32 rounding moves a natural step's q by ~1e-3 of max |x|);
    ``fit_natgrad_multistart`` runs to a finite loss."""
    import copy

    from oak_tpu_torch.optim import fit, natgrad
    from oak_tpu_torch.optim.multistart import _make_starts, fit_natgrad_multistart
    from oak_tpu_torch.params import flatten_trainable

    rng = np.random.default_rng(76)
    X = rng.normal(size=(2000, 4))
    Y = np.hstack([np.sin(X[:, :1]), np.cos(X[:, 1:2])]) + 0.1 * rng.normal(size=(2000, 2))
    kw = dict(dtype=torch.float32, device=cuda)
    model = SVGP.create(OAKKernel.create(num_dims=4, max_interaction_depth=2, **kw),
                        Gaussian.create(0.1, **kw), X[:100], num_latent=2, q_diag=False,
                        num_data=len(X), **kw)
    model64 = copy.deepcopy(model).to(dtype=torch.float64)

    def loss_in(dtype):
        Xt, Yt = (torch.as_tensor(a, dtype=dtype, device=cuda) for a in (X, Y))
        return lambda m: m.training_loss(Xt, Yt)

    loss_fn = loss_in(torch.float32)
    vecs = _make_starts(flatten_trainable(model).detach(), 3, 0.3, 1, True)
    leaf = vecs.clone().requires_grad_(True)
    step = natgrad.natgrad_lanes_step(fit.adam(leaf, 1e-2), leaf, model, loss_fn, 0.2)
    with profiling.recording():
        losses = torch.stack([step() for _ in range(2)])
        torch.cuda.synchronize()
    assert counted("solve.launches") == 12

    def alone(m, lf, v):
        one = v.clone().requires_grad_(True)
        single = natgrad.natgrad_adam_step(fit.adam(one, 1e-2), one, m, lf, 0.2)
        return torch.stack([single() for _ in range(2)]).detach(), one.detach()

    err_lanes, err_alone = [], []
    for r in range(3):
        with profiling.recording():
            v, one = alone(model, loss_fn, vecs[r])
            torch.cuda.synchronize()
        assert counted("solve.launches") == 12
        assert float((losses[:, r] - v).abs().max()) <= 1e-4 * float(v.abs().max()), r
        _, one64 = alone(model64, loss_in(torch.float64), vecs[r].double())
        err_lanes.append(_rel(leaf[r].detach(), one64))
        err_alone.append(_rel(one, one64))
    assert max(err_lanes) <= 2 * max(err_alone) + 1e-4, (err_lanes, err_alone)
    res = fit_natgrad_multistart(model, loss_fn, n_starts=3, steps=2, gamma=0.2)
    assert np.isfinite(res.fun)


# ---------------------------------------------------------------------------
# The lower-triangle product (csrc/gemmt.cu, ops/gemmt.py)
# ---------------------------------------------------------------------------
# (lanes, M, K): the three cells' shapes (sgpr8-fit4's AAᵀ and dL,
# svgp32-train's dL, heart-fit4's dL), then ragged M and K: M 37 and 129 (not
# multiples of a tile), K 1 (one product a term) and 1000 (not a multiple of
# the staged 16)
GEMMT_CASES = [(4, 500, 6553), (1, 512, 8192), (4, 200, 237), (2, 37, 1000), (1, 129, 1),
               (3, 129, 1000), (1, 37, 1)]


def _gemmt_inputs(lanes, M, K, seed, device):
    g = torch.Generator().manual_seed(seed)
    P, Q = (torch.randn(lanes, M, K, generator=g, dtype=torch.float64) for _ in range(2))
    return P.float().to(device), Q.float().to(device)


# A float32 sum of K products, in any order (the kernel splits K across a
# cluster's blocks, the library tiles it otherwise), is within γ_K = K u /
# (1 − K u) of Σ|p q| of the exact sum (u = 2^-24): that bound, entry by
# entry, holds for every order. Against the float64 product of the same
# float32 inputs the kernel is also as close as the library's own float32
# product, to 4 times its error (a wrong index reads O(1)).
def _gemmt_ok(C, P, Q, alpha, symmetric):
    from oak_tpu_torch.ops import gemmt as gm

    P64, Q64 = P.double(), (P if symmetric else Q).double()
    ref = gm.gemmt_plain(P64, Q64, alpha, symmetric)
    lib = gm.gemmt_plain(P, P if symmetric else Q, alpha, symmetric)
    K, u = P.shape[-1], 2.0 ** -24
    bound = K * u / (1 - K * u) * abs(alpha) * (P64.abs() @ Q64.abs().mT)
    bound = gm._mirrored(bound) if symmetric else torch.tril(bound)
    within = bool(((C.double() - ref).abs() <= bound + 1e-30).all())
    err, lib_err = _rel(C, ref), _rel(lib, ref)
    return within and err <= 4 * lib_err + 1e-7, f"kernel {err:.2e}, library {lib_err:.2e}"


@pytest.mark.parametrize("symmetric", [True, False], ids=["symmetric", "tril"])
@pytest.mark.parametrize("lanes,M,K", GEMMT_CASES, ids=[f"{r}x{m}x{k}" for r, m, k in GEMMT_CASES])
def test_gemmt_kernel_matches_float64(cuda, lanes, M, K, symmetric):
    """Both forms, one launch for all lanes, against the float64 product of
    the same float32 inputs; a second call gives the same bits (no atomics),
    the symmetric form is exactly symmetric and the tril form 0 above the
    diagonal."""
    from oak_tpu_torch.ops import gemmt as gm

    P, Q = _gemmt_inputs(lanes, M, K, lanes + M + K, cuda)
    Q = P if symmetric else Q
    with profiling.recording():
        C = gm.gemmt_op(P, Q, -0.5, symmetric)
        again = gm.gemmt_op(P, Q, -0.5, symmetric)
        torch.cuda.synchronize()
    assert counted("gemmt.launches") == 2
    assert torch.equal(C, again)
    if symmetric:
        assert torch.equal(C, C.mT)
    else:
        assert torch.equal(C.triu(1), torch.zeros_like(C))
    ok, text = _gemmt_ok(C, P, Q, -0.5, symmetric)
    assert ok, text


def test_gemmt_kernel_passes_nan(cuda):
    """A NaN in P reaches its row and, through the product, its column in
    both forms (the tril form's zeros above the diagonal stay 0); the lanes
    without it stay finite."""
    from oak_tpu_torch.ops import gemmt as gm

    P, Q = _gemmt_inputs(2, 70, 300, 5, cuda)
    P[1, 5, 17] = float("nan")
    S = gm.gemmt_op(P, P, 1.0, True)
    assert torch.isnan(S[1, 5]).all() and torch.isnan(S[1, :, 5]).all()
    assert torch.isfinite(S[0]).all() and torch.isfinite(S[1, 6:, 6:]).all()
    T = gm.gemmt_op(P, Q, 1.0, False)
    assert torch.isnan(T[1, 5, :6]).all() and not torch.isnan(T[1, 5, 6:]).any()


def test_gemmt_routes_by_dtype(cuda):
    """float32 launches the kernel, float64 on the card takes the library's
    product (no launch) and agrees, float16 raises."""
    from oak_tpu_torch.ops import gemmt as gm

    P, Q = _gemmt_inputs(1, 64, 300, 11, cuda)
    with profiling.recording():
        C = gm.gemmt(P[0], Q[0], 2.0)
        C64 = gm.gemmt(P[0].double(), Q[0].double(), 2.0)
        torch.cuda.synchronize()
    assert counted("gemmt.launches") == 1
    assert _rel(C, C64) < 1e-5
    with pytest.raises(TypeError, match="float32"):
        gm.gemmt(P[0].half(), Q[0].half())


def test_sym_product_gradient_through_the_kernel(cuda):
    """SymProduct vmapped over sgpr8-fit4's 4 lanes of 500 x 6553: one
    launch for the forward of all lanes, equal to the kernel's symmetric
    form; its gradient (G + Gᵀ)A against float64 autograd of A Aᵀ."""
    from oak_tpu_torch.ops import gemmt as gm

    A, _ = _gemmt_inputs(4, 500, 6553, 13, cuda)
    G = torch.randn(4, 500, 500, generator=torch.Generator().manual_seed(14)).to(cuda)
    with profiling.recording():
        S, pull = torch.func.vjp(torch.func.vmap(gm.SymProduct.apply), A)
        dA = pull(G)[0]
        torch.cuda.synchronize()
    assert counted("gemmt.launches") == 1
    assert torch.equal(S, gm.gemmt_op(A, A, 1.0, True))
    A64 = A.double().requires_grad_(True)
    ref = torch.autograd.grad(A64 @ A64.mT, A64, G.double())[0]
    Af = A.clone().requires_grad_(True)
    lib = torch.autograd.grad(Af @ Af.mT, Af, G)[0]
    ok, text = _solve_ok(dA, lib, ref)
    assert ok, text


def test_tri_solve_dL_through_the_kernel(cuda):
    """The wide solve's dL = −tril(dB Xᵀ) at svgp32-train's 512 x 8192 and,
    vmapped, sgpr8-fit4's 4 lanes of 500 x 6553: one gemmt launch for all
    lanes, dL lower-triangular, as close to float64 autograd of the library
    solve as the library's own float32 gradient is (``_solve_ok``)."""
    from oak_tpu_torch.ops import psd

    for lanes, M, N in ((1, 512, 8192), (4, 500, 6553)):
        L, B = _solve_inputs(M, N, lanes, M + lanes, cuda)
        G = torch.randn(lanes, M, N, generator=torch.Generator().manual_seed(M)).to(cuda)

        def grad_L(solve, dtype):
            Lr = L.to(dtype).requires_grad_(True)
            f = torch.func.vmap(solve) if solve is psd.solve_lower_wide else solve
            return torch.autograd.grad(f(Lr, B.to(dtype)), Lr, G.to(dtype))[0]

        library = lambda a, b: torch.linalg.solve_triangular(a, b, upper=False)  # noqa: E731
        with profiling.recording():
            ours = grad_L(psd.solve_lower_wide, torch.float32)
            torch.cuda.synchronize()
        assert counted("gemmt.launches") == 1 and counted("solve.launches") == 2
        assert torch.equal(ours.triu(1), torch.zeros_like(ours))
        ok, text = _solve_ok(ours, grad_L(library, torch.float32), grad_L(library, torch.float64))
        assert ok, (lanes, M, N, text)
