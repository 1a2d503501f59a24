"""The training bounds' wide triangular solve (``ops/tri_solve.py``) on the
CPU, where ``TriSolve`` runs its plain route (the registered op's CPU
implementation, ``torch.linalg.solve_triangular``), at float64:

- the SVGP and SGPR training losses and gradients equal those of the
  library's solve and autograd's Cholesky backward, which the bounds took
  before, to 1e-12;
- ``TriSolve`` (through ``ops.psd.solve_lower_wide``) passes ``gradcheck``,
  both of its forms pass ``gradgradcheck``, and a second derivative under
  ``torch.func`` equals the library's; both forms of the op pass
  ``opcheck``, and ``torch.func.vmap`` of ``grad_and_value`` over lanes
  (L, B or both batched) agrees with the lanes one by one;
- a gradient evaluation of either bound runs the op twice for its wide
  solve (A = L⁻¹Kuf and dKuf = L⁻ᵀdA) and twice for each Cholesky it
  differentiates (``ops.psd.CholeskyVjp``'s two transposed solves: one in
  the SVGP, two in the SGPR), and counts ``solve.launches`` so, with the
  op's plain route standing in for the card's launch; ``predict_f`` and the
  trace of an exported predict count none: the prediction paths keep the
  library's solve.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.model import oak_model
from oak_tpu_torch.models import SGPR, SVGP, Bernoulli, Gaussian
from oak_tpu_torch.ops import psd
from oak_tpu_torch.ops import tri_solve as ts
from oak_tpu_torch.serving import serialize_predict
from oak_tpu_torch.utils import profiling

KW = dict(dtype=torch.float64, device="cpu")


def _data(n=30, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    return X, y[:, None]


def _kernel(d=3):
    return OAKKernel.create(num_dims=d, max_interaction_depth=2, **KW)


def _model(kind):
    """(model, its training loss) for the bound ``kind``."""
    X, Y = _data()
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    if kind == "sgpr":
        return SGPR.create(X, Y, _kernel(), X[:9], noise_variance=0.1, **KW), \
            lambda m: m.training_loss()
    q_diag, whiten = {"svgp": (True, True), "svgp-full-q": (False, True),
                      "svgp-unwhitened": (True, False)}.get(kind, (True, True))
    lik = (Bernoulli.create() if kind == "svgp-bernoulli"
           else Gaussian.create(0.1, **KW))
    if kind == "svgp-bernoulli":
        Yt = (Yt > 0).to(Yt.dtype)
    m = SVGP.create(_kernel(), lik, X[:9], q_diag=q_diag, whiten=whiten, num_data=len(X),
                    **KW)
    # q(u) off its start, so that every term of the bound moves
    vec = tp.flatten_trainable(m).detach()
    vec = vec + 0.1 * torch.as_tensor(np.random.default_rng(1).normal(size=vec.shape[0]))
    tp.assign_trainable(m, vec)
    return m, lambda mm: mm.training_loss(Xt, Yt)


def _at(model, loss_fn):
    return lambda v: tp.call_with(model, tp.unflatten_trainable(model, v), loss_fn)


def _loss_and_grad(model, loss_fn):
    return torch.func.grad_and_value(_at(model, loss_fn))(tp.flatten_trainable(model).detach())


BOUNDS = ["svgp", "svgp-full-q", "svgp-unwhitened", "svgp-bernoulli", "sgpr"]


@pytest.mark.parametrize("kind", BOUNDS)
def test_bound_matches_the_library_solve_in_float64(monkeypatch, kind):
    model, loss_fn = _model(kind)
    grad, loss = _loss_and_grad(model, loss_fn)
    with monkeypatch.context() as mp:
        mp.setattr(psd.TriSolve, "apply",
                   lambda L, B, transpose: torch.linalg.solve_triangular(L, B, upper=False))
        mp.setattr(psd, "_own_vjp", lambda A: False)
        grad0, loss0 = _loss_and_grad(model, loss_fn)
    assert torch.isfinite(loss) and torch.isfinite(grad).all()
    assert abs(loss - loss0) <= 1e-12 * abs(loss0)
    assert (grad - grad0).abs().max() <= 1e-12 * grad0.abs().max()


def _tri(M, seed):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(M, M, generator=g, **KW)
    return torch.linalg.cholesky(A @ A.T / M + 0.5 * torch.eye(M, **KW))


@pytest.mark.parametrize("M,N", [(5, 7), (33, 3), (12, 40)])
def test_tri_solve_passes_gradcheck(M, N):
    L = _tri(M, M).requires_grad_()
    B = torch.randn(M, N, generator=torch.Generator().manual_seed(N), **KW).requires_grad_()
    assert torch.autograd.gradcheck(psd.solve_lower_wide, (L, B))


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transposed"])
def test_tri_solve_passes_gradgradcheck(transpose):
    L = _tri(7, 4).requires_grad_()
    B = torch.randn(7, 6, generator=torch.Generator().manual_seed(6), **KW).requires_grad_()
    assert torch.autograd.gradgradcheck(lambda L_, B_: psd.TriSolve.apply(L_, B_, transpose),
                                        (L, B))


def test_a_second_derivative_by_torch_func_matches_the_library():
    L, B = _tri(6, 2), torch.randn(6, 5, generator=torch.Generator().manual_seed(5), **KW)

    def hessian_row(solve):
        f = lambda L_, B_: torch.sum(torch.sin(solve(L_, B_)))  # noqa: E731
        return torch.func.grad(lambda L_: torch.func.grad(f, argnums=1)(L_, B).sum())(L)

    torch.testing.assert_close(
        hessian_row(psd.solve_lower_wide),
        hessian_row(lambda L_, B_: torch.linalg.solve_triangular(L_, B_, upper=False)),
        rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("transpose", [False, True])
def test_registered_op_passes_opcheck(transpose):
    L, B = _tri(9, 0), torch.randn(9, 13, **KW)
    torch.library.opcheck(ts.tri_solve_op, (L, B, transpose))
    X = ts.tri_solve_op(L, B, transpose)
    torch.testing.assert_close(((L.mT if transpose else L) @ X), B, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("batched", [(0, 0), (0, None), (None, 0)],
                         ids=["both", "L-only", "B-only"])
def test_vmap_over_lanes_agrees_with_lanes_in_turn(batched):
    R, M, N = 4, 10, 17
    Ls = torch.stack([_tri(M, r) for r in range(R)])
    Bs = torch.randn(R, M, N, generator=torch.Generator().manual_seed(3), **KW)
    W = torch.randn(M, N, generator=torch.Generator().manual_seed(4), **KW)

    def f(L, B):
        return torch.sum(W * torch.sin(psd.solve_lower_wide(L, B)))

    args = tuple(t if d == 0 else t[0] for t, d in zip((Ls, Bs), batched))
    (gL, gB), val = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0, 1)),
                                    in_dims=batched)(*args)
    for r in range(R):
        one = tuple(t[r] if d == 0 else t for t, d in zip(args, batched))
        (gL1, gB1), val1 = torch.func.grad_and_value(f, argnums=(0, 1))(*one)
        torch.testing.assert_close(val[r], val1, rtol=1e-13, atol=0)
        torch.testing.assert_close(gL[r], gL1, rtol=1e-13, atol=1e-15)
        torch.testing.assert_close(gB[r], gB1, rtol=1e-13, atol=1e-15)


@pytest.fixture
def counted(monkeypatch):
    """The op's plain route counted as the card's launch is: the counter
    ``solve.launches``."""
    plain = ts.tri_solve_plain

    def launch(L, B, transpose=False):
        profiling.count("solve.launches")
        return plain(L, B, transpose)

    monkeypatch.setattr(ts, "tri_solve_plain", launch)


# solves of one gradient evaluation: the wide solve's two forms and two for
# each differentiated Cholesky (the SVGP's Kuu; the SGPR's Kuu and I + AAᵀ)
GRAD_SOLVES = {"svgp": 2 + 2, "sgpr": 2 + 2 * 2}


@pytest.mark.parametrize("kind", ["svgp", "sgpr"])
def test_a_gradient_evaluation_counts_its_solves_and_predict_f_none(counted, kind):
    model, loss_fn = _model(kind)
    n = GRAD_SOLVES[kind]
    with profiling.recording():
        _loss_and_grad(model, loss_fn)
    assert profiling.record().counters["solve.launches"] == n
    with profiling.recording():
        with torch.no_grad():
            loss_fn(model)
    assert profiling.record().counters["solve.launches"] == 1
    X, _ = _data(n=11, seed=5)
    with profiling.recording():
        model.predict_f(torch.as_tensor(X))
        model.predict_y(torch.as_tensor(X))
    assert "solve.launches" not in profiling.record().counters


def test_vmapped_lanes_solve_once_for_all_lanes(counted):
    model, loss_fn = _model("sgpr")
    vec0 = tp.flatten_trainable(model).detach()
    vecs = vec0 + 0.05 * torch.as_tensor(np.random.default_rng(2).normal(size=(4, vec0.shape[0])))
    with profiling.recording():
        torch.func.vmap(torch.func.grad_and_value(_at(model, loss_fn)))(vecs)
    assert profiling.record().counters["solve.launches"] == GRAD_SOLVES["sgpr"]


def test_exported_predict_traces_no_solve(counted):
    X, y = _data(n=60)
    oak = oak_model(max_interaction_depth=2, **KW)
    oak.fit(X, y, optimise=False)
    with profiling.recording():
        blob = serialize_predict(oak, device="cpu")
    assert blob and "solve.launches" not in profiling.record().counters
