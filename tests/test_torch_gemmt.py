"""The lower-triangle product of the training bounds (``ops/gemmt.py``) on
the CPU, where the registered op runs its plain route
(``gemmt_plain``), at float64:

- the op equals α·tril(P Qᵀ), and its symmetric form the mirrored P Pᵀ,
  with leading lane dims that broadcast and ragged M and K, and passes
  ``opcheck``;
- ``Gemmt``, ``SymProduct`` and ``TriSolve``, whose dL runs through
  ``Gemmt``, pass ``gradcheck`` and ``gradgradcheck``; the vmap rules agree
  with the lanes taken in turn;
- the SGPR bound's trace term, now the diagonal of its symmetric AAᵀ,
  equals Σ A² to 1e-12;
- a gradient evaluation of the SGPR bound runs the op twice (AAᵀ and the
  wide solve's dL), of the SVGP bound once (dL), a value alone once and
  none; vmapped lanes run it as often as one lane; ``predict_f`` runs it
  never;
- ``ops.routes``, which the solve and the product share: every CPU tensor
  takes the ops' own route, and ``lanes_first`` lays a vmap rule's operands
  out lanes first.

The kernel itself runs only on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest
import torch

from oak_tpu_torch import params as tp
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.models import SGPR, SVGP, Gaussian
from oak_tpu_torch.ops import gemmt as gm
from oak_tpu_torch.ops import psd, routes
from oak_tpu_torch.utils import profiling

KW = dict(dtype=torch.float64, device="cpu")


def _randn(*shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed), **KW)


# (leading dims of P, of Q, M, K): one matrix, lanes, lanes broadcast
# against a shared operand, two leading dims; M and K off any tile
SHAPES = [((), (), 5, 7), ((3,), (3,), 37, 1), ((4,), (), 9, 130), ((), (2,), 1, 17),
          ((2, 3), (1, 3), 12, 33)]


@pytest.mark.parametrize("alpha", [1.0, -0.5])
@pytest.mark.parametrize("lp,lq,M,K", SHAPES, ids=[f"{lp}{lq}{m}x{k}" for lp, lq, m, k in SHAPES])
def test_plain_route_is_the_lower_triangle_of_the_product(lp, lq, M, K, alpha):
    P, Q = _randn(*lp, M, K, seed=M), _randn(*lq, M, K, seed=K)
    C = gm.gemmt_op(P, Q, alpha, False)
    full = P @ Q.mT
    assert C.shape == full.shape
    torch.testing.assert_close(C, alpha * torch.tril(full), rtol=1e-14, atol=0)
    assert torch.equal(C.triu(1), torch.zeros_like(C))
    S = gm.gemmt_op(P, P, alpha, True)
    assert torch.equal(S, S.mT)
    torch.testing.assert_close(S, alpha * (P @ P.mT), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("symmetric", [False, True], ids=["tril", "symmetric"])
def test_registered_op_passes_opcheck(symmetric):
    P = _randn(3, 6, 11, seed=1)
    Q = P if symmetric else _randn(3, 6, 11, seed=2)
    torch.library.opcheck(gm.gemmt_op, (P, Q, 0.25, symmetric))


def test_gemmt_passes_gradcheck_and_gradgradcheck():
    P = _randn(2, 6, 9, seed=3).requires_grad_()
    Q = _randn(2, 6, 9, seed=4).requires_grad_()
    f = lambda p, q: gm.Gemmt.apply(p, q, -0.7)  # noqa: E731
    assert torch.autograd.gradcheck(f, (P, Q))
    assert torch.autograd.gradgradcheck(f, (P, Q))


def test_sym_product_passes_gradcheck_and_gradgradcheck():
    A = _randn(2, 7, 10, seed=5).requires_grad_()
    assert torch.autograd.gradcheck(gm.SymProduct.apply, (A,))
    assert torch.autograd.gradgradcheck(gm.SymProduct.apply, (A,))


def _tri(M, seed):
    A = _randn(M, M, seed=seed)
    return torch.linalg.cholesky(A @ A.T / M + 0.5 * torch.eye(M, **KW))


@pytest.mark.parametrize("transpose", [False, True], ids=["forward", "transposed"])
def test_tri_solve_through_gemmt_passes_gradcheck_and_gradgradcheck(transpose):
    L = _tri(6, 6).requires_grad_()
    B = _randn(6, 13, seed=7).requires_grad_()
    f = lambda L_, B_: psd.TriSolve.apply(L_, B_, transpose)  # noqa: E731
    assert torch.autograd.gradcheck(f, (L, B))
    assert torch.autograd.gradgradcheck(f, (L, B))


@pytest.mark.parametrize("batched", [(0, 0), (0, None), (None, 0)],
                         ids=["both", "P-only", "Q-only"])
def test_gemmt_vmap_agrees_with_lanes_in_turn(batched):
    R, M, K = 4, 8, 21
    Ps, Qs = _randn(R, M, K, seed=8), _randn(R, M, K, seed=9)
    W = _randn(M, M, seed=10)

    def f(P, Q):
        return torch.sum(W * torch.sin(gm.Gemmt.apply(P, Q, 1.5)))

    args = tuple(t if d == 0 else t[0] for t, d in zip((Ps, Qs), batched))
    (gP, gQ), val = torch.func.vmap(torch.func.grad_and_value(f, argnums=(0, 1)),
                                    in_dims=batched)(*args)
    for r in range(R):
        one = tuple(t[r] if d == 0 else t for t, d in zip(args, batched))
        (gP1, gQ1), val1 = torch.func.grad_and_value(f, argnums=(0, 1))(*one)
        torch.testing.assert_close(val[r], val1, rtol=1e-13, atol=0)
        torch.testing.assert_close(gP[r], gP1, rtol=1e-13, atol=1e-15)
        torch.testing.assert_close(gQ[r], gQ1, rtol=1e-13, atol=1e-15)


def test_sym_product_vmap_agrees_with_lanes_in_turn():
    As, W = _randn(3, 9, 14, seed=11), _randn(9, 9, seed=12)

    def f(A):
        return torch.sum(W * torch.sin(gm.SymProduct.apply(A)))

    g, val = torch.func.vmap(torch.func.grad_and_value(f))(As)
    for r in range(3):
        g1, val1 = torch.func.grad_and_value(f)(As[r])
        torch.testing.assert_close(val[r], val1, rtol=1e-13, atol=0)
        torch.testing.assert_close(g[r], g1, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float32, torch.float64])
def test_cpu_tensors_take_the_ops_own_route(dtype):
    assert routes.own_route(torch.zeros(2, 2, dtype=dtype))


def test_lanes_first_puts_the_lanes_first_and_aligns_leading_dims():
    P = _randn(2, 3, 4, 6, seed=13)  # a lane axis at dim 1, one leading dim of its own
    Q = _randn(4, 6, seed=14)  # no lane axis, no leading dim
    P1, Q1 = routes.lanes_first((1, None), P, Q)
    assert P1.shape == (3, 2, 4, 6) and Q1.shape == (1, 1, 4, 6)
    for r in range(3):
        assert torch.equal(P1[r], P[:, r])
    assert torch.equal(Q1[0, 0], Q)


def _data(n=30, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.5 * X[:, 1] * X[:, 2] + 0.1 * rng.normal(size=n)
    return X, y[:, None]


def _sgpr():
    X, Y = _data()
    k = OAKKernel.create(num_dims=3, max_interaction_depth=2, **KW)
    return SGPR.create(X, Y, k, X[:9], noise_variance=0.1, **KW)


def test_sgpr_trace_term_equals_the_sum_of_squares():
    m = _sgpr()
    AAT, _, _, _, trace = m.elbo_terms(m.X, m.Y)
    L = psd.cholesky(m.kernel.K(m.Z.value))
    A = torch.linalg.solve_triangular(L, m.kernel.K(m.Z.value, m.X), upper=False) \
        / torch.sqrt(m.likelihood.variance.value)
    ref = torch.sum(A * A)
    assert abs(trace - ref) <= 1e-12 * abs(ref)
    torch.testing.assert_close(AAT, A @ A.T, rtol=1e-12, atol=1e-14)


@pytest.fixture
def counted(monkeypatch):
    """The op's plain route counted as the card's launch is: the counter
    ``gemmt.launches``."""
    plain = gm.gemmt_plain

    def launch(P, Q, alpha=1.0, symmetric=False):
        profiling.count("gemmt.launches")
        return plain(P, Q, alpha, symmetric)

    monkeypatch.setattr(gm, "gemmt_plain", launch)


def _bound(kind):
    """(model, its training loss at its trainable vector)."""
    X, Y = _data()
    if kind == "sgpr":
        m = _sgpr()
        loss = lambda mm: mm.training_loss()  # noqa: E731
    else:
        m = SVGP.create(OAKKernel.create(num_dims=3, max_interaction_depth=2, **KW),
                        Gaussian.create(0.1, **KW), X[:9], num_data=len(X), **KW)
        Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
        loss = lambda mm: mm.training_loss(Xt, Yt)  # noqa: E731
    return m, lambda v: tp.call_with(m, tp.unflatten_trainable(m, v), loss)


# gemmt runs of a gradient evaluation (AAᵀ in the SGPR, the wide solve's dL
# in both) and of a value alone
RUNS = {"sgpr": (2, 1), "svgp": (1, 0)}


@pytest.mark.parametrize("kind", ["sgpr", "svgp"])
def test_an_evaluation_counts_its_products_and_predict_f_none(counted, kind):
    m, at = _bound(kind)
    vec = tp.flatten_trainable(m).detach()
    with profiling.recording():
        torch.func.grad_and_value(at)(vec)
    assert profiling.record().counters.get("gemmt.launches", 0) == RUNS[kind][0]
    with profiling.recording():
        with torch.no_grad():
            at(vec)
    assert profiling.record().counters.get("gemmt.launches", 0) == RUNS[kind][1]
    vecs = vec + 0.05 * torch.as_tensor(np.random.default_rng(2).normal(size=(4, vec.shape[0])))
    with profiling.recording():
        torch.func.vmap(torch.func.grad_and_value(at))(vecs)
    assert profiling.record().counters.get("gemmt.launches", 0) == RUNS[kind][0]
    X, _ = _data(n=11, seed=5)
    with profiling.recording():
        m.predict_f(torch.as_tensor(X))
    assert "gemmt.launches" not in profiling.record().counters
