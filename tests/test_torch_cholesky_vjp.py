"""The Cholesky's reverse pass of the port's own (``ops.psd.CholeskyLower``
and ``CholeskyVjp``) on the CPU, where its two transposed solves take the
solve op's plain route (``torch.linalg.solve_triangular``), at float64 and
M ≤ 40:

- the gradient equals autograd's own Cholesky backward to 1e-10, for a
  cotangent with a non-zero upper triangle, one matrix or a batch;
- it passes ``gradcheck`` and ``gradgradcheck``, and so does the reverse
  pass itself (its analytic backward); second derivatives under
  ``torch.func`` equal the library's; ``torch.func.vmap`` over 4 lanes
  equals the lanes in turn;
- a matrix that does not factorise gives the same loss and a gradient as
  finite or not as the library's backward gives;
- ``cholesky_lower`` routes by what its input shows: a float64 card input
  and one whose rows fit no panel of the solve kernel keep autograd's
  backward (shown with a stand-in for the card's tensor and for the
  kernel's panel answer), as does a Cholesky no gradient is taken through;
- the counter ``chol.vjp`` reads 1 a gradient evaluation of an SVGP, 2 of
  an SGPR (one for all vmapped lanes), and 0 under ``no_grad``, in
  ``predict_f`` and in the trace of an exported predict;
- the op's card route folds every leading dim into one launch that keeps
  the kernel's contract, shown with a CPU stand-in for the launch: alone,
  under ``torch.func.vmap`` of the op (either operand unbatched, with
  leading dims of its own), and in vmapped natural-gradient steps, whose q
  factor is [R, M, M] a lane.

The card's route (the kernel ``csrc/tri_solve.cu``) is in
``tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from oak_tpu_torch import params as tp
from oak_tpu_torch.model import oak_model
from oak_tpu_torch.ops import psd
from oak_tpu_torch.ops import tri_solve as ts
from oak_tpu_torch.serving import serialize_predict
from oak_tpu_torch.utils import profiling
from test_torch_tri_solve import KW, _at, _data, _loss_and_grad, _model


def _spd(shape, seed):
    """Well-conditioned SPD matrices of shape [..., M, M]."""
    g = torch.Generator().manual_seed(seed)
    M = shape[-1]
    X = torch.randn(*shape, generator=g, **KW)
    return X @ X.mT / M + 0.5 * torch.eye(M, **KW)


def _library_grad(A, G):
    A = A.clone().requires_grad_(True)
    return torch.autograd.grad(torch.linalg.cholesky_ex(A)[0], A, G)[0]


def _own_grad(A, G):
    A = A.clone().requires_grad_(True)
    return torch.autograd.grad(psd.CholeskyLower.apply(A)[0], A, G)[0]


@pytest.mark.parametrize("shape", [(1, 1), (7, 7), (40, 40), (3, 9, 9), (2, 2, 5, 5)],
                         ids=["1", "7", "40", "3x9", "2x2x5"])
def test_vjp_matches_the_library_backward(shape):
    A = _spd(shape, shape[-1])
    G = torch.randn(*shape, generator=torch.Generator().manual_seed(1), **KW)
    assert G.triu(1).abs().max() > 0 or shape[-1] == 1
    L, info = psd.CholeskyLower.apply(A)
    assert torch.equal(L, torch.linalg.cholesky_ex(A)[0]) and not info.any()
    ours, lib = _own_grad(A, G), _library_grad(A, G)
    assert float((ours - lib).abs().max()) <= 1e-10 * float(lib.abs().max())
    torch.testing.assert_close(ours, ours.mT, rtol=0, atol=1e-15 * float(lib.abs().max()))


def test_vjp_passes_gradcheck_and_gradgradcheck():
    M = 6

    def f(X):  # an SPD matrix of a free X, so that every entry is perturbed
        return psd.CholeskyLower.apply(X @ X.mT + M * torch.eye(M, **KW))[0]

    X = torch.randn(M, M, generator=torch.Generator().manual_seed(2), **KW).requires_grad_()
    assert torch.autograd.gradcheck(f, (X,))
    assert torch.autograd.gradgradcheck(f, (X,))


def test_reverse_pass_passes_gradcheck_and_gradgradcheck():
    """``CholeskyVjp`` as a function of a factor (its upper triangle too,
    which only the product Lᵀ gL reads) and a cotangent: its own backward is
    the second derivative, and that backward's is the third."""
    L = torch.linalg.cholesky(_spd((5, 5), 13)).requires_grad_()
    G = torch.randn(5, 5, generator=torch.Generator().manual_seed(14), **KW).requires_grad_()
    assert torch.autograd.gradcheck(psd.CholeskyVjp.apply, (L, G))
    assert torch.autograd.gradgradcheck(psd.CholeskyVjp.apply, (L, G))


def test_second_derivatives_by_torch_func_match_the_library():
    A = _spd((3, 6, 6), 15)
    W = torch.randn(6, 6, generator=torch.Generator().manual_seed(16), **KW)

    def lanes(chol):
        f = lambda a: torch.sum(W * torch.sin(chol(a)))  # noqa: E731
        outer = lambda a: torch.sum(torch.cos(torch.func.grad(f)(a)))  # noqa: E731
        return torch.func.vmap(torch.func.grad(outer))(A)

    torch.testing.assert_close(lanes(psd.cholesky_lower),
                               lanes(lambda a: torch.linalg.cholesky_ex(a)[0]),
                               rtol=1e-10, atol=1e-12)


def test_vmap_over_lanes_matches_the_lanes_in_turn():
    A = _spd((4, 11, 11), 3)
    W = torch.randn(11, 11, generator=torch.Generator().manual_seed(4), **KW)

    def f(a):
        return torch.sum(W * torch.sin(psd.cholesky_lower(a)))

    with profiling.recording():
        grads, vals = torch.func.vmap(torch.func.grad_and_value(f))(A)
    assert profiling.record().counters["chol.vjp"] == 1
    for r in range(4):
        g1, v1 = torch.func.grad_and_value(f)(A[r])
        torch.testing.assert_close(vals[r], v1, rtol=1e-13, atol=0)
        torch.testing.assert_close(grads[r], g1, rtol=1e-12, atol=1e-14)
        torch.testing.assert_close(grads[r], _library_grad(A[r], torch.cos(
            torch.linalg.cholesky(A[r])) * W), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("bad", ["negative", "indefinite", "nan"])
def test_a_failed_factorisation_matches_the_library(monkeypatch, bad):
    """One lane of three does not factorise: the loss is NaN either way, and
    each lane's gradient is finite where the library's is."""
    A = _spd((3, 8, 8), 5)
    if bad == "negative":
        A[1] = -torch.eye(8, **KW)
    elif bad == "indefinite":
        A[1, 3, 3] = -1.0
    else:
        A[1, 2, 2] = float("nan")
    W = torch.randn(8, 8, generator=torch.Generator().manual_seed(6), **KW)

    def loss_and_grad():
        a = A.clone().requires_grad_(True)
        L = psd.cholesky_lower(a)
        loss = torch.sum(W * L) + psd.logdet_from_chol(L)
        return loss, torch.autograd.grad(loss, a)[0]

    with profiling.recording():
        loss, g = loss_and_grad()
    assert profiling.record().counters["chol.vjp"] == 1
    monkeypatch.setattr(psd, "_own_vjp", lambda A: False)
    loss0, g0 = loss_and_grad()
    assert torch.isnan(loss) and torch.isnan(loss0)
    for r in range(3):
        assert bool(torch.isfinite(g[r]).all()) == bool(torch.isfinite(g0[r]).all())
        if torch.isfinite(g0[r]).all():
            torch.testing.assert_close(g[r], g0[r], rtol=1e-10, atol=1e-12)


class _OnCard(torch.Tensor):
    """A CPU tensor that reads as a card's, for the route's choice."""

    @property
    def is_cuda(self):
        return True


def _vjps(A, panel, monkeypatch):
    """``chol.vjp`` over one gradient through ``cholesky_lower`` of A read as
    a card tensor, with the kernel's panel answer ``panel``; the gradient
    against the library's."""
    asked = []

    def fake_panel(M, N, lanes, device):
        asked.append((M, N, lanes))
        return panel

    monkeypatch.setattr(ts, "_panel", fake_panel)
    a = torch.Tensor._make_subclass(_OnCard, A, True)
    assert a.is_cuda
    G = torch.randn(A.shape, generator=torch.Generator().manual_seed(8), dtype=A.dtype)
    with profiling.recording():
        (g,) = torch.autograd.grad(psd.cholesky_lower(a), a, G)
    lib = _library_grad(A, torch.tril(G))
    assert float((g - lib).abs().max()) <= 1e-5 * float(lib.abs().max())
    return profiling.record().counters.get("chol.vjp", 0), asked


@pytest.mark.parametrize("dtype,panel,own", [(torch.float32, 32, True),
                                             (torch.float32, 0, False),
                                             (torch.float64, 32, False)],
                         ids=["f32-fits-a-panel", "f32-past-one-panel", "f64"])
def test_card_route_by_dtype_and_panel(monkeypatch, dtype, panel, own):
    vjps, asked = _vjps(_spd((9, 9), 7).to(dtype), panel, monkeypatch)
    assert vjps == int(own)
    assert asked == ([(9, 9, 1)] if dtype == torch.float32 else [])


def test_no_gradient_keeps_the_library_route(monkeypatch):
    taken = []
    monkeypatch.setattr(psd.CholeskyLower, "apply", lambda A: taken.append(A))
    A = _spd((6, 6), 9)
    psd.cholesky_lower(A)
    with torch.no_grad():
        psd.cholesky_lower(A.requires_grad_())
    assert taken == []


@pytest.mark.parametrize("kind,vjps", [("svgp", 1), ("sgpr", 2)])
def test_chol_vjp_counts_each_differentiated_cholesky(kind, vjps):
    model, loss_fn = _model(kind)
    with profiling.recording():
        _loss_and_grad(model, loss_fn)
    assert profiling.record().counters["chol.vjp"] == vjps
    vec0 = tp.flatten_trainable(model).detach()
    vecs = vec0 + 0.05 * torch.as_tensor(np.random.default_rng(3).normal(size=(4, vec0.shape[0])))
    with profiling.recording():
        torch.func.vmap(torch.func.grad_and_value(_at(model, loss_fn)))(vecs)
    assert profiling.record().counters["chol.vjp"] == vjps
    X, _ = _data(n=11, seed=5)
    with profiling.recording():
        with torch.no_grad():
            loss_fn(model)
        model.predict_f(torch.as_tensor(X))
        model.predict_y(torch.as_tensor(X))
    assert "chol.vjp" not in profiling.record().counters


def test_exported_predict_takes_no_vjp():
    X, y = _data(n=60)
    oak = oak_model(max_interaction_depth=2, **KW)
    oak.fit(X, y, optimise=False)
    with profiling.recording():
        assert serialize_predict(oak, device="cpu")
    assert "chol.vjp" not in profiling.record().counters


def _contract_launch(calls):
    """A CPU stand-in for ``tri_solve._launch`` that holds its operands to
    the kernel's contract (contiguous; [M, ·], or [lanes, M, ·] where
    ``batched`` says so) and records each launch's lanes."""

    def launch(L, B, transpose, lanes=0, batched=(True, True)):
        for t, lead in zip((L, B), batched):
            assert t.is_contiguous()
            assert t.dim() == 2 + bool(lanes and lead), (tuple(t.shape), lanes, batched)
            assert not (lanes and lead) or t.shape[0] == lanes
        calls.append(lanes)
        return ts.tri_solve_plain(L, B, transpose).contiguous()

    return launch


@pytest.mark.parametrize("lead_L,lead_B", [((), ()), ((3,), (3,)), ((), (3,)), ((3,), ()),
                                           ((2, 3), (2, 3)), ((2, 1), (2, 3)),
                                           ((3,), (2, 3))],
                         ids=["one", "3", "shared-L", "shared-B", "2x3", "2x1-L", "3-L-2x3-B"])
def test_leading_dims_fold_into_one_launch(monkeypatch, lead_L, lead_B):
    """The op's card route solves every matrix of the broadcast leading dims
    in one launch, an operand with one matrix shared by every lane, and
    equals the plain route."""
    calls = []
    monkeypatch.setattr(ts, "_launch", _contract_launch(calls))
    L = torch.linalg.cholesky(_spd(lead_L + (7, 7), 10))
    B = torch.randn(lead_B + (7, 5), generator=torch.Generator().manual_seed(11), **KW)
    lead = torch.broadcast_shapes(lead_L, lead_B)
    for transpose in (False, True):
        X = ts._folded(L, B, transpose)
        assert X.shape == lead + (7, 5)
        torch.testing.assert_close(X, ts.tri_solve_plain(L, B, transpose), rtol=1e-14, atol=0)
    assert calls == [lead.numel() if lead.numel() > 1 else 0] * 2


@pytest.mark.parametrize("dims,lead_L,lead_B", [((0, 0), (2,), (2,)), ((None, 0), (2,), ()),
                                                ((0, None), (), (2,)), ((None, 0), (), ())],
                         ids=["both-R", "L-unbatched-R", "B-unbatched-R", "L-shared"])
def test_the_op_under_vmap_folds_lanes_and_leading_dims(monkeypatch, dims, lead_L, lead_B):
    """``torch.func.vmap`` of the op over 3 lanes: one launch for the lanes
    and each lane's leading dims, an unbatched operand aligned behind the
    lane axis, equal to the lanes solved in turn."""
    calls = []
    monkeypatch.setattr(ts, "_launch", _contract_launch(calls))
    monkeypatch.setattr(ts, "_tri_solve_cpu", ts._folded)
    L = torch.linalg.cholesky(_spd(((3,) if dims[0] == 0 else ()) + lead_L + (6, 6), 17))
    B = torch.randn(((3,) if dims[1] == 0 else ()) + lead_B + (6, 4),
                    generator=torch.Generator().manual_seed(18), **KW)
    X = torch.func.vmap(ts.tri_solve_op, in_dims=(*dims, None))(L, B, True)
    for r in range(3):
        Lr, Br = (t if d is None else t[r] for t, d in zip((L, B), dims))
        torch.testing.assert_close(X[r], ts.tri_solve_plain(Lr, Br, True), rtol=1e-14, atol=0)
    lead = torch.broadcast_shapes(lead_L, lead_B)
    assert calls == [3 * lead.numel()]


def test_vmapped_natural_gradient_lanes_fold_into_one_launch_each(monkeypatch):
    """A vmapped natural-gradient step over 3 lanes of a full-q SVGP with
    R = 2 latent GPs differentiates q's [R, M, M] Cholesky in every lane.
    With the card's route stood in for (the op on ``_folded``, whose
    launches keep the kernel's contract), every solve is one launch:
    3 lanes for Kuu's factor and the wide solve, 3 x R for q's factor; and
    the steps equal the plain route's."""
    from oak_tpu_torch.models import SVGP, Gaussian
    from oak_tpu_torch.optim import fit, natgrad
    from oak_tpu_torch.optim.multistart import _make_starts
    from test_torch_tri_solve import _kernel

    X, Y = _data()
    model = SVGP.create(_kernel(), Gaussian.create(0.1, **KW), X[:8], num_latent=2,
                        q_diag=False, num_data=len(X), **KW)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(np.hstack([Y, np.cos(X[:, :1])]))
    loss_fn = lambda m: m.training_loss(Xt, Yt)  # noqa: E731
    vecs = _make_starts(tp.flatten_trainable(model).detach(), 3, 0.3, 1, True)

    def steps():
        leaf = vecs.clone().requires_grad_(True)
        step = natgrad.natgrad_lanes_step(fit.adam(leaf, 1e-2), leaf, model, loss_fn, 0.2)
        return torch.stack([step() for _ in range(2)]), leaf.detach()

    plain = steps()
    calls = []
    monkeypatch.setattr(ts, "_launch", _contract_launch(calls))
    monkeypatch.setattr(ts, "tri_solve_op", ts._folded)
    with profiling.recording():
        folded = steps()
    assert sorted(calls) == [3] * 8 + [6] * 4
    assert profiling.record().counters["chol.vjp"] == 4
    for a, b in zip(folded, plain):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
