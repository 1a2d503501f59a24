"""The grouped (stacked) evaluation of the per-dim kernels against oak_tpu's
and against a per-dim loop written here, at float64 on the CPU:
stackable_groups on mixed kernel lists, Newton–Girard over a stacked axis,
per_dim_batched for every measure and closed form (rel 1e-10 of max |ref|),
_prep, K, K_diag and an SVGP loss with its gradient (rel 1e-12 against the
per-dim loop; 1e-10 against oak_tpu on a model whose binary and
categorical dims sit between RBF dims; the fused route's CPU version
through _prep against the loop), the number of aten ops one _prep, K
and K_diag dispatch (independent of D for one group), and a grouped model
exported and served."""

import io
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode

import oak_tpu.kernels.oak_kernel as jok
import oak_tpu.kernels.ortho_binary as jbin
import oak_tpu.kernels.ortho_categorical as jcat
import oak_tpu.kernels.ortho_rbf as jrbf
import oak_tpu.measures as jmeas
import oak_tpu.params as jp
import oak_tpu.sobol as jsb
from oak_tpu.models import SVGP as JSVGP
from oak_tpu.models import Gaussian as JGaussian
from oak_tpu.ops.newton_girard import newton_girard_stacked as j_newton_girard_stacked
from oak_tpu.ops.newton_girard import power_sums as j_power_sums
from oak_tpu_torch import measures as tmeas
from oak_tpu_torch import params as tp
from oak_tpu_torch import sobol as sb
from oak_tpu_torch.kernels import (OAKKernel, OrthogonalBinary, OrthogonalCategorical,
                                   OrthogonalRBF, UnconstrainedRBF, kernel_K,
                                   kernel_K_diag, per_dim_batched, stack_group,
                                   stackable_groups)
from oak_tpu_torch.kernels import ortho_binary as tbin
from oak_tpu_torch.kernels import ortho_rbf as trbf
from oak_tpu_torch.kernels.oak_kernel import OAKKernel as TOAKKernel
from oak_tpu_torch.model import oak_model
from oak_tpu_torch.models import SVGP, Gaussian
from oak_tpu_torch.ops import newton_girard as tng
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.serving import deserialize_predict, serialize_predict
from tests.test_torch_kernels import _bridge, _close

REL = 1e-10  # against oak_tpu
LOOP_REL = 1e-12  # against the per-dim loop below
KW = dict(dtype=torch.float64, device="cpu")


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


# --------------------------------------------------------------------------- #
# The per-dim loop: one closed-form call per constituent kernel on its own
# column, the reference for the grouped code.
# --------------------------------------------------------------------------- #
def loop_prep(oak, X, X2):
    us1, us2, cs1, cs2, logbs, extras = [], [], [], [], [], []
    for k in oak.kernels:
        col1, col2 = X[:, k.active_dim], X2[:, k.active_dim]
        if isinstance(k, (OrthogonalRBF, UnconstrainedRBF)):
            ls2 = k.lengthscale.value * og._SQRT2
            us1.append(col1 / ls2)
            us2.append(col2 / ls2)
            if isinstance(k, OrthogonalRBF):
                rs = torch.rsqrt(torch.clamp_min(trbf.var_s(k), og._RSQRT_FLOOR))
                cs1.append(trbf.cov_x_s(k, col1) * rs)
                cs2.append(trbf.cov_x_s(k, col2) * rs)
            else:
                cs1.append(torch.zeros_like(col1))
                cs2.append(torch.zeros_like(col2))
            v = k.variance.value.reshape(())
            logbs.append(torch.log(torch.clamp_min(v, og._VARIANCE_FLOOR)))
        else:
            extras.append(kernel_K(k, col1, col2))
    extra = (torch.stack(extras) if extras
             else X.new_zeros((0, X.shape[0], X2.shape[0])))
    sig2 = torch.stack([v.value.reshape(()) for v in oak.variances])
    return (torch.stack(us1), torch.stack(us2), torch.stack(cs1), torch.stack(cs2),
            extra, torch.stack(logbs), sig2)


def loop_gram_power_sums(oak, X, X2, depth):
    return tng.power_sums(
        [kernel_K(k, X[:, k.active_dim], None if X2 is None else X2[:, k.active_dim])
         for k in oak.kernels], depth)


def loop_diag_power_sums(oak, X, depth):
    return tng.power_sums([kernel_K_diag(k, X[:, k.active_dim]) for k in oak.kernels],
                          depth)


@pytest.fixture
def per_dim_loop(monkeypatch):
    """Within the test, the kernel's and the fused route's grouped
    evaluations replaced by the per-dim loop."""
    monkeypatch.setattr(TOAKKernel, "_gram_power_sums", loop_gram_power_sums)
    monkeypatch.setattr(TOAKKernel, "_diag_power_sums", loop_diag_power_sums)
    monkeypatch.setattr(og, "_prep", loop_prep)


# --------------------------------------------------------------------------- #
# Kernels of every kind, built alike in both packages
# --------------------------------------------------------------------------- #
def _kernel(kind, dim, pkg):
    """One constituent kernel of ``kind`` on input dim ``dim``: oak_tpu's
    (pkg "jax") or the port's (pkg "torch")."""
    torch_pkg = pkg == "torch"
    kw = KW if torch_pkg else dict(dtype=jnp.float64)
    ms = tmeas if torch_pkg else jmeas
    rbf = OrthogonalRBF if torch_pkg else jrbf.OrthogonalRBF
    bounds = {"gauss": [1e-3, 1e3], "gauss_b2": [1e-2, 1e2]}.get(kind)
    if kind in ("gauss", "gauss_b2", "gauss_free"):
        return rbf.create(ms.GaussianMeasure.create(0.0, 1.0, **kw), active_dim=dim,
                          lengthscale_bounds=bounds, **kw)
    if kind == "uniform":
        return rbf.create(ms.UniformMeasure.create(-1.0, 2.0, **kw), active_dim=dim, **kw)
    if kind.startswith("empirical"):
        n = int(kind[len("empirical"):])
        loc = np.linspace(-2, 2, n).reshape(-1, 1)
        return rbf.create(ms.EmpiricalMeasure.create(loc, **kw), active_dim=dim, **kw)
    if kind == "mog":
        mog = ms.MOGMeasure.create(np.array([-0.5, 0.5]), np.array([0.7, 1.3]),
                                   np.array([0.4, 0.6]), **kw)
        return rbf.create(mog, active_dim=dim, **kw)
    if kind == "binary":
        return (OrthogonalBinary if torch_pkg else jbin.OrthogonalBinary).create(
            p0=0.3, active_dim=dim, **kw)
    if kind.startswith("cat"):
        p = np.full(int(kind[3:]), 1.0 / int(kind[3:]))
        if torch_pkg:
            return OrthogonalCategorical.create(
                p, active_dim=dim, generator=torch.Generator().manual_seed(dim), **kw)
        return jcat.OrthogonalCategorical.create(p, active_dim=dim,
                                                 key=jax.random.PRNGKey(dim), **kw)
    assert kind == "unconstrained"
    return (UnconstrainedRBF if torch_pkg else jok.UnconstrainedRBF).create(
        active_dim=dim, **kw)


MIXED = ["gauss", "binary", "gauss_b2", "cat3", "empirical9", "gauss", "uniform", "mog",
         "cat4", "unconstrained", "empirical5", "gauss_b2", "binary", "cat3",
         "empirical9", "mog", "uniform", "unconstrained", "gauss_free", "cat4"]


@pytest.mark.parametrize("seed", [None, 1, 2])
def test_stackable_groups_match_oak_tpu(seed):
    kinds = list(MIXED) if seed is None else list(np.random.default_rng(seed).permutation(MIXED))
    groups = stackable_groups([_kernel(k, d, "torch") for d, k in enumerate(kinds)])
    assert groups == jok.stackable_groups([_kernel(k, d, "jax") for d, k in enumerate(kinds)])
    assert sorted(i for g in groups for i in g) == list(range(len(kinds)))
    assert all({kinds[i] for i in g} == {kinds[g[0]]} for g in groups)


def test_stackable_groups_of_an_oak_kernel_match_oak_tpu():
    kw = dict(num_dims=6, max_interaction_depth=2, p0=[None, 0.4, None, None, None, None],
              p=[None, None, None, np.array([0.2, 0.8]), None, None],
              empirical_locations=[None, None, np.linspace(-1, 1, 4).reshape(-1, 1),
                                   None, None, None])
    jk = jok.OAKKernel.create(**kw, dtype=jnp.float64)
    tk = OAKKernel.create(**kw, **KW)
    assert stackable_groups(tk.kernels) == jok.stackable_groups(jk.kernels) \
        == [[0, 4, 5], [1], [2], [3]]


# --------------------------------------------------------------------------- #
# Newton–Girard over a stacked axis
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,depth", [((5, 6, 7), 4), ((8, 11), 3)])
def test_newton_girard_stacked_matches_oak_tpu_and_bruteforce(shape, depth):
    stack = np.random.default_rng(61).normal(size=shape)
    e = tng.newton_girard_stacked(_t(stack), depth)
    assert e.shape == (depth + 1,) + shape[1:]
    ref = jax.jit(j_newton_girard_stacked, static_argnums=1)(jnp.asarray(stack), depth)
    _close(e, ref)
    brute = tng.elementary_symmetric_bruteforce(list(_t(stack)), depth)
    _close(e, torch.stack(brute).numpy())
    for a, b in zip(tng.power_sums_stacked(_t(stack), depth),
                    j_power_sums(list(jnp.asarray(stack)), depth)):
        _close(a, b)
    with pytest.raises(ValueError):
        tng.newton_girard_stacked(_t(stack)[:0], depth)


# --------------------------------------------------------------------------- #
# per_dim_batched for every kind of kernel and every per-dim form
# --------------------------------------------------------------------------- #
KINDS = ["gauss", "uniform", "empirical9", "mog", "binary", "cat3"]
FNS = {"kernel_K": (kernel_K, jok.kernel_K),
       "kernel_K_diag": (kernel_K_diag, jok.kernel_K_diag),
       "compute_L_for_kernel": (sb.compute_L_for_kernel, jsb.compute_L_for_kernel),
       "factor_form": (sb.factor_form, jsb.factor_form)}
DIMS = [2, 0, 3]  # a group's members need not be in column order


def _inputs(kind, rng, n=13):
    X = rng.normal(size=(n, 4))
    if kind == "binary":
        X = rng.integers(0, 2, size=(n, 4)).astype(float)
    elif kind.startswith("cat"):
        X = rng.integers(0, 3, size=(n, 4)).astype(float)
    return X


@pytest.fixture(scope="module")
def batched():
    """{kind: (the port's kernels, X, {fn: oak_tpu's per_dim_batched})}, the
    references from one compiled program. The first Gaussian kernel's
    lengthscale sits under half its measure's scale, so its L takes the
    closed form and the others quadrature."""
    rng = np.random.default_rng(62)
    cases, jks, jXs = {}, [], []
    for kind in KINDS:
        tks = nn.ModuleList([_kernel(kind, d, "torch") for d in DIMS])
        jk = _bridge(tuple(_kernel(kind, d, "jax") for d in DIMS), tks, noise_seed=63)
        if kind == "gauss":
            jk = (jk[0].replace(lengthscale=jk[0].lengthscale.assign(0.3)),) + jk[1:]
            with torch.no_grad():
                tks[0].lengthscale.raw.copy_(_t(jk[0].lengthscale.raw))
        X = _inputs(kind, rng)
        cases[kind] = (tks, X)
        jks.append(jk)
        jXs.append(jnp.asarray(X))

    @jax.jit
    def refs(jks, jXs):
        return [{name: jok.per_dim_batched(list(jk), jX, fns[1])
                 for name, fns in FNS.items()} for jk, jX in zip(jks, jXs)]

    return {kind: cases[kind] + (r,) for kind, r in zip(KINDS, refs(jks, jXs))}


@pytest.mark.parametrize("fn", list(FNS))
@pytest.mark.parametrize("kind", KINDS)
def test_per_dim_batched_matches_oak_tpu(batched, kind, fn):
    tks, X, refs = batched[kind]
    with torch.no_grad():
        out = per_dim_batched(tks, _t(X), FNS[fn][0])
    assert len(out) == len(DIMS)
    for got, ref in zip(out, refs[fn]):
        if isinstance(ref, tuple):
            for a, b in zip(got, ref):
                _close(a, b)
        else:
            _close(got, ref)


def test_stack_group_carries_gradients_to_every_member():
    ks = [_kernel("gauss", d, "torch") for d in range(3)]
    view = stack_group(ks, [0, 1, 2])
    assert isinstance(view, OrthogonalRBF) and view.active_dim == 0
    assert view.lengthscale.raw.shape == (3,) and view.measure.var.shape == (3,)
    x = _t(np.random.default_rng(64).normal(size=(3, 5)))
    torch.sum(kernel_K(view, x) ** 2).backward()
    for i, k in enumerate(ks):
        ref = torch.autograd.grad(torch.sum(kernel_K(k, x[i]) ** 2),
                                  [k.lengthscale.raw, k.variance.raw])
        _close(k.lengthscale.raw.grad, ref[0].numpy(), LOOP_REL)
        _close(k.variance.raw.grad, ref[1].numpy(), LOOP_REL)


# --------------------------------------------------------------------------- #
# _prep, K, K_diag and the SVGP loss: grouped, the per-dim loop, oak_tpu
# --------------------------------------------------------------------------- #
def _svgp_pair(model):
    """(jax_model, torch_model, X, Y): "rbf" is one group of four Gaussian
    dims; "interleaved" puts a binary and a categorical dim between
    Gaussian dims and an empirical-measure dim (two RBF-form groups whose
    rows interleave, and two extra grams)."""
    rng = np.random.default_rng(65)
    N, M = 24, 7
    kw = dict(num_dims=4)
    if model == "interleaved":
        kw = dict(num_dims=6, p0=[None, 0.4, None, None, None, None],
                  p=[None, None, None, np.array([0.3, 0.3, 0.4]), None, None],
                  empirical_locations=[None] * 4 + [np.linspace(-2, 2, 6).reshape(-1, 1),
                                                    None])
    kw.update(max_interaction_depth=3, use_sparsity_prior=True,
              lengthscale_bounds=[1e-3, 1e3])
    X = rng.normal(size=(N, kw["num_dims"]))
    if model == "interleaved":
        X[:, 1] = rng.integers(0, 2, N)
        X[:, 3] = rng.integers(0, 3, N)
    Y = np.tanh(X[:, 0]) + 0.3 * X[:, 2] * X[:, -1] + 0.1 * rng.normal(size=N)
    Z = X[rng.choice(N, M, replace=False)]
    jm = JSVGP.create(jok.OAKKernel.create(**kw, dtype=jnp.float64),
                      JGaussian.create(0.05, dtype=jnp.float64), Z, num_data=N,
                      dtype=jnp.float64)
    tm = SVGP.create(OAKKernel.create(**kw, **KW), Gaussian.create(0.05, **KW), Z,
                     num_data=N)
    jm = _bridge(jm, tm, noise_seed=66)
    return jm, tm, X, Y.reshape(-1, 1)


@pytest.fixture(scope="module", params=["rbf", "interleaved"])
def svgp(request):
    """The model pair and, for the interleaved model, oak_tpu's K(Z, X),
    K(X), K_diag(X), training loss and the loss's gradient with respect to
    every trainable raw (flatten_trainable order), from one compiled
    program (the file's costliest compile; the one-group model's grams are
    held against oak_tpu in test_torch_kernels.py)."""
    jm, tm, X, Y = _svgp_pair(request.param)
    W = np.random.default_rng(67).normal(size=(tm.Z.value.shape[0], X.shape[0]))

    @jax.jit
    def refs(jm, X, Y):
        k, Z = jm.kernel, jm.Z.value
        loss, grad = jax.value_and_grad(lambda m: m.training_loss(X, Y))(jm)
        return dict(Kzx=k.K(Z, X), Kxx=k.K(X), Kdiag=k.K_diag(X), loss=loss,
                    g_loss=jp.flatten_trainable(grad)[0])

    ref = {}
    if request.param == "interleaved":
        ref = refs(jm, jnp.asarray(X), jnp.asarray(Y))
    return SimpleNamespace(model=tm, X=_t(X), Y=_t(Y), W=_t(W), ref=ref)


def test_grouped_prep_matches_the_per_dim_loop_and_oak_tpu(svgp):
    oak, X = svgp.model.kernel, svgp.X
    Z = svgp.model.Z.value.detach()
    with torch.no_grad():
        got = og._prep(oak, Z, X)
        for a, b in zip(got, loop_prep(oak, Z, X)):
            assert a.shape == b.shape
            if b.numel():
                _close(a, b.numpy(), LOOP_REL)
        # the fused route's inputs give oak_tpu's gram (its own _prep runs in
        # float32, so the gram is what is compared with it)
        if svgp.ref:
            _close(og.oak_gram_plain(*got, oak.max_interaction_depth), svgp.ref["Kzx"])


@pytest.mark.parametrize("what", ["K(Z, X)", "K(X)", "K_diag(X)"])
def test_grouped_gram_matches_the_per_dim_loop_and_oak_tpu(svgp, what, monkeypatch):
    oak, X = svgp.model.kernel, svgp.X
    Z = svgp.model.Z.value.detach()
    fn, ref = {"K(Z, X)": (lambda: oak.K(Z, X), "Kzx"),
               "K(X)": (lambda: oak.K(X), "Kxx"),
               "K_diag(X)": (lambda: oak.K_diag(X), "Kdiag")}[what]
    with torch.no_grad():
        grouped = fn()
        if svgp.ref:
            _close(grouped, svgp.ref[ref])
        monkeypatch.setattr(TOAKKernel, "_gram_power_sums", loop_gram_power_sums)
        monkeypatch.setattr(TOAKKernel, "_diag_power_sums", loop_diag_power_sums)
        _close(grouped, fn().numpy(), LOOP_REL)


def _loss_and_grads(svgp):
    """The SVGP training loss, Σ og.oak_gram(Z, X)·W (the fused route's CPU
    version, through _prep), and the gradients of both w.r.t. every
    trainable raw."""
    m = svgp.model
    raws = [p.raw for p in tp.trainable_params(m)]
    loss = m.training_loss(svgp.X, svgp.Y)
    g_loss = torch.autograd.grad(loss, raws)
    gram = torch.sum(og.oak_gram(m.kernel, m.Z.value, svgp.X) * svgp.W)
    g_gram = torch.autograd.grad(gram, raws, allow_unused=True)
    g_gram = [torch.zeros_like(r) if g is None else g for g, r in zip(g_gram, raws)]
    return loss.detach(), g_loss, gram.detach(), g_gram


def _flat(grads):
    return torch.cat([g.reshape(-1) for g in grads])


def test_grouped_loss_and_gradients_match_the_per_dim_loop_and_oak_tpu(svgp, request):
    loss, g_loss, gram, g_gram = _loss_and_grads(svgp)
    if svgp.ref:
        _close(loss, svgp.ref["loss"])
        _close(_flat(g_loss), svgp.ref["g_loss"])
    # every trainable raw of the kernel, each member of a group included,
    # receives its gradient through the stacks
    kernel_raws = {id(p.raw) for p in tp.trainable_params(svgp.model.kernel)}
    for p, g in zip(tp.trainable_params(svgp.model), g_gram):
        if id(p.raw) in kernel_raws:
            assert torch.count_nonzero(g) == g.numel()
    request.getfixturevalue("per_dim_loop")
    ref = _loss_and_grads(svgp)
    for a, b in zip((loss, _flat(g_loss), gram, _flat(g_gram)),
                    (ref[0], _flat(ref[1]), ref[2], _flat(ref[3]))):
        _close(a, b.numpy(), LOOP_REL)


# --------------------------------------------------------------------------- #
# The structure: the ops one call dispatches do not grow with D
# --------------------------------------------------------------------------- #
class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _ops(fn):
    with torch.no_grad(), _CountOps() as mode:
        fn()
    return mode.n


@pytest.mark.parametrize("what", ["_prep", "K_diag", "K"])
def test_ops_per_call_do_not_grow_with_d_on_one_group(what):
    counts = []
    for D in (4, 16):
        oak = OAKKernel.create(D, 3, use_sparsity_prior=True,
                               lengthscale_bounds=[1e-3, 1e3], **KW)
        assert stackable_groups(oak.kernels) == [list(range(D))]
        rng = np.random.default_rng(68)
        X, Z = _t(rng.normal(size=(20, D))), _t(rng.normal(size=(6, D)))
        fn = {"_prep": lambda: og._prep(oak, Z, X), "K_diag": lambda: oak.K_diag(X),
              "K": lambda: oak.K(Z, X)}[what]
        counts.append(_ops(fn))
    assert counts[0] == counts[1], counts


# --------------------------------------------------------------------------- #
# A grouped model exported and served
# --------------------------------------------------------------------------- #
def test_grouped_model_exports_and_serves_the_live_predict():
    """Exported on the CPU, the served predictions equal the live ones, and
    the traced graph holds as many exp nodes at D = 4 as at D = 2 (the
    per-dim closed forms traced once per group)."""
    exps = []
    for D in (2, 4):
        rng = np.random.default_rng(69)
        X = rng.normal(size=(24, D))
        y = (np.sin(X[:, 0]) + 0.3 * X[:, 1]).reshape(-1, 1)
        oak = oak_model(max_interaction_depth=2, use_normalising_flow=False, **KW)
        oak.fit(X, y, optimise=False)
        blob = serialize_predict(oak)
        served = deserialize_predict(blob)(X).detach().numpy()
        np.testing.assert_allclose(served, oak.predict(X, clip=True), rtol=1e-12,
                                   atol=1e-12)
        graph = torch.export.load(io.BytesIO(blob)).graph
        exps.append(sum(n.op == "call_function" and "exp" in str(n.target)
                        for n in graph.nodes))
    assert exps[0] == exps[1] > 0, exps


# --------------------------------------------------------------------------- #
# The API gaps of the kernel modules
# --------------------------------------------------------------------------- #
def test_binary_output_variance_matches_oak_tpu():
    tk = nn.ModuleList([_kernel("binary", 0, "torch")])
    (jk,) = _bridge((_kernel("binary", 0, "jax"),), tk, noise_seed=70)
    _close(tbin.output_variance(tk[0]), jbin.output_variance(jk))
    _close(tbin.output_variance(tk[0]), torch.diagonal(tbin.output_covariance(tk[0])).detach().numpy())


@pytest.mark.parametrize("levels", [3, 4])
def test_categorical_num_cat_matches_oak_tpu(levels):
    assert _kernel(f"cat{levels}", 0, "torch").num_cat \
        == _kernel(f"cat{levels}", 0, "jax").num_cat == levels
