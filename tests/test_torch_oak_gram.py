"""The port's fused-gram module against oak_tpu.ops.oak_gram_pallas: the
plain version against the XLA reference at float64 (rel 1e-10), the
prescaling against ``_prep`` in float32, and the plain version against the
Pallas kernel itself, run in interpret mode as tests/test_pallas_gram.py runs
it. The same for the backward: ``oak_gram_bwd_plain`` against autograd at
float64, against the Pallas backward in interpret mode, and its extra-gram
cotangent against ``_res_bwd``; and ``FusedGram`` on the CPU against plain
autograd. The CUDA kernels run only on the card (tests/test_torch_gpu.py)."""

import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import oak_tpu.measures as jmeas
from oak_tpu.kernels import OAKKernel as JOAKKernel
from oak_tpu.ops import oak_gram_pallas as ogp
from oak_tpu_torch import _build
from oak_tpu_torch import measures as tmeas
from oak_tpu_torch.checkpoint import load_params
from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.testing import counted
from oak_tpu_torch.utils import profiling

REL = 1e-10

# the port builds on the CUDA card in float32 by default; these tests hold it
# against oak_tpu at float64 on the CPU
KW = dict(dtype=torch.float64, device="cpu")


def _close(a, b, rel=REL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(a, b, rtol=rel, atol=rel * max(np.abs(b).max(), 1e-300))


def _prescaled(rng, D, N, M, E, depth):
    """Random prescaled inputs at realistic magnitudes, as numpy f64."""
    return dict(u1=rng.normal(size=(D, N)) / 2.0, u2=rng.normal(size=(D, M)) / 2.0,
                c1=rng.uniform(-0.8, 0.8, size=(D, N)),
                c2=rng.uniform(-0.8, 0.8, size=(D, M)),
                extra=rng.uniform(-0.3, 0.3, size=(E, N, M)),
                logb=rng.normal(scale=0.2, size=D),
                sig2=rng.uniform(0.05, 1.0, size=depth + 1))


def _torch_args(a, dtype=torch.float64):
    return [torch.as_tensor(a[k], dtype=dtype)
            for k in ("u1", "u2", "c1", "c2", "extra", "logb", "sig2")]


def _jax_args(a):
    return [jnp.asarray(a[k]) for k in ("u1", "u2", "c1", "c2", "extra")] + \
        [jnp.asarray(a["logb"])[None, :], jnp.asarray(a["sig2"])[None, :]]


@pytest.mark.parametrize("E,depth", [(0, 3), (2, 3), (0, 1), (1, 5)])
def test_plain_matches_xla_reference(E, depth):
    a = _prescaled(np.random.default_rng(41), D=5, N=19, M=13, E=E, depth=depth)
    out = og.oak_gram_plain(*_torch_args(a), depth)
    _close(out, ogp._xla_gram_from_prep(*_jax_args(a), depth))


# --------------------------------------------------------------------------- #
def _bridge(jobj, tobj, noise_seed):
    """Copy jobj's leaves, with every Param raw moved by N(0, 0.3) noise,
    into tobj and into a rebuilt JAX object."""
    import jax

    flat, treedef = jax.tree_util.tree_flatten_with_path(jobj)
    rng = np.random.default_rng(noise_seed)
    data = {}
    for kp, leaf in flat:
        key = "m" + jax.tree_util.keystr(kp)
        arr = np.asarray(leaf)
        data[key] = arr + rng.normal(scale=0.3, size=arr.shape) if key.endswith(".raw") else arr
    load_params(tobj, data)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(data["m" + jax.tree_util.keystr(kp)]) for kp, _ in flat])


def _kernels(kind, depth=3):
    if kind == "rbf":
        kw = dict(num_dims=5, max_interaction_depth=depth)
        return JOAKKernel.create(**kw), OAKKernel.create(**kw, **KW)
    loc = np.linspace(-2, 2, 9).reshape(-1, 1)
    w = np.full((9, 1), 1 / 9.0)
    mog = (np.array([-0.5, 0.5]), np.array([0.7, 1.3]), np.array([0.4, 0.6]))
    kw = dict(num_dims=5, max_interaction_depth=depth,
              p0=[0.4, None, None, None, None],
              p=[None, np.array([0.3, 0.3, 0.4]), None, None, None],
              empirical_locations=[None, None, None, loc, None],
              empirical_weights=[None, None, None, w, None])
    return (JOAKKernel.create(gmm_measures=[None] * 4 + [jmeas.MOGMeasure.create(*mog)], **kw),
            OAKKernel.create(gmm_measures=[None] * 4 + [tmeas.MOGMeasure.create(*mog, **KW)],
                             **kw, **KW))


def _inputs(kind, rng, N, M):
    X, X2 = rng.normal(size=(N, 5)), rng.normal(size=(M, 5))
    if kind == "mixed":
        X[:, 0], X2[:, 0] = rng.integers(0, 2, N), rng.integers(0, 2, M)
        X[:, 1], X2[:, 1] = rng.integers(0, 3, N), rng.integers(0, 3, M)
    return X, X2


@pytest.mark.parametrize("kind", ["rbf", "mixed"])
def test_prep_matches_jax(kind):
    """Both prescale in float32 (oak_tpu's _prep always does); the exp / erf
    of the two libraries differ in the last f32 ulps."""
    jk, tk = _kernels(kind)
    jk = _bridge(jk, tk, noise_seed=42)
    X, X2 = _inputs(kind, np.random.default_rng(43), 17, 11)
    X, X2 = X.astype(np.float32), X2.astype(np.float32)
    ours = og._prep(tk, torch.as_tensor(X), torch.as_tensor(X2))
    ref = ogp._prep(jk, jnp.asarray(X), jnp.asarray(X2))
    for name, a, b in zip(("u1", "u2", "c1", "c2", "extra", "logb", "sig2"), ours, ref):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=2e-6,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("kind", ["rbf", "mixed"])
def test_oak_gram_matches_jax_and_per_dim_route(kind):
    jk, tk = _kernels(kind)
    jk = _bridge(jk, tk, noise_seed=44)
    X, X2 = _inputs(kind, np.random.default_rng(45), 21, 8)
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    fused = og.oak_gram(tk, tX, tX2)
    # oak_tpu's own fused route always prescales in f32, so at f64 the
    # reference is its per-dim gram
    _close(fused, jk.K(jnp.asarray(X), jnp.asarray(X2)))
    _close(fused, tk.K(tX, tX2).detach().numpy())  # per-dim route on the CPU
    _close(og.oak_gram(tk, tX), tk.K(tX).detach().numpy())


def test_plain_matches_pallas_interpret(monkeypatch):
    """oak_gram_plain in f32 against the Pallas kernel on the same prescaled
    arrays: one 256 tile, all-RBF, D = 5, depth 3. rtol 1e-5, atol 1e-6,
    because the f32 sums run in a different order."""
    jk = JOAKKernel.create(num_dims=5, max_interaction_depth=3, dtype=jnp.float32)
    rng = np.random.default_rng(46)
    X = jnp.asarray(rng.normal(size=(200, 5)).astype(np.float32))
    X2 = jnp.asarray(rng.normal(size=(150, 5)).astype(np.float32))
    monkeypatch.setattr(ogp, "FORWARD", "pallas")
    with pltpu.force_tpu_interpret_mode():
        K_pallas = ogp.oak_gram(jk, X, X2)
    u1, u2, c1, c2, extra, logb, sig2 = (
        torch.as_tensor(np.array(t)) for t in ogp._prep(jk, X, X2))
    ours = og.oak_gram_plain(u1, u2, c1, c2, extra, logb, sig2, 3)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(K_pallas), rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------------- #
def test_fused_wrapper_takes_plain_route_on_cpu_with_autograd():
    a = _prescaled(np.random.default_rng(47), D=4, N=9, M=7, E=1, depth=3)
    args = _torch_args(a)
    for t in args:
        t.requires_grad_(True)
    with profiling.recording():
        out = og.oak_gram_fused(*args, 3)
        grads = torch.autograd.grad(out.sum(), args)
    assert counted("k1.launches") == counted("k2.launches") == 0  # no kernel on the CPU
    ref_args = [t.detach().clone().requires_grad_(True) for t in args]
    ref = og.oak_gram_plain(*ref_args, 3)
    ref_grads = torch.autograd.grad(ref.sum(), ref_args)
    _close(out, ref.detach().numpy())
    for g, r in zip(grads, ref_grads):
        _close(g, r.numpy())


def test_cpu_float32_K_takes_per_dim_route():
    tk = OAKKernel.create(num_dims=3, max_interaction_depth=2, dtype=torch.float32,
                          device="cpu")
    X = torch.as_tensor(np.random.default_rng(48).normal(size=(6, 3)), dtype=torch.float32)
    with profiling.recording():
        K = tk.K(X)
    assert K.dtype == torch.float32 and counted("k1.launches") == 0


def test_supports_fused():
    assert og.supports_fused(OAKKernel.create(num_dims=5, max_interaction_depth=3, **KW))
    _, mixed = _kernels("mixed")
    assert og.supports_fused(mixed)
    # all-discrete: nothing to fuse
    assert not og.supports_fused(OAKKernel.create(num_dims=2, max_interaction_depth=1,
                                                  p0=[0.5, 0.3], **KW))
    # depth is no part of the structure check, as in oak_tpu's supports_pallas:
    # on CUDA the kernels take it (tests/test_torch_gpu.py)
    for depth in (8, 9):
        jk = JOAKKernel.create(num_dims=10, max_interaction_depth=depth)
        tk = OAKKernel.create(num_dims=10, max_interaction_depth=depth, **KW)
        assert og.supports_fused(tk) and ogp.supports_pallas(jk)


def test_deep_plain_route_matches_jax():
    """Depth 12 over 14 dims (past the 8 the kernels once stopped at): the
    fused op's plain route, K(X, X2) and K(X), against oak_tpu at float64,
    rel 1e-10."""
    kw = dict(num_dims=14, max_interaction_depth=12, use_sparsity_prior=True)
    jk, tk = JOAKKernel.create(**kw), OAKKernel.create(**kw, **KW)
    jk = _bridge(jk, tk, noise_seed=49)
    rng = np.random.default_rng(50)
    X, X2 = rng.normal(size=(15, 14)), rng.normal(size=(9, 14))
    tX, tX2 = torch.as_tensor(X), torch.as_tensor(X2)
    _close(og.oak_gram(tk, tX, tX2), jk.K(jnp.asarray(X), jnp.asarray(X2)))
    _close(og.oak_gram(tk, tX), jk.K(jnp.asarray(X)))


@pytest.mark.parametrize("N,M,want", [(512, 8192, 0), (512, 512, 1), (512, 1, 1),
                                      (8192, 8192, 0), (1000, 77, 1)],
                         ids=["Kus", "Kuu", "one row", "square", "ragged"])
def test_pick_tile_covers_the_sms(N, M, want):
    """The large tile where its grid gives every one of 132 SMs a block, else
    the small one (the tiles the library reports at depth <= 8)."""
    assert og.pick_tile(N, M, [(64, 64), (32, 32)], 132) == want


def test_clamped_depth():
    """e_n of D + E grams is 0 past D + E, so the kernels run at most that."""
    assert og.clamped_depth(3, 32, 0) == 3
    assert og.clamped_depth(9, 6, 1) == 7
    assert og.clamped_depth(60, 60, 0) == 60
    assert og.clamped_depth(5, 0, 0) == 1


def test_ctypes_signature_matches_kernel_source():
    """Each C entry point's parameter list and return type, read from its .cu
    source, against the argtypes the loader sets (nvcc cannot be asked
    here); and the kernels' depth limit, which the wrapper checks before a
    launch. The tile sizes and the workspace come from the library."""
    assert [p.name for p in _build._sources()] == ["gemmt.cu", "oak_gram_bwd.cu",
                                                   "oak_gram_bwd_lanes.cu", "oak_gram_fwd.cu",
                                                   "oak_gram_fwd_lanes.cu", "tri_solve.cu"]
    src = "".join(p.read_text() for p in _build._sources())
    ctype = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for name, (argtypes, restype) in _build.SIGNATURES.items():
        m = re.search(r'extern "C" (int|long long) ' + name + r"\(([^)]*)\)", src)
        assert m is not None, name
        params = [p.strip() for p in m.group(2).split(",")]
        want = [ctypes.POINTER(ctypes.c_int) if p.startswith("int*") else
                ctypes.c_void_p if "*" in p else
                ctypes.c_longlong if p.startswith("long long") else
                ctypes.c_float if p.startswith("float ") else ctypes.c_int for p in params]
        assert argtypes == want, name
        assert restype is ctype[m.group(1)], name
    assert set(_build.SIGNATURES) == set(re.findall(r'extern "C" (?:int|long long) (\w+)\(', src))
    common = (_build.CSRC_DIR / "oak_gram_common.cuh").read_text()
    assert f"constexpr int kMaxDepth = {og.MAX_DEPTH};" in common
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


# --------------------------------------------------------------------------- #
# The backward
# --------------------------------------------------------------------------- #
_NAMES = ("u1", "u2", "c1", "c2", "extra", "logb", "sig2")


@pytest.mark.parametrize("E", [0, 2], ids=["rbf", "mixed"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_bwd_plain_matches_autograd(E, depth):
    """The written-out backward against torch.autograd.grad of the plain
    gram, at float64, for a gbar drawn N(0, 1): rel 1e-10."""
    rng = np.random.default_rng(70 + depth)
    a = _prescaled(rng, D=5, N=11, M=9, E=E, depth=depth)
    args = [t.requires_grad_(True) for t in _torch_args(a)]
    gbar = torch.as_tensor(rng.normal(size=(11, 9)))
    ref = torch.autograd.grad(og.oak_gram_plain(*args, depth), args, gbar,
                              allow_unused=True, materialize_grads=True)
    ours = og.oak_gram_bwd_plain(*[t.detach() for t in args], gbar, depth)
    for name, o, r in zip(_NAMES, ours, ref):
        assert o.shape == r.shape, name
        if r.numel():
            _close(o, r.numpy())


def _kernel_arithmetic(u1, u2, c1, c2, extra, logb, sig2, gbar, depth):
    """The CUDA kernels' arithmetic, written out in float64 torch: e_1..e_P
    by the product expansion e_k += g e_{k-1} at the depth clamped to the
    number of grams, and each gram's cotangent T = gbar W(g) as the
    polynomial sum_m a_m (-g)^m, a_m = gbar sum_{n=m+1..P} sig2[n] e_{n-1-m}
    (csrc/oak_gram_common.cuh, csrc/oak_gram_bwd.cu). Returns the gram and
    (du1, du2, dc1, dc2, dextra, dlogb, dsig2)."""
    D = u1.shape[0]
    bEs = [torch.exp(logb[d] - (u1[d, :, None] - u2[d, None, :]) ** 2) for d in range(D)]
    grams = [bEs[d] - c1[d, :, None] * c2[d, None, :] for d in range(D)] + list(extra)
    P = og.clamped_depth(depth, D, extra.shape[0])
    e = [torch.ones_like(gbar)] + [torch.zeros_like(gbar) for _ in range(P)]
    for g in grams:
        for k in range(P, 0, -1):
            e[k] = e[k] + g * e[k - 1]
    out = sum(sig2[n] * e[n] for n in range(P + 1))
    a = [gbar * sum(sig2[n] * e[n - 1 - m] for n in range(m + 1, P + 1)) for m in range(P)]

    def T_of(g):
        t = a[P - 1]
        for m in range(P - 2, -1, -1):
            t = t * -g + a[m]
        return t

    Ts = [T_of(g) for g in grams]
    du = [u1[d, :, None] - u2[d, None, :] for d in range(D)]
    dsig2 = torch.stack([torch.sum(gbar * e[n]) if n <= P else torch.zeros(())
                         for n in range(depth + 1)])
    return out, (torch.stack([-2.0 * (Ts[d] * bEs[d] * du[d]).sum(1) for d in range(D)]),
                 torch.stack([2.0 * (Ts[d] * bEs[d] * du[d]).sum(0) for d in range(D)]),
                 torch.stack([-(Ts[d] * c2[d, None, :]).sum(1) for d in range(D)]),
                 torch.stack([-(Ts[d] * c1[d, :, None]).sum(0) for d in range(D)]),
                 torch.stack(Ts[D:]) if extra.shape[0] else torch.zeros_like(extra),
                 torch.stack([(Ts[d] * bEs[d]).sum() for d in range(D)]), dsig2)


@pytest.mark.parametrize("D,E,depth", [(5, 0, 3), (4, 2, 3), (5, 1, 9)],
                         ids=["rbf", "mixed", "deep clamped"])
def test_kernel_arithmetic_matches_jax(D, E, depth):
    """What the CUDA kernels compute, in float64 on the CPU: the gram
    against oak_tpu's XLA reference and every cotangent against the plain
    backward (itself held to autograd and oak_tpu above), rel 1e-10; depth
    9 over 6 grams runs clamped to 6."""
    rng = np.random.default_rng(78 + D + E)
    a = _prescaled(rng, D=D, N=11, M=9, E=E, depth=depth)
    args = _torch_args(a)
    gbar = torch.as_tensor(rng.normal(size=(11, 9)))
    out, grads = _kernel_arithmetic(*args, gbar, depth)
    _close(out, ogp._xla_gram_from_prep(*_jax_args(a), depth))
    for name, o, r in zip(_NAMES, grads, og.oak_gram_bwd_plain(*args, gbar, depth)):
        assert o.shape == r.shape, name
        if r.numel():
            _close(o, r.numpy())


def test_bwd_plain_matches_pallas_interpret():
    """oak_gram_bwd_plain in f32 against the Pallas backward kernel
    (_pallas_gram_bwd) on the same prescaled arrays in interpret mode: one
    128 x 256 shape, all-RBF, D = 5, depth 3. rtol 5e-4 of each output's
    largest magnitude (tests/test_pallas_gram.py's gradient bound): the f32
    sums run in a different order."""
    rng = np.random.default_rng(72)
    a = _prescaled(rng, D=5, N=128, M=256, E=0, depth=3)
    a = {k: v.astype(np.float32) for k, v in a.items()}
    gbar = rng.normal(size=(128, 256)).astype(np.float32)
    j = _jax_args(a)
    with pltpu.force_tpu_interpret_mode():
        ref = ogp._pallas_gram_bwd(j[0], j[1], j[2], j[3], j[5], j[6],
                                   jnp.asarray(gbar), 3)
    du1, du2, dc1, dc2, _, dlogb, dsig2 = og.oak_gram_bwd_plain(
        *_torch_args(a, torch.float32), torch.as_tensor(gbar), 3)
    for name, o, r in zip(("du1", "du2", "dc1", "dc2", "dlogb", "dsig2"),
                          (du1, du2, dc1, dc2, dlogb[None], dsig2[None]), ref):
        assert o.dtype == torch.float32, name
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=5e-4,
                                   atol=5e-4 * np.abs(r).max(), err_msg=name)


def test_bwd_plain_dextra_matches_res_bwd():
    """All seven cotangents against oak_tpu's stored-gram backward
    ``_res_bwd``, which covers the extra grams. Inputs are float64, but
    ``_res_bwd`` rounds the stored grams to float32 before it uses them, so
    the bound is 1e-5 of the largest magnitude, not 1e-10."""
    rng = np.random.default_rng(73)
    a = _prescaled(rng, D=4, N=10, M=8, E=2, depth=3)
    gbar = rng.normal(size=(10, 8))
    j = _jax_args(a)
    _, gs = ogp._xla_gram_and_gs(*j, 3, res_dtype=jnp.float64)
    ref = ogp._res_bwd(3, (*j, gs), jnp.asarray(gbar))
    ours = og.oak_gram_bwd_plain(*_torch_args(a), torch.as_tensor(gbar), 3)
    for name, o, r in zip(_NAMES, ours, ref):
        _close(o.reshape(np.shape(r)), r, rel=1e-5)


def test_fused_function_on_cpu_matches_plain_autograd():
    """FusedGram on CPU tensors (plain forward, written-out backward) gives
    plain autograd's gradients, and None for the inputs that need none."""
    a = _prescaled(np.random.default_rng(74), D=4, N=9, M=7, E=2, depth=3)
    args = _torch_args(a)
    wants = [True, True, True, True, False, True, True]
    leaves = [t.clone().requires_grad_(w) for t, w in zip(args, wants)]
    out = og.FusedGram.apply(*leaves, 3)
    gbar = torch.as_tensor(np.random.default_rng(75).normal(size=(9, 7)))
    grads = og.FusedGram.backward(_Ctx(leaves, wants), gbar)
    assert grads[4] is None and grads[7] is None
    refs = [t.clone().requires_grad_(w) for t, w in zip(args, wants)]
    ref = og.oak_gram_plain(*refs, 3)
    _close(out, ref.detach().numpy())
    got = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], gbar)
    want = torch.autograd.grad(ref, [t for t in refs if t.requires_grad], gbar)
    for g, r in zip(got, want):
        _close(g, r.numpy())


class _Ctx:
    """A stand-in for autograd's ctx, to read FusedGram.backward's outputs
    for inputs that need no gradient."""

    def __init__(self, saved, needs):
        self.saved_tensors = tuple(t.detach() for t in saved)
        self.needs_input_grad = tuple(needs) + (False,)
        self.depth = 3


def test_bwd_wrapper_takes_plain_route_on_cpu():
    a = _prescaled(np.random.default_rng(76), D=3, N=6, M=5, E=1, depth=2)
    gbar = torch.as_tensor(np.random.default_rng(77).normal(size=(6, 5)))
    with profiling.recording():
        full = og.oak_gram_bwd(*_torch_args(a), gbar, 2)
        without = og.oak_gram_bwd(*_torch_args(a), gbar, 2, with_dextra=False)
    assert counted("k2.launches") == 0
    assert without[4] is None and full[4].shape == (1, 6, 5)
    for f, w in zip(full[:4] + full[5:], without[:4] + without[5:]):
        _close(w, f.numpy())
