"""The reference-named surface (``oak_tpu.compat``): every public function of
the reference package (amzn/orthogonal-additive-gaussian-processes) under its
name and signature, for code written against it. The port's own modules
(``sobol``, ``checkpoint``, ``params``, ``flows``, ``legacy``) stay the
primary surface; these are thin wrappers over them, and they keep the
reference's quirks that ``oak_tpu.compat`` keeps (noted per function).

The reference's signatures name no dtype or device. What these functions
build is built where ``config.resolve`` says (float32 on the card), or in
the dtype and on the device of the model, kernel or measure they are given;
numpy comes back where the reference returns numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from . import sobol as _sobol
from .checkpoint import _slot_param, load_reference_npz, reference_param_order
from .config import like, resolve
from .kernels import OrthogonalBinary, OrthogonalCategorical
from .params import bounded as _bounded


def _column(X, dim: int, like_module=None) -> torch.Tensor:
    """Column ``dim`` of X as a tensor, in ``like_module``'s dtype and on its
    device, or ``config.resolve``'s."""
    dtype, device = like(like_module) if like_module is not None else resolve()
    X = X.detach() if isinstance(X, torch.Tensor) else torch.as_tensor(np.asarray(X))
    return X[:, dim].to(dtype=dtype, device=device)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------- #
# utils.py names
# --------------------------------------------------------------------------- #
def compute_L(X, lengthscale, variance, dim, delta, mu) -> np.ndarray:
    """Reference utils.py:221-240: the Gaussian-measure L matrix of column
    ``dim`` of X (f1 - f2 - f3 + f4)."""
    x = _column(X, dim)
    kw = dict(dtype=x.dtype, device=x.device)
    args = [torch.as_tensor(v, **kw) for v in (lengthscale, variance, delta, mu)]
    return _host(_sobol.compute_L_gaussian(x, *args))


def compute_L_binary_kernel(X, p0, variance, dim) -> np.ndarray:
    """Reference utils.py:243-272. Like the reference (and ``oak_tpu``), it
    scales by the variance to the FIRST power, where every other L scales
    by v²; ``sobol.compute_L_binary`` is the consistent one."""
    assert 0 <= p0 <= 1
    k = OrthogonalBinary.create(p0=p0, variance=1.0)
    return float(variance) * _host(_sobol.compute_L_binary(k, _column(X, dim, k)))


def compute_L_categorical_kernel(X, W, kappa, p, variance, dim) -> np.ndarray:
    """Reference utils.py:275-309."""
    W = _host(W)
    k = OrthogonalCategorical.create(p=_host(p).reshape(-1), rank=W.shape[1],
                                     variance=variance)
    k.W.assign(torch.as_tensor(W))
    k.kappa.assign(torch.as_tensor(_host(kappa)))
    return _host(_sobol.compute_L_categorical(k, _column(X, dim, k)))


def compute_L_empirical_measure(x, w, kernel, z) -> np.ndarray:
    """Reference utils.py:312-335: L = (w ∘ Kxuᵀ) Kxu over the empirical
    locations ``x`` with weights ``w``, at data or inducing inputs ``z``."""
    from .kernels import ortho_rbf

    def flat(a):
        return _column(np.asarray(_host(a)).reshape(-1, 1), 0, kernel)

    loc, wt = flat(x), flat(w)
    kxu = ortho_rbf.K(kernel, loc, flat(z))
    return _host((wt[:, None] * kxu).T @ kxu)


def get_model_sufficient_statistics(m, get_L: bool = True):
    """Reference utils.py:168-218: the posterior weights alpha (a tensor on
    the model's device), and with ``get_L`` the Cholesky factor L (numpy)
    with L Lᵀ = Qinv⁻¹, i.e. chol(K + σ²I) for GPR and its counterpart for
    SGPR and SVGP posteriors."""
    alpha, Qinv = m.posterior_stats()
    if not get_L:
        return alpha
    L = np.linalg.cholesky(np.linalg.inv(_host(Qinv)))
    return alpha, L


# --------------------------------------------------------------------------- #
# model_utils.py names
# --------------------------------------------------------------------------- #
def save_model(model, filename) -> None:
    """Write a checkpoint in the reference's positional layout
    (model_utils.py:44-64: ``np.savez(filename, hyperparams=[constrained
    values])``, SVGP saving every parameter), which the reference, ``oak_tpu``
    and ``load_model`` / ``checkpoint.load_reference_npz`` read."""
    import os

    vals = [_host(_slot_param(model, s).value) for s in reference_param_order(model)]
    d = os.path.dirname(str(filename))
    if d:
        os.makedirs(d, exist_ok=True)
    np.savez(filename, hyperparams=np.asarray(vals, dtype=object))


def load_model(model, filename, load_all_parameters: bool = False):
    """Reference model_utils.py:67-87: fills ``model`` in place, as the
    reference does, and also returns it, as ``oak_tpu``'s does. The model
    type decides which parameters the file holds (SVGP checkpoints carry
    them all), so ``load_all_parameters`` is not read."""
    del load_all_parameters
    return load_reference_npz(model, filename)


def bounded_param(low: float, high: float, param):
    """Reference oak_kernel.py:24-33: a sigmoid-bounded parameter."""
    return _bounded(low, high, param)


def _calculate_features(X, categorical_feature=None, binary_feature=None):
    """Reference model_utils.py:703-750 (private helper name)."""
    from .preprocessing import calculate_features

    return calculate_features(X, categorical_feature, binary_feature)


# --------------------------------------------------------------------------- #
# normalising_flow.py names
# --------------------------------------------------------------------------- #
def make_sinharcsinh():
    """Reference normalising_flow.py:16-20: a SinhArcsinh bijector with
    trainable skewness and tailweight, as its two Params and a forward
    callable (the port composes flows inside ``Normalizer``; this is for
    reference-shaped code)."""
    from .bijectors import Exp
    from .params import param

    skewness = param(0.0)
    tailweight = param(1.0, Exp())

    def forward(x, skewness=skewness, tailweight=tailweight):
        x = torch.as_tensor(x, dtype=skewness.raw.dtype, device=skewness.raw.device)
        return torch.sinh((torch.asinh(x) + skewness.value) * tailweight.value)

    return {"skewness": skewness, "tailweight": tailweight, "forward": forward}


def make_standardizer(x):
    """Reference normalising_flow.py:23-27: shift then scale, with trainable
    parameters initialised from the data's moments."""
    from .bijectors import Exp
    from .params import param

    x = np.asarray(_host(x), np.float64)
    scale = param(1.0 / np.std(x), Exp())
    shift = param(-np.mean(x))

    def forward(v, scale=scale, shift=shift):
        # tfb.Chain([Scale, Shift]) applies Shift first: (x - mean) / std
        v = torch.as_tensor(v, dtype=scale.raw.dtype, device=scale.raw.device)
        return (v + shift.value) * scale.value

    return {"scale": scale, "shift": shift, "forward": forward}


# --------------------------------------------------------------------------- #
# utils.py names: Sobol, components, the legacy representation, k-means
# --------------------------------------------------------------------------- #
def compute_sobol_oak(model, delta: float, mu: float, share_var_across_orders=True):
    """Reference utils.py:338-435: (tuples, Sobol values). The kernels carry
    their measure, so ``delta`` (a standard deviation) and ``mu`` are checked
    against it, and a differing override raises NotImplementedError (the
    reference's callers pass the fixed delta=1, mu=0 of oak_kernel.py:84)."""
    del share_var_across_orders  # the kernel says it
    return _sobol.compute_sobol_oak(model, delta=delta, mu=mu)


def get_prediction_component(m, alpha, X=None, share_var_across_orders=True):
    """Reference utils.py:491-530: the per-component predictive means [C, N]."""
    del share_var_across_orders
    return _sobol.get_prediction_component(m, alpha=alpha, X=X)


def compute_sobol(model, kernel_list, delta, mu, alpha, sparse_gp: bool = True):
    """Reference utils.py:438-488, the legacy (Duvenaud) representation: the
    Sobol index of each explicit product kernel, eq (40). ``delta`` / ``mu``
    define the Gaussian Sobol measure of every Gaussian-measure factor, as
    in the reference (utils.py:478); they may differ from the kernels' own
    measures. An empirical-measure factor integrates under its own measure,
    where the reference would apply the Gaussian closed form (a documented
    deviation, PARITY_NOTES.md)."""
    from .legacy import compute_sobol as _compute

    X = model.Z.value if sparse_gp else model.data[0]
    return _compute(X, kernel_list, alpha, delta=delta, mu=mu)


def _kernel_list(model):
    return model if isinstance(model, (list, tuple)) else model.kernel.kernels


def model_to_kernel_list(model, selected_dims):
    """Reference utils.py:32-42. Takes a legacy kernel list, or a model-like
    object carrying one in ``.kernel.kernels``."""
    from .legacy import model_to_kernel_list as _f

    return _f(_kernel_list(model), selected_dims)


def extract_active_dims(m):
    """Reference utils.py:45-60, on a kernel list or a model carrying one."""
    from .legacy import extract_active_dims as _f

    return _f(_kernel_list(m))


def grammer_to_kernel(selected_dims, offset, measure=None,
                      lengthscales_lo=1e-3, lengthscales_hi=100,
                      variance_lo=0.01, variance_hi=100):
    """Reference utils.py:63-113: product kernels with random bounded
    hyperparameters."""
    from .legacy import grammer_to_kernel as _f

    return _f(selected_dims, offset, measure=measure,
              lengthscales_lo=lengthscales_lo, lengthscales_hi=lengthscales_hi,
              variance_lo=variance_lo, variance_hi=variance_hi)


def initialize_kmeans_with_binary(X, binary_index, continuous_index=None, n_clusters=200):
    """Reference utils.py:533-552."""
    from .preprocessing import initialize_kmeans_with_binary as _f

    return _f(np.asarray(X), binary_index, continuous_index, n_clusters)


def initialize_kmeans_with_categorical(X, binary_index, categorical_index,
                                       continuous_index, n_clusters=200):
    """Reference utils.py:555-574."""
    from .preprocessing import initialize_kmeans_with_categorical as _f

    return _f(np.asarray(X), binary_index, categorical_index, continuous_index, n_clusters)


# --------------------------------------------------------------------------- #
# model_utils.py names: helpers
# --------------------------------------------------------------------------- #
def get_kmeans_centers(X, K: int = 500):
    """Reference model_utils.py:31-41."""
    from .preprocessing import get_kmeans_centers as _f

    return _f(np.asarray(X), K)


def estimate_one_dim_gmm(K: int, X):
    """Reference model_utils.py:753-770: a spherical GMM as a MOGMeasure."""
    from .preprocessing import estimate_one_dim_gmm as _f

    return _f(K, np.asarray(X))


def apply_normalise_flow(X, input_flows):
    """Reference model_utils.py:179-191: the per-dim flows."""
    from .model import apply_normalise_flow as _f

    return _f(X, input_flows)


def get_list_representation(kernel, num_dims, share_var_across_orders=True):
    """Reference oak_kernel.py:338-364."""
    from .kernels.oak_kernel import get_list_representation as _f

    return _f(kernel, num_dims, share_var_across_orders)


def print_summary(module, fmt: str = "simple") -> None:
    """``gpflow.utilities.print_summary``, which the reference calls around
    optimisation (model_utils.py:174,416,426): the parameter table of a
    model or kernel. ``fmt`` is accepted; every format prints the same
    table."""
    from .utils.summary import print_summary as _f

    _f(module, fmt=fmt)


# --------------------------------------------------------------------------- #
# Class names: input_measures.py, the kernels, normalising_flow.py. The
# factories take the reference classes' constructor arguments and return the
# port's classes (isinstance checks go against oak_tpu_torch.measures and
# oak_tpu_torch.kernels).
# --------------------------------------------------------------------------- #
from .measures import Measure  # noqa: F401,E402  (input_measures.py:16)


def UniformMeasure(a, b):
    """Reference input_measures.py:20-28."""
    from .measures import UniformMeasure as _M

    return _M.create(a, b)


def GaussianMeasure(mu, var):
    """Reference input_measures.py:31-39."""
    from .measures import GaussianMeasure as _M

    return _M.create(mu, var)


def EmpiricalMeasure(location, weights=None):
    """Reference input_measures.py:42-56: uniform weights by default, and
    weights that do not sum to 1 raise (input_measures.py:53)."""
    from .measures import EmpiricalMeasure as _M

    return _M.create(_host(location), None if weights is None else _host(weights))


def MOGMeasure(means, variances, weights):
    """Reference input_measures.py:59-78."""
    from .measures import MOGMeasure as _M

    return _M.create(_host(means), _host(variances), _host(weights))


class RBF:
    """Stand-in for ``gpflow.kernels.RBF`` as ``OrthogonalRBFKernel``'s
    ``base_kernel``, which the reference builds only to carry the initial
    lengthscale and variance (ortho_rbf_kernel.py:28-35)."""

    def __init__(self, variance=1.0, lengthscales=1.0, active_dims=None):
        self.variance = variance
        self.lengthscales = lengthscales
        self.active_dims = active_dims


def _active_dim(active_dims) -> int:
    if active_dims is None:
        return 0
    if isinstance(active_dims, (list, tuple, np.ndarray)):
        (dim,) = np.asarray(active_dims).reshape(-1).tolist()
        return int(dim)
    return int(active_dims)


def OrthogonalRBFKernel(base_kernel, measure, active_dims=None):
    """Reference ortho_rbf_kernel.py:20-45 -> ``OrthogonalRBF``, built in the
    measure's dtype and on its device. ``base_kernel`` gives the initial
    lengthscale and variance; any base but an RBF raises
    NotImplementedError, as the reference's check does
    (ortho_rbf_kernel.py:34-35)."""
    from . import measures as _measures
    from .kernels import OrthogonalRBF

    if not isinstance(measure, (_measures.UniformMeasure, _measures.GaussianMeasure,
                                _measures.EmpiricalMeasure, _measures.MOGMeasure)):
        raise NotImplementedError(f"unsupported measure {type(measure).__name__}")
    if base_kernel is None:
        ls, var = 1.0, 1.0
    else:
        # a Matern-shaped object with .lengthscales and .variance is not
        # taken for an RBF on a surface that claims the reference's behaviour
        if not (isinstance(base_kernel, RBF) or type(base_kernel).__name__ == "RBF"):
            raise NotImplementedError(
                f"base_kernel must be an RBF kernel (got {type(base_kernel).__name__}); "
                "the reference supports no other base (ortho_rbf_kernel.py:34-35)")
        ls = float(np.asarray(_host(base_kernel.lengthscales)))
        var = float(np.asarray(_host(base_kernel.variance)))
    return OrthogonalRBF.create(measure, lengthscale=ls, variance=var,
                                active_dim=_active_dim(active_dims))


def OAKKernel(base_kernels, num_dims, max_interaction_depth,
              active_dims=None, constrain_orthogonal=False, p0=None, p=None,
              lengthscale_bounds=None, empirical_locations=None,
              empirical_weights=None, gmm_measures=None,
              share_var_across_orders=True):
    """Reference oak_kernel.py:59-103 -> ``OAKKernel``. ``base_kernels`` (a
    list of kernel classes, which the reference deletes after its
    constructor, oak_kernel.py:88-91) is accepted and not read: the
    continuous base is always RBF, the only one the reference supports."""
    del base_kernels
    from .kernels import OAKKernel as _OAKKernel

    return _OAKKernel.create(
        num_dims=num_dims, max_interaction_depth=max_interaction_depth,
        active_dims=active_dims, constrain_orthogonal=constrain_orthogonal,
        p0=p0, p=p, lengthscale_bounds=lengthscale_bounds,
        empirical_locations=empirical_locations, empirical_weights=empirical_weights,
        gmm_measures=gmm_measures, share_var_across_orders=share_var_across_orders)


def Normalizer(x, log=True, **kwargs):
    """Reference normalising_flow.py:30-56 -> ``flows.Normalizer`` (the
    SinhArcsinh, affine and optional log chain, with ``KL_objective``,
    ``kstest`` and ``plot``). ``**kwargs`` (GPflow's module naming) are
    accepted and not read."""
    del kwargs
    from .flows import Normalizer as _Normalizer

    return _Normalizer.create(np.asarray(_host(x)), log=log)


def _closed_form(f):
    """A sobol.f1..f4 that also takes numbers, as the reference's do: they
    become tensors of the first tensor argument's dtype and device, or of
    ``config.resolve``'s."""
    def g(x, y, sigma, l, delta, mu):
        args = (x, y, sigma, l, delta, mu)
        t = next((a for a in args if isinstance(a, torch.Tensor)), None)
        dtype, device = (t.dtype, t.device) if t is not None else resolve()
        return f(*(torch.as_tensor(a, dtype=dtype, device=device) for a in args))

    g.__name__ = f.__name__
    g.__doc__ = f"The closed-form Sobol integral ``sobol.{f.__name__}`` (utils.py:116-165)."
    return g


f1 = _closed_form(_sobol.f1)
f2 = _closed_form(_sobol.f2)
f3 = _closed_form(_sobol.f3)
f4 = _closed_form(_sobol.f4)

# Names resolved on first use, so that importing this module imports neither
# matplotlib (plotting) nor the oak_model stack.
_LAZY = {
    "oak_model": ".model",             # model_utils.py:194
    "create_model_oak": ".model",      # model_utils.py:90
    "KernelComponenent": ".kernels.oak_kernel",  # oak_kernel.py:281 [sic]
    "KernelComponent": ".kernels.oak_kernel",    # the corrected spelling
    "FigureDescription": ".plotting",            # plotting_utils.py:19
    "save_fig_list": ".plotting",                # plotting_utils.py:25
    "plot_single_effect": ".plotting",           # plotting_utils.py:36
    "plot_second_order": ".plotting",            # plotting_utils.py:218
    "plot_single_effect_binary": ".plotting",    # plotting_utils.py:378
    "plot_second_order_binary": ".plotting",     # plotting_utils.py:456
    "plot_single_effect_categorical": ".plotting",  # plotting_utils.py:602
}


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod, __package__), name)


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
