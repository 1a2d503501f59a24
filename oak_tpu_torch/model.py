"""The user-facing ``oak_model`` (``oak_tpu.model``): the same constructor
arguments and the fit / optimise / predict / get_loglik / get_sobol / save
surface, numpy at the boundary, the port's models underneath.

It builds in float32 on the CUDA card unless ``dtype`` / ``device`` say
otherwise (``config.resolve``). The data move to that device once, when the
model is built; the flows run there too.

``oak_tpu``'s models are immutable, and the port's optimizers write into the
model in place. ``optimise`` therefore copies the untrained model before the
first fit: the retry after a degenerate or pathological L-BFGS fit restarts
from that copy, as ``oak_tpu`` restarts from its untouched ``self.m``.

Not ported here: ``mesh=`` / ``data_mesh=`` (ROADMAP P16), ``export_predict``
(P13) and ``plot`` (P14).
"""

from __future__ import annotations

import copy
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import sobol as sobol_mod
from .config import resolve
from .flows import Normalizer, fit_normalizers
from .kernels import OAKKernel
from .models import GPR, SGPR, SVGP, Bernoulli
from .models.gpr import as_data
from .optim import (fit_adam, fit_adam_multistart, fit_adam_scan, fit_lbfgs,
                    fit_lbfgs_multistart, fit_natgrad_adam, fit_natgrad_multistart,
                    fit_natgrad_scan, fit_scipy)
from .params import flatten_trainable
from .preprocessing import (StandardScaler, calculate_features,
                            empirical_measure_from_column, estimate_one_dim_gmm,
                            get_kmeans_centers, initialize_kmeans_with_categorical)


def create_model_oak(
    data,
    max_interaction_depth: int = 2,
    constrain_orthogonal: bool = True,
    inducing_pts: Optional[np.ndarray] = None,
    optimise: bool = False,
    zfixed: bool = True,
    p0=None,
    p=None,
    lengthscale_bounds=None,
    empirical_locations=None,
    empirical_weights=None,
    use_sparsity_prior: bool = True,
    gmm_measures=None,
    share_var_across_orders: bool = True,
    dtype: Optional[torch.dtype] = None,
    device=None,
):
    """OAK kernel plus GPR (or SGPR when inducing points are given), the
    Gamma(1, 0.2) sparsity prior, likelihood variance 0.01; ``dtype``,
    ``device``: ``config.resolve``."""
    X, Y = data
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    kernel = OAKKernel.create(
        num_dims=X.shape[1],
        max_interaction_depth=max_interaction_depth,
        constrain_orthogonal=constrain_orthogonal,
        p0=p0,
        p=p,
        lengthscale_bounds=lengthscale_bounds,
        empirical_locations=empirical_locations,
        empirical_weights=empirical_weights,
        gmm_measures=gmm_measures,
        share_var_across_orders=share_var_across_orders,
        use_sparsity_prior=use_sparsity_prior and share_var_across_orders,
        dtype=dtype,
        device=device,
    )
    if inducing_pts is not None:
        model = SGPR.create(X, Y, kernel, inducing_pts, noise_variance=0.01,
                            trainable_Z=not zfixed)
    else:
        model = GPR.create(X, Y, kernel, noise_variance=0.01)
    if optimise:
        fit_lbfgs(model, lambda m: m.training_loss())
    return model


@torch.no_grad()
def _apply_flow(flow: Normalizer, x: np.ndarray) -> np.ndarray:
    return flow.forward(flow.as_input(x)).cpu().numpy().astype(np.float64)


def apply_normalise_flow(X, input_flows) -> np.ndarray:
    """Apply the per-dim flows (on their device); dims with no flow pass
    through. Numpy float64 in and out."""
    X = np.array(X, np.float64, copy=True)
    for i, flow in enumerate(input_flows):
        if flow is not None:
            X[:, i] = _apply_flow(flow, X[:, i])
    return X


def _host_values(params) -> List[float]:
    """The constrained values of 0-d Params, in one transfer."""
    with torch.no_grad():
        return torch.stack([p.value.reshape(()) for p in params]).double().cpu().tolist()


class oak_model:
    def __init__(
        self,
        max_interaction_depth: int = 2,
        num_inducing: int = 200,
        lengthscale_bounds: Optional[Sequence[float]] = (1e-3, 1e3),
        binary_feature: Optional[List[int]] = None,
        categorical_feature: Optional[List[int]] = None,
        empirical_measure: Optional[List[int]] = None,
        use_sparsity_prior: bool = True,
        gmm_measure: Optional[List[int]] = None,
        sparse: bool = False,
        use_normalising_flow: bool = True,
        share_var_across_orders: bool = True,
        likelihood: str = "gaussian",
        optimizer: str = "lbfgs",
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        """``oak_tpu``'s constructor arguments, plus ``dtype`` and ``device``
        (float32 on the CUDA card when None, ``config.resolve``)."""
        self.max_interaction_depth = max_interaction_depth
        self.num_inducing = num_inducing
        self.lengthscale_bounds = list(lengthscale_bounds) if lengthscale_bounds else None
        self.binary_feature = binary_feature
        self.categorical_feature = categorical_feature
        self.use_sparsity_prior = use_sparsity_prior
        self.empirical_measure = empirical_measure
        self.gmm_measure = gmm_measure
        self.sparse = sparse
        self.use_normalising_flow = use_normalising_flow
        self.share_var_across_orders = share_var_across_orders
        self.likelihood = likelihood
        self.optimizer = optimizer
        self.dtype, self.device = resolve(dtype, device)

        # state filled during fit
        self.m = None
        self.input_flows: Optional[List[Optional[Normalizer]]] = None
        self.scaler_y: Optional[StandardScaler] = None
        self.scaler_X_empirical: Optional[StandardScaler] = None
        self.scaler_X_continuous: Optional[StandardScaler] = None
        self.estimated_gmm_measures = None
        self.empirical_locations = None
        self.empirical_weights = None
        self.continuous_index = None
        self.binary_index = None
        self.categorical_index = None
        self.alpha = None
        self.normalised_sobols = None
        self.tuple_of_indices = None
        self.timings = {}

    # ------------------------------------------------------------------ #
    def _kw(self):
        return dict(dtype=self.dtype, device=self.device)

    def fit(self, X, Y, optimise: bool = True, initialise_inducing_points: bool = True,
            restarts: int = 0) -> "oak_model":
        """Classify the features, estimate GMM measures, fit the flows, scale,
        place the inducing points and build GPR (N <= 1000), SGPR (N > 1000
        or ``sparse``) or the Bernoulli SVGP; then ``optimise(restarts=)``
        when ``optimise``. ``timings`` records the seconds of the set-up, the
        flows and k-means."""
        t0 = time.time()
        X = np.asarray(X, np.float64)
        Y = np.asarray(Y, np.float64)
        if Y.ndim == 1:
            Y = Y.reshape(-1, 1)
        self.xmin, self.xmax = X.min(0), X.max(0)
        self.num_dims = X.shape[1]

        (self.continuous_index, self.binary_index, self.categorical_index,
         p0, p) = calculate_features(X, self.categorical_feature, self.binary_feature)

        if self.empirical_measure is not None:
            if not set(self.empirical_measure).issubset(self.continuous_index):
                raise ValueError(
                    f"Empirical measure={self.empirical_measure} should only be "
                    f"used on non-binary/categorical inputs {self.continuous_index}")
        if self.gmm_measure is not None:
            if len(self.gmm_measure) != self.num_dims:
                raise ValueError(
                    f"Must specify number of GMM components for each of the "
                    f"{self.num_dims} input dimensions")
            idx_gmm = np.flatnonzero(self.gmm_measure)
            if not set(idx_gmm).issubset(self.continuous_index):
                raise ValueError(
                    f"GMM measure on inputs {idx_gmm} should only be used on "
                    f"continuous inputs {self.continuous_index}")

        self.estimated_gmm_measures = [None] * self.num_dims
        if self.gmm_measure is not None:
            for i in np.flatnonzero(self.gmm_measure):
                self.estimated_gmm_measures[i] = estimate_one_dim_gmm(
                    K=int(self.gmm_measure[i]), X=X[:, i], **self._kw())

        # normalising flows per continuous dim, all fitted in one L-BFGS run
        t = time.time()
        self.input_flows = [None] * self.num_dims
        if self.use_normalising_flow:
            flow_dims = [
                i for i in self.continuous_index
                if not (self.empirical_measure is not None and i in self.empirical_measure)
                and self.estimated_gmm_measures[i] is None]
            if flow_dims:
                for i, flow in zip(flow_dims, fit_normalizers(X[:, flow_dims], **self._kw())):
                    self.input_flows[i] = flow
        self.timings["flows"] = time.time() - t

        # output scaling and optional input standardisation; classification
        # labels stay raw {0, 1}
        self.alpha = None
        if self.likelihood == "bernoulli":
            self.scaler_y = StandardScaler()
            self.scaler_y.mean_ = np.zeros(Y.shape[1])
            self.scaler_y.scale_ = np.ones(Y.shape[1])
        else:
            self.scaler_y = StandardScaler().fit(Y)
        self.Y_scaled = self.scaler_y.transform(Y)
        if self.empirical_measure is not None:
            self.scaler_X_empirical = StandardScaler().fit(X[:, self.empirical_measure])
        if not self.use_normalising_flow:
            self.scaler_X_continuous = StandardScaler().fit(X[:, self.continuous_index])
        self.X_scaled = self._transform_x(X)

        self.empirical_locations = [None] * self.num_dims
        self.empirical_weights = [None] * self.num_dims
        if self.empirical_measure is not None:
            for i in self.empirical_measure:
                loc, w = empirical_measure_from_column(self.X_scaled[:, i])
                self.empirical_locations[i] = loc
                self.empirical_weights[i] = w

        # the flows must not have touched discrete dims
        assert np.allclose(self.X_scaled[:, self.binary_index],
                           X[:, self.binary_index]), "Flow applied to binary inputs"
        assert np.allclose(self.X_scaled[:, self.categorical_index],
                           X[:, self.categorical_index]), "Flow applied to categorical inputs"

        t = time.time()
        Z = None
        if X.shape[0] > 1000 or self.sparse or self.likelihood == "bernoulli":
            if initialise_inducing_points:
                n_clusters = min(self.num_inducing, X.shape[0])
                if (p0 is None) and (p is None):
                    Z = get_kmeans_centers(self.X_scaled, n_clusters)
                else:
                    Z = initialize_kmeans_with_categorical(
                        self.X_scaled, binary_index=self.binary_index,
                        categorical_index=self.categorical_index,
                        continuous_index=self.continuous_index, n_clusters=n_clusters)
            else:
                Z = self.X_scaled[: self.num_inducing, :]
        self.timings["kmeans"] = time.time() - t

        kernel = OAKKernel.create(
            num_dims=self.num_dims,
            max_interaction_depth=self.max_interaction_depth,
            p0=p0,
            p=p,
            lengthscale_bounds=self.lengthscale_bounds,
            empirical_locations=self.empirical_locations,
            empirical_weights=self.empirical_weights,
            gmm_measures=self.estimated_gmm_measures,
            share_var_across_orders=self.share_var_across_orders,
            use_sparsity_prior=self.use_sparsity_prior and self.share_var_across_orders,
            **self._kw(),
        )
        if self.likelihood == "bernoulli":
            self._train_data = (self.X_scaled, self.Y_scaled)
        self.m = self._build_model(kernel, Z)
        self.timings["fit_setup"] = time.time() - t0
        if optimise:
            self.optimise(restarts=restarts)
        return self

    def _build_model(self, kernel: OAKKernel, Z, q_diag: Optional[bool] = None,
                     whiten: bool = True):
        """The Bernoulli SVGP (Z defaults to every point), SGPR (with Z) or
        GPR on the scaled data; the SVGP's training data (``_train_data``)
        go to the device here, once."""
        if self.likelihood == "bernoulli":
            # mean-field q, except under natgrad, whose steps diverge on a
            # mean-field q at scale (optim/natgrad.py)
            self._train_tensors = as_data(*self._train_data, self.dtype, self.device)
            return SVGP.create(kernel, Bernoulli.create("logit"),
                               self.X_scaled if Z is None else Z,
                               q_diag=(self.optimizer != "natgrad") if q_diag is None
                               else q_diag,
                               whiten=whiten, num_data=self.X_scaled.shape[0])
        if Z is not None:
            return SGPR.create(self.X_scaled, self.Y_scaled, kernel, Z, noise_variance=0.01)
        return GPR.create(self.X_scaled, self.Y_scaled, kernel, noise_variance=0.01)

    # ------------------------------------------------------------------ #
    def _loss_fn(self):
        if isinstance(self.m, SVGP):
            X, Y = self._train_tensors
            return lambda m: m.training_loss(X, Y)
        return lambda m: m.training_loss()

    def optimise(self, max_iters: int = 1000, compile: bool = True, restarts: int = 0,
                 checkpoint_path=None, checkpoint_every: int = 100, verbose: bool = False):
        """Train ``self.m`` with the constructor's optimizer: 'lbfgs'
        (default), 'scipy' (BFGS on the host; ``compile`` is accepted and
        does nothing, the port is eager), 'adam' or 'natgrad' (SVGP only).

        ``restarts > 0`` runs that many jittered starts (``optim.multistart``)
        and keeps the best accepted fit; with L-BFGS every start first takes
        300 Adam steps at lr 2e-2, as an SVGP's single start does. A single
        L-BFGS fit that lands in the all-noise optimum or a numerically broken
        state is retried from the untrained parameters by a 2-start
        multistart, and the better fit kept.

        ``checkpoint_path``: training state written every
        ``checkpoint_every`` iterations (L-BFGS, multistart included, Adam,
        natgrad); a rerun resumes to the same trajectory. Not with 'scipy'.
        ``verbose`` prints the parameter table before and after."""
        if verbose:
            print("Model prior to optimisation")
            print(self.summary())
        t0 = time.time()
        self.alpha = None
        loss = self._loss_fn()
        if restarts > 0 and self.optimizer == "scipy":
            raise ValueError("restarts > 0 requires an on-device optimizer "
                             "(lbfgs/adam/natgrad); optimizer='scipy' is a "
                             "host loop and cannot run batched lanes")
        if checkpoint_path is not None and self.optimizer == "scipy":
            raise ValueError("checkpoint_path is not supported with "
                             "optimizer='scipy' (scipy owns the BFGS state)")

        def accept(m) -> bool:
            return not (self._degenerate_noise_fit(m) or self._pathological_fit(m))

        if self.optimizer == "scipy":
            res = fit_scipy(self.m, loss, method="BFGS", max_iters=max_iters, jit=compile)
        elif self.optimizer == "adam":
            if restarts > 0:
                res = fit_adam_multistart(self.m, loss, n_starts=restarts, jitter=0.3,
                                          seed=0, steps=max_iters, include_init=True,
                                          accept_fn=accept)
            elif checkpoint_path is not None:
                res = fit_adam_scan(self.m, loss, steps=max_iters,
                                    checkpoint_path=checkpoint_path,
                                    checkpoint_every=checkpoint_every)
            else:
                res = fit_adam(self.m, loss, steps=max_iters)
        elif self.optimizer == "natgrad":
            if not isinstance(self.m, SVGP):
                raise ValueError("optimizer='natgrad' requires an SVGP model "
                                 "(likelihood='bernoulli' or sparse SVGP)")
            gamma = 1.0 if not isinstance(self.m.likelihood, Bernoulli) else 0.2
            if restarts > 0:
                res = fit_natgrad_multistart(self.m, loss, n_starts=restarts, jitter=0.3,
                                             seed=0, steps=max_iters, gamma=gamma,
                                             include_init=True, accept_fn=accept)
            elif checkpoint_path is not None:
                res = fit_natgrad_scan(self.m, loss, steps=max_iters, gamma=gamma,
                                       checkpoint_path=checkpoint_path,
                                       checkpoint_every=checkpoint_every)
            else:
                res = fit_natgrad_adam(self.m, loss, steps=max_iters, gamma=gamma)
        else:
            res = self._optimise_lbfgs(loss, max_iters, restarts, checkpoint_path,
                                       checkpoint_every)
        self.m = res.model
        self.timings["optimise"] = time.time() - t0
        if verbose:
            print(self.summary())
            print(f"Training took {self.timings['optimise']:.1f} seconds.")
        return res

    def _optimise_lbfgs(self, loss, max_iters, restarts, checkpoint_path, checkpoint_every):
        # the untrained model, which the retry below restarts from: the fits
        # write into self.m in place
        init = copy.deepcopy(self.m)
        is_svgp = isinstance(self.m, SVGP)
        # Adam moves the parameters off the cold start, where the zoom
        # linesearch can stall in f32; an SVGP needs it for q(u), and every
        # lane of an explicit multistart takes it (oak_tpu/model.py:433-443)
        warm_steps = 300 if (is_svgp or restarts > 0) else 0

        def bad_fit(m, fun=0.0) -> bool:
            return self._degenerate_noise_fit(m) or self._pathological_fit(m, fun)

        if restarts > 0:
            return fit_lbfgs_multistart(
                self.m, loss, n_starts=restarts, jitter=0.3, seed=0, max_iters=max_iters,
                warm_adam_steps=warm_steps, include_init=True,
                checkpoint_path=checkpoint_path, accept_fn=lambda m: not bad_fit(m))
        if is_svgp:
            fit_adam(self.m, loss, steps=warm_steps, lr=2e-2)
        res = fit_lbfgs(self.m, loss, max_iters=max_iters, checkpoint_path=checkpoint_path,
                        checkpoint_every=checkpoint_every)
        if bad_fit(res.model, res.fun):
            # the all-noise attractor of the sparsity prior, or interpolation
            # collapse at depth (oak_tpu/model.py:500-518): jittered restarts
            # from the untrained parameters, each warmed by Adam, with their
            # own checkpoint file
            retry = fit_lbfgs_multistart(
                init, loss, n_starts=2, jitter=0.3, seed=0, max_iters=max_iters,
                warm_adam_steps=300, include_init=False,
                checkpoint_path=f"{checkpoint_path}.retry" if checkpoint_path else None,
                accept_fn=lambda m: not bad_fit(m))
            # an all-diverged retry returns the untrained model with fun=inf,
            # which must not replace the trained fit
            if np.isfinite(retry.fun) and (
                    retry.fun < res.fun
                    or (bad_fit(res.model, res.fun) and not bad_fit(retry.model, retry.fun))):
                res = retry
        return res

    def summary(self) -> str:
        """The parameter table of the underlying model
        (``utils.summary.summary_string``)."""
        from .utils.summary import summary_string

        return summary_string(self.m)

    @staticmethod
    def _pathological_fit(model, fun: float = 0.0) -> bool:
        """True when a trained model is numerically broken rather than merely
        degenerate: a non-finite loss or parameters, or interpolation
        collapse (likelihood variance under 1e-7 with the order variances
        summing over 1e4)."""
        if not np.isfinite(fun):
            return True
        if not bool(torch.isfinite(flatten_trainable(model)).all()):
            return True
        if hasattr(model.likelihood, "variance"):
            lik, *variances = _host_values([model.likelihood.variance,
                                             *model.kernel.variances])
            if lik < 1e-7 and sum(variances) > 1e4:
                return True
        return False

    @staticmethod
    def _degenerate_noise_fit(model) -> bool:
        """True when every additive component's variance has collapsed (their
        sum under 1e-4): the targets are standardised, so a healthy fit puts
        O(1) variance somewhere."""
        if not model.kernel.share_var_across_orders:
            return False
        return float(np.sum(_host_values(model.kernel.variances[1:]))) < 1e-4

    def optimise_minibatch(self, batch_size: int = 256, steps: int = 2000,
                           lr: float = 1e-2, seed: int = 0, checkpoint_path=None,
                           checkpoint_every: int = 0, optimizer: Optional[str] = None,
                           gamma: float = 0.1):
        """Minibatched Adam, or natgrad steps on q(u) with Adam(lr) on the
        hyperparameters, on the SVGP's ELBO on one device. The minibatches
        are ``oak_tpu``'s stream (``default_rng(seed).choice`` per step).
        ``optimizer`` None inherits 'adam' / 'natgrad' from the constructor,
        else Adam. ``checkpoint_path`` + ``checkpoint_every``: resumable on
        the same stream."""
        if not isinstance(self.m, SVGP):
            raise ValueError("minibatch training requires likelihood='bernoulli' "
                             "or an SVGP model")
        if optimizer is None:
            optimizer = self.optimizer if self.optimizer in ("adam", "natgrad") else "adam"
        if optimizer not in ("adam", "natgrad"):
            raise ValueError(f"optimizer must be 'adam' or 'natgrad', got {optimizer!r}")
        X, Y = self._train_tensors
        n = X.shape[0]
        rng = np.random.default_rng(seed)
        batch_size = min(batch_size, n)
        idx = torch.as_tensor(np.stack([rng.choice(n, batch_size, replace=False)
                                        for _ in range(steps)]), device=X.device)

        def loss_fn(m, ib):
            return m.training_loss(X[ib], Y[ib])

        t0 = time.time()
        if optimizer == "natgrad":
            res = fit_natgrad_scan(self.m, loss_fn, steps=steps, gamma=gamma, hyper_lr=lr,
                                   batch_args=(idx,), checkpoint_path=checkpoint_path,
                                   checkpoint_every=checkpoint_every)
        else:
            res = fit_adam_scan(self.m, loss_fn, steps=steps, lr=lr, batch_args=(idx,),
                                checkpoint_path=checkpoint_path,
                                checkpoint_every=checkpoint_every)
        self.m = res.model
        self.timings["optimise_minibatch"] = time.time() - t0
        return res

    # ------------------------------------------------------------------ #
    def _tensor(self, A) -> torch.Tensor:
        return torch.as_tensor(np.asarray(A, np.float64), dtype=self.dtype,
                               device=self.device)

    def _scaled_input(self, X, clip: bool) -> np.ndarray:
        return self._transform_x(np.clip(X, self.xmin, self.xmax) if clip
                                 else np.asarray(X, np.float64))

    def _is_bernoulli(self) -> bool:
        return isinstance(self.m, SVGP) and isinstance(self.m.likelihood, Bernoulli)

    def _scale_y_inverse(self, y):
        return self.scaler_y.inverse_transform(np.asarray(y))

    @torch.no_grad()
    def predict(self, X, clip: bool = False) -> np.ndarray:
        X_scaled = self._scaled_input(X, clip)
        if not np.isfinite(X_scaled).all():
            raise ValueError("test X is outside the range of the training input; "
                             "call predict(X, clip=True) to clip into range")
        mu, _ = self.m.predict_f(self._tensor(X_scaled))
        if self._is_bernoulli():
            return self.m.likelihood.invlink(mu).cpu().numpy().astype(np.float64)[:, 0]
        return self._scale_y_inverse(mu.cpu().numpy())[:, 0]

    @torch.no_grad()
    def predict_f_samples(self, X, num_samples: int = 1, seed=0,
                          clip: bool = False) -> np.ndarray:
        """Joint posterior function draws at raw-unit inputs, [num_samples,
        N], in the original target units, or probability draws invlink(f)
        for Bernoulli. The draws come from a ``torch.Generator`` seeded with
        ``seed``, so they are not ``oak_tpu``'s."""
        X_scaled = self._scaled_input(X, clip)
        draws = self.m.predict_f_samples(self._tensor(X_scaled), num_samples=num_samples,
                                         generator_or_seed=seed)[:, :, 0]
        if self._is_bernoulli():
            return self.m.likelihood.invlink(draws).cpu().numpy().astype(np.float64)
        draws = draws.cpu().numpy().astype(np.float64)
        return draws * self.scaler_y.scale_[0] + self.scaler_y.mean_[0]

    @torch.no_grad()
    def predict_proba(self, X, clip: bool = False) -> np.ndarray:
        assert self.likelihood == "bernoulli"
        mu, var = self.m.predict_f(self._tensor(self._scaled_input(X, clip)))
        p, _ = self.m.likelihood.predict_mean_and_var(mu, var)
        return p.cpu().numpy().astype(np.float64)[:, 0]

    @torch.no_grad()
    def get_loglik(self, X, y, clip: bool = False) -> float:
        """Mean log predictive density; of the scaled target for regression,
        as the reference computes it."""
        X_scaled = self._scaled_input(X, clip)
        y = np.asarray(y, np.float64)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        if self.likelihood != "bernoulli":
            y = self.scaler_y.transform(y)
        ld = self.m.predict_log_density(self._tensor(X_scaled), self._tensor(y))
        return float(torch.mean(ld.double()))

    # ------------------------------------------------------------------ #
    def _transform_x(self, X) -> np.ndarray:
        """The flows (on the model's device) and the scalers; float64 numpy."""
        X = apply_normalise_flow(X, self.input_flows)
        if self.empirical_measure is not None:
            X[:, self.empirical_measure] = self.scaler_X_empirical.transform(
                X[:, self.empirical_measure])
        if not self.use_normalising_flow:
            X[:, self.continuous_index] = self.scaler_X_continuous.transform(
                X[:, self.continuous_index])
        return X

    def _get_x_inverse_transformer(self, i: int):
        assert i in self.continuous_index
        if self.empirical_measure is not None and i in self.empirical_measure:
            j = self.empirical_measure.index(i)
            mean_i = self.scaler_X_empirical.mean_[j]
            std_i = self.scaler_X_empirical.scale_[j]
            return lambda x: np.asarray(x) * std_i + mean_i
        if self.gmm_measure is not None and self.estimated_gmm_measures[i] is not None:
            return None
        if self.input_flows[i] is not None:
            flow = self.input_flows[i]

            @torch.no_grad()
            def inverse(x):
                return flow.inverse(flow.as_input(np.asarray(x))).cpu().numpy()

            return inverse
        if self.scaler_X_continuous is not None:
            j = self.continuous_index.index(i)
            mean_i = self.scaler_X_continuous.mean_[j]
            std_i = self.scaler_X_continuous.scale_[j]
            return lambda x: np.asarray(x) * std_i + mean_i
        return None

    # ------------------------------------------------------------------ #
    def get_sobol(self, likelihood_variance: bool = False) -> np.ndarray:
        """Normalised Sobol index per component."""
        tuples, sobols = sobol_mod.compute_sobol_oak(self.m)
        lik_var = None
        if likelihood_variance and not isinstance(self.m, SVGP):
            lik_var = _host_values([self.m.likelihood.variance])[0]
        self.normalised_sobols = sobol_mod.normalize_sobol(sobols, lik_var)
        self.tuple_of_indices = tuples
        return self.normalised_sobols

    def get_sobol_by_order(self) -> np.ndarray:
        """Normalised Sobol mass aggregated per interaction order."""
        self.get_sobol()
        out = np.zeros(self.max_interaction_depth)
        for t, v in zip(self.tuple_of_indices, self.normalised_sobols):
            out[len(t) - 1] += v
        return out

    def get_prediction_components(self, X=None, clip: bool = False) -> np.ndarray:
        """Per-component predictive means [C, N] at raw-unit X (the training
        inputs when None); with the constant they sum to the mean."""
        X = self.X_scaled if X is None else self._scaled_input(X, clip)
        return sobol_mod.get_prediction_component(self.m, X=self._tensor(X))

    # ------------------------------------------------------------------ #
    def save(self, path):
        from .checkpoint import save_oak_model

        save_oak_model(self, path)

    @classmethod
    def load(cls, path, dtype: Optional[torch.dtype] = None, device=None) -> "oak_model":
        from .checkpoint import load_oak_model

        return load_oak_model(path, dtype=dtype, device=device)
