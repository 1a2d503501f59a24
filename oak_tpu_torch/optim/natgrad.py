"""Natural-gradient steps on q(u) of an SVGP, alternated with Adam on every
other trainable (``oak_tpu.optim.natgrad``).

q(u) = N(m, S) is an exponential family. Steepest descent in its natural
parameters (θ1 = S⁻¹m, θ2 = −½S⁻¹) with the gradient taken in its
expectation parameters (η1 = m, η2 = S + m mᵀ) is the natural gradient:

    θ ← θ − γ ∂L/∂η

For a Gaussian likelihood and a full q (``q_diag=False``) one unit step
(γ = 1) on the full data lands q(u) on the optimum. Use ``q_diag=False``:
the mean-field step ignores the posterior's off-diagonal coupling and
diverges at scale for any practical γ (``oak_tpu``'s module docstring has
the measurement; ``warn_if_q_diag`` warns at every entry point).

The model's own raws are written once, at the end; in between, the state is
the flat trainable vector, as in ``optim.fit``.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.psd import chol_of_inv, cholesky_lower, tri_inv_lower
from ..params import assign_trainable, call_with, unflatten_trainable
from .fit import (FitResult, _leaf, _stack, adam, finite_or_zero, loss_and_grads,
                  scan_checkpoint_driver, writes_checkpoints)

_VAR_FLOOR = 1e-10
_Q = ("q_mu", "q_sqrt")


def warn_if_q_diag(model) -> None:
    """One warning when natural gradients run on a mean-field q."""
    if getattr(model, "q_diag", False):
        warnings.warn(
            "natural-gradient steps on a q_diag=True SVGP are unstable when "
            "(num_data/batch_size) * prior_variance/noise_variance is large "
            "(the mean-field natural step ignores the posterior's off-"
            "diagonal coupling and can diverge at any step size); build the "
            "model with q_diag=False for natgrad training",
            stacklevel=3)


def _q_values(model, raws: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_mu, q_sqrt) constrained values at the raws of ``raws``."""
    return tuple(getattr(model, n).bij.forward(raws[f"{n}.raw"]) for n in _Q)


def _q_raws(model, q_mu: torch.Tensor, q_sqrt: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The raws of q(u) at the given values (``Param.assign``'s inverse
    bijector), keyed for ``call_with``."""
    return {f"{n}.raw": getattr(model, n).bij.inverse(v)
            for n, v in zip(_Q, (q_mu, q_sqrt))}


def _eta_params(q_mu: torch.Tensor, q_sqrt: torch.Tensor,
                q_diag: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expectation parameters of q(u): η1 = m [M, R]; η2 = S + m mᵀ, [R, M, M]
    for a full q, elementwise [M, R] for a mean-field one."""
    if q_diag:
        return q_mu, q_sqrt * q_sqrt + q_mu * q_mu
    Lq = torch.tril(q_sqrt)
    mu = q_mu.T  # [R, M]
    return q_mu, Lq @ Lq.mT + mu[:, :, None] * mu[:, None, :]


def _q_from_eta(e1: torch.Tensor, e2: torch.Tensor,
                q_diag: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_mu, q_sqrt) from expectation parameters: the differentiable map
    the η-gradient passes through (``oak_tpu``'s ``_with_eta``)."""
    if q_diag:
        return e1, torch.sqrt(torch.clamp_min(e2 - e1 * e1, _VAR_FLOOR))
    mu = e1.T
    S = 0.5 * (e2 + e2.mT) - mu[:, :, None] * mu[:, None, :]
    eye = torch.eye(e2.shape[-1], dtype=e2.dtype, device=e2.device)
    return e1, cholesky_lower(S + _VAR_FLOOR * eye)


def _apply_natural_step(q_mu: torch.Tensor, q_sqrt: torch.Tensor, q_diag: bool,
                        g1: torch.Tensor, g2: torch.Tensor,
                        gamma: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """θ ← θ(q) − γ ∂L/∂η, then back to (q_mu, q_sqrt). An overshot step
    (θ2 not negative definite) is rejected instead of poisoning q:
    elementwise for the mean-field family, per latent for a full q."""
    if q_diag:
        S = q_sqrt * q_sqrt
        theta1, theta2 = q_mu / S, -0.5 / S
        t1 = theta1 - gamma * g1
        t2 = theta2 - gamma * g2
        ok = t2 < -_VAR_FLOOR
        S_new = torch.where(ok, -0.5 / torch.where(ok, t2, -1.0), S)
        m_new = S_new * torch.where(ok, t1, theta1)
        return m_new, torch.sqrt(S_new)

    Lq = torch.tril(q_sqrt)  # [R, M, M]
    mu = q_mu.T  # [R, M]
    # S⁻¹ from the stored factor, whatever the signs of its diagonal
    Linv = tri_inv_lower(Lq)
    Sinv = Linv.mT @ Linv
    t1 = (Sinv @ mu[:, :, None])[..., 0] - gamma * g1.T  # [R, M]
    t2 = -0.5 * Sinv - gamma * g2  # [R, M, M]
    Lq_new = chol_of_inv(-(t2 + t2.mT), _VAR_FLOOR)  # Lq Lqᵀ = S_new
    m_new = (Lq_new @ (Lq_new.mT @ t1[:, :, None]))[..., 0]  # S_new t1
    # an indefinite θ2 gives NaN from the Cholesky: keep that latent's q
    bad = ~(torch.isfinite(Lq_new).all(dim=(-2, -1)) & torch.isfinite(m_new).all(dim=-1))
    m_new = torch.where(bad[:, None], mu, m_new)
    Lq_new = torch.where(bad[:, None, None], Lq, Lq_new)
    return m_new.T, Lq_new


def _eta_grads(model, raws: Dict[str, torch.Tensor], loss_fn: Callable, args,
               wrt_vec: Optional[torch.Tensor] = None):
    """The loss at ``raws`` with q(u) rebuilt from its expectation
    parameters, and its gradient w.r.t. (η1, η2) and, when given, the vector
    ``wrt_vec`` that ``raws`` are views of (whose q entries then get exactly
    zero gradient). Also returns q's values at ``raws``."""
    q_diag = model.q_diag
    q_mu, q_sqrt = (t.detach() for t in _q_values(model, raws))
    e1, e2 = (t.detach().requires_grad_(True) for t in _eta_params(q_mu, q_sqrt, q_diag))
    inputs = [e1, e2] if wrt_vec is None else [e1, e2, wrt_vec]
    loss, grads = loss_and_grads(
        model, loss_fn, {**raws, **_q_raws(model, *_q_from_eta(e1, e2, q_diag))}, inputs, args)
    return loss, grads, (q_mu, q_sqrt)


def _replace_q(model, raws: Dict[str, torch.Tensor], q_mu, q_sqrt) -> torch.Tensor:
    """The trainable vector of ``raws`` with q(u)'s entries set to the raws
    of (q_mu, q_sqrt)."""
    new = {**raws, **_q_raws(model, q_mu, q_sqrt)}
    return torch.cat([t.reshape(-1) for t in new.values()])


def natgrad_adam_step(opt: torch.optim.Adam, vec: torch.Tensor, model,
                      loss_fn: Callable, gamma: float,
                      staggered: bool = False) -> Callable:
    """One natural-gradient step on (q_mu, q_sqrt) plus one Adam step on
    every other trainable, on the leaf ``vec`` that ``opt`` holds. Returns
    ``step(*args) -> loss``, which updates ``vec`` and ``opt`` in place.

    Fused (default): one backward, at the step's start point, w.r.t. the
    expectation parameters of q(u) and the trainable vector jointly; the
    natural step and the Adam step both use it, and the loss is the start
    point's. ``staggered=True``: the natural step first, then a second
    backward at the new q for the hyperparameters' gradient, and the loss
    there. Non-finite hyperparameter gradient entries become 0, as in
    ``fit_adam``."""
    q_diag = model.q_diag

    def step(*args):
        raws = unflatten_trainable(model, vec.detach())
        if staggered:
            _, (g1, g2), q = _eta_grads(model, raws, loss_fn, args)
            q_new = _apply_natural_step(*q, q_diag, g1, g2, gamma)
            new_vec = _replace_q(model, raws, *q_new).detach().requires_grad_(True)
            new_raws = unflatten_trainable(model, new_vec)
            q_raws = {k: v.detach() for k, v in _q_raws(model, *q_new).items()}
            loss, (gvec,) = loss_and_grads(model, loss_fn, {**new_raws, **q_raws},
                                           [new_vec], args)
        else:
            leaf = vec.detach().requires_grad_(True)
            loss, (g1, g2, gvec), q = _eta_grads(
                model, unflatten_trainable(model, leaf), loss_fn, args, wrt_vec=leaf)
            q_new = _apply_natural_step(*q, q_diag, g1, g2, gamma)
            new_vec = _replace_q(model, raws, *q_new)
        with torch.no_grad():
            vec.copy_(new_vec)
        vec.grad = finite_or_zero(gvec)
        opt.step()
        return loss

    return step


def _natgrad_update(model, loss_fn: Callable, gamma: float, staggered: bool) -> Callable:
    """``natgrad_adam_step``'s update of one vector in ``torch.func`` form,
    for ``vmap`` over lanes: ``update(vec) -> (new vec, the hyperparameters'
    gradient, loss)``, the gradients from ``torch.func.grad_and_value`` of
    the loss as a function of the vector and q(u)'s expectation parameters
    (whose q entries of the vector are overridden, so get zero gradient)."""
    q_diag = model.q_diag

    def loss_at(vec, e1, e2):
        raws = {**unflatten_trainable(model, vec), **_q_raws(model, *_q_from_eta(e1, e2, q_diag))}
        return call_with(model, raws, loss_fn)

    def update(vec):
        raws = unflatten_trainable(model, vec)
        q = _q_values(model, raws)
        e1, e2 = _eta_params(*q, q_diag)
        if staggered:
            (g1, g2), _ = torch.func.grad_and_value(loss_at, argnums=(1, 2))(vec, e1, e2)
            q_new = _apply_natural_step(*q, q_diag, g1, g2, gamma)
            new_vec = _replace_q(model, raws, *q_new)
            q_raws = _q_raws(model, *q_new)
            gvec, loss = torch.func.grad_and_value(
                lambda v: call_with(model, {**unflatten_trainable(model, v), **q_raws},
                                    loss_fn))(new_vec)
        else:
            (gvec, g1, g2), loss = torch.func.grad_and_value(loss_at, argnums=(0, 1, 2))(
                vec, e1, e2)
            new_vec = _replace_q(model, raws, *_apply_natural_step(*q, q_diag, g1, g2, gamma))
        return new_vec, gvec, loss

    return update


def natgrad_lanes_step(opt: torch.optim.Adam, vecs: torch.Tensor, model, loss_fn: Callable,
                       gamma: float, staggered: bool = False) -> Callable:
    """``natgrad_adam_step`` for the lanes ``vecs`` [R, n] (the leaf ``opt``
    holds), all of them in one ``torch.func.vmap`` of its update
    (``oak_tpu``'s vmapped natgrad step, multistart.py:329), then one
    elementwise Adam step on [R, n]. Returns ``step() -> losses [R]``."""
    update = torch.func.vmap(_natgrad_update(model, loss_fn, gamma, staggered))

    def step():
        new_vecs, gvecs, losses = update(vecs.detach())
        with torch.no_grad():
            vecs.copy_(new_vecs)
        vecs.grad = finite_or_zero(gvecs.detach())
        opt.step()
        return losses.detach()

    return step


def fit_natgrad_adam(model, loss_fn: Callable, steps: int = 200,
                     gamma: float = 0.1, hyper_lr: float = 1e-2,
                     batch_fn: Optional[Callable] = None,
                     staggered: bool = False) -> FitResult:
    """Alternate natural-gradient steps on the variational parameters with
    Adam steps on every other trainable: ``loss_fn(model)`` (full batch) or
    ``loss_fn(model, *batch_fn(i))`` (minibatch). ``gamma=1`` with a
    Gaussian likelihood makes each variational step exact. The reported
    ``fun`` is the loss at the last step's linearization point (before the
    update when fused, after the natural step when staggered)."""
    warn_if_q_diag(model)
    vec = _leaf(model)
    opt = adam(vec, hyper_lr)
    step = natgrad_adam_step(opt, vec, model, loss_fn, gamma, staggered=staggered)
    losses = [step(*(() if batch_fn is None else batch_fn(i))) for i in range(steps)]
    assign_trainable(model, vec.detach())
    fun = float(losses[-1]) if losses else float("inf")
    return FitResult(model=model, fun=fun, num_iters=steps,
                     success=bool(np.isfinite(fun)), losses=_stack(losses, vec))


def fit_natgrad_scan(model, loss_fn: Callable, steps: int = 200, gamma: float = 0.1,
                     hyper_lr: float = 1e-2, batch_args=None, checkpoint_path=None,
                     checkpoint_every: int = 0, resume: bool = True,
                     staggered: bool = False) -> FitResult:
    """``oak_tpu``'s device-resident ``fit_natgrad_adam`` (one ``lax.scan``)
    as a loop over ``natgrad_adam_step`` with ``scan_checkpoint_driver``'s
    chunks: the state is (trainable vector, Adam's state, step), so a run
    resumed from ``checkpoint_path`` replays the uninterrupted trajectory.
    ``batch_args``: tensors with leading dimension ``steps``; step i calls
    ``loss_fn(model, *[a[i] for a in batch_args])``. Returns the last
    iterate and the last step's loss."""
    warn_if_q_diag(model)
    vec = _leaf(model)
    opt = adam(vec, hyper_lr)
    step = natgrad_adam_step(opt, vec, model, loss_fn, gamma, staggered=staggered)
    v, start, ran = scan_checkpoint_driver(step, opt, vec, steps, batch_args,
                                           checkpoint_path, checkpoint_every, resume,
                                           writes_checkpoints(loss_fn))
    assign_trainable(model, vec.detach())
    if not ran:
        return FitResult(model=model, fun=float("nan"), num_iters=0, success=True,
                         message=f"checkpoint at step {start} >= steps={steps};"
                                 " nothing to run")
    v = float(v)
    return FitResult(model=model, fun=v, num_iters=steps - start,
                     success=bool(np.isfinite(v)))
