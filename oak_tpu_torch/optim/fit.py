"""Optimizers over the flat trainable vector (``oak_tpu.optim.fit``): scipy
(``fit_scipy``), L-BFGS with a zoom linesearch (``fit_lbfgs``) and Adam, with
mid-training checkpoint and resume.

Every optimizer works on the vector ``params.flatten_trainable`` gives: the
loss is evaluated on views of it through ``params.call_with``, so
non-trainable Params (fixed inducing points, pinned base variances) are
never touched, and the model's own raws are written once, at the end
(``params.assign_trainable``): the model passed in is updated in place and
returned as ``FitResult.model``.

Adam is ``torch.optim.Adam`` with optax's defaults (lr 1e-2, β 0.9 / 0.999,
eps 1e-8), which computes optax's update. Its state is saved under optax's
leaf order (count, mu, nu), so a train state has ``oak_tpu``'s npz layout.

L-BFGS is written out here as what ``optax.lbfgs(memory_size=30)`` computes
(``torch.optim.LBFGS`` follows other rules at the first step, the memory and
the linesearch): the vectors stay on the model's device, and the
linesearch's decisions are taken on the host from one scalar read per
evaluation.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import optimize as sciopt

from ..params import assign_trainable, call_with, flatten_trainable, unflatten_trainable


@dataclasses.dataclass
class FitResult:
    model: object
    fun: float
    num_iters: int
    success: bool
    message: str = ""
    grad_norm: Optional[float] = None
    # Adam and natgrad: the loss at each step's start point, on the model's
    # device; the multistarts: each lane's final loss, on the host (not in
    # oak_tpu's FitResult: there the trajectory stays inside jit)
    losses: Optional[torch.Tensor] = None


def adam(vec: torch.Tensor, lr: float = 1e-2) -> torch.optim.Adam:
    """Adam on the leaf ``vec`` with optax's defaults."""
    return torch.optim.Adam([vec], lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _leaf(model) -> torch.Tensor:
    return flatten_trainable(model).detach().clone().requires_grad_(True)


def value_and_grad(model, loss_fn: Callable, vec: torch.Tensor,
                   *args) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d vec) of ``loss_fn(model, *args)`` at the trainable
    vector ``vec``; the loss is detached and stays on the device."""
    vec = vec.detach().requires_grad_(True)
    loss = call_with(model, unflatten_trainable(model, vec), loss_fn, *args)
    (grad,) = torch.autograd.grad(loss, vec, allow_unused=True, materialize_grads=True)
    return loss.detach(), grad


def finite_or_zero(g: torch.Tensor) -> torch.Tensor:
    """Non-finite gradient entries (a transient Cholesky failure at the edge
    of the feasible region) become 0 instead of poisoning Adam's moments."""
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def _adam_step(model, loss_fn: Callable, vec: torch.Tensor, opt: torch.optim.Adam,
               args: Sequence = (), mask: bool = True) -> torch.Tensor:
    """One Adam step on ``vec`` in place; returns the loss at the start
    point."""
    v, g = value_and_grad(model, loss_fn, vec, *args)
    vec.grad = finite_or_zero(g) if mask else g
    opt.step()
    return v


def fit_adam(model, loss_fn: Callable, steps: int = 1000, lr: float = 1e-2,
             batch_fn: Optional[Callable] = None) -> FitResult:
    """Adam over the trainable vector. If ``batch_fn(step) -> args`` is given,
    loss_fn is called as loss_fn(model, *args) per step (minibatch ELBO),
    and the last iterate and its step's loss are returned; otherwise
    loss_fn(model), with non-finite gradient entries set to 0, and the best
    finite iterate is returned. The best iterate is tracked on the device
    with ``torch.where``: the host reads the loss once, at the end."""
    vec = _leaf(model)
    if batch_fn is not None:
        opt = adam(vec, lr)
        losses: List[torch.Tensor] = []
        for i in range(steps):
            losses.append(_adam_step(model, loss_fn, vec, opt, batch_fn(i), mask=False))
        assign_trainable(model, vec.detach())
        v = float(losses[-1]) if losses else float("inf")
        return FitResult(model=model, fun=v, num_iters=steps, success=True,
                         losses=_stack(losses, vec))

    best_vec, best_v, losses = adam_best(model, loss_fn, vec, steps, lr)
    assign_trainable(model, best_vec)
    return FitResult(model=model, fun=float(best_v), num_iters=steps,
                     success=True, losses=losses)


def adam_best(model, loss_fn: Callable, vec0: torch.Tensor, steps: int, lr: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-batch Adam from ``vec0`` with non-finite gradient entries set to
    0: (best finite iterate, its loss, every step's loss). The masked steps
    never check the loss and can wander into a non-finite region, so the
    best finite iterate is kept, tracked on the device with ``torch.where``;
    each step's loss is the loss at its pre-update vector, and the final
    iterate is scored too. With no finite loss the start is returned."""
    vec = vec0.detach().clone().requires_grad_(True)
    opt = adam(vec, lr)
    losses: List[torch.Tensor] = []
    best_v = torch.full((), float("inf"), dtype=vec.dtype, device=vec.device)
    best_vec = vec.detach().clone()

    def consider(v):
        nonlocal best_v, best_vec
        better = torch.isfinite(v) & (v < best_v)
        best_v = torch.where(better, v, best_v)
        best_vec = torch.where(better, vec.detach(), best_vec)

    for _ in range(steps):
        v, g = value_and_grad(model, loss_fn, vec)
        consider(v)
        vec.grad = finite_or_zero(g)
        opt.step()
        losses.append(v)
    if steps > 0:
        with torch.no_grad():
            consider(call_with(model, unflatten_trainable(model, vec), loss_fn))
    return best_vec, best_v, _stack(losses, vec)


def _stack(losses: List[torch.Tensor], like: torch.Tensor) -> torch.Tensor:
    if not losses:
        return torch.zeros((0,), dtype=like.dtype, device=like.device)
    return torch.stack(losses)


# --------------------------------------------------------------------------- #
# Train state
# --------------------------------------------------------------------------- #
def adam_state(opt: torch.optim.Adam, vec: torch.Tensor) -> List[torch.Tensor]:
    """Adam's state for ``vec`` as optax's leaves: [count, mu, nu]."""
    state = opt.state.get(vec, {})
    if not state:
        zeros = torch.zeros_like(vec.detach())
        return [torch.zeros((), dtype=torch.int32), zeros, zeros.clone()]
    return [torch.as_tensor(int(state["step"]), dtype=torch.int32),
            state["exp_avg"], state["exp_avg_sq"]]


def set_adam_state(opt: torch.optim.Adam, vec: torch.Tensor,
                   leaves: Sequence[torch.Tensor]) -> None:
    """Inverse of ``adam_state``: Adam continues from [count, mu, nu]."""
    count, mu, nu = leaves
    opt.state[vec] = {
        "step": torch.tensor(float(count)),
        "exp_avg": torch.as_tensor(mu, dtype=vec.dtype, device=vec.device).clone(),
        "exp_avg_sq": torch.as_tensor(nu, dtype=vec.dtype, device=vec.device).clone()}


def save_train_state(path, vec: torch.Tensor, opt_state: Sequence[torch.Tensor],
                     step: int) -> None:
    """Write (trainable vector, optimizer-state leaves, step) to one npz, as
    ``oak_tpu.optim.save_train_state`` does, atomically: the file is written
    beside the target and renamed over it, so a crash mid-write leaves the
    previous checkpoint whole."""
    arrays = {f"opt_{i}": _numpy(a) for i, a in enumerate(opt_state)}
    tmp = f"{path}.tmp"
    # through a file object, so that np.savez cannot append ".npz" to tmp
    with open(tmp, "wb") as f:
        np.savez(f, vec=_numpy(vec), step=np.asarray(step), **arrays)
    os.replace(tmp, path)


def load_train_state(path, dtype=None, device=None
                     ) -> Tuple[torch.Tensor, List[torch.Tensor], int]:
    """Inverse of ``save_train_state``: (vec, optimizer-state leaves, step).
    The vector and the floating leaves take ``dtype`` and ``device``."""
    with np.load(path) as f:
        vec = torch.as_tensor(f["vec"], dtype=dtype, device=device)
        step = int(f["step"])
        leaves = [f[f"opt_{i}"] for i in range(len(f.files) - 2)]
    leaves = [torch.as_tensor(a) if a.dtype.kind in "iu"
              else torch.as_tensor(a, dtype=dtype, device=device) for a in leaves]
    return vec, leaves, step


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------- #
# The chunked loop with checkpoints
# --------------------------------------------------------------------------- #
def scan_checkpoint_driver(one_step: Callable, opt: torch.optim.Adam,
                           vec: torch.Tensor, steps: int, batch_args,
                           checkpoint_path, checkpoint_every: int,
                           resume: bool) -> Tuple[torch.Tensor, int, bool]:
    """Run ``one_step(*args) -> loss`` (which updates ``vec`` and ``opt`` in
    place) for steps start..steps-1, in chunks of ``checkpoint_every``, and
    write (vec, Adam's state, step) after each chunk. With ``resume`` and an
    existing file, ``vec`` and Adam continue from the recorded step and step
    i gets the same ``batch_args`` slice, so the resumed trajectory is the
    uninterrupted one. Returns (last loss, start, ran); ``ran`` is False when
    the checkpoint already covered ``steps``."""
    start = 0
    if checkpoint_path is not None and resume and os.path.exists(checkpoint_path):
        saved, leaves, start = load_train_state(checkpoint_path, vec.dtype, vec.device)
        with torch.no_grad():
            vec.copy_(saved)
        set_adam_state(opt, vec, leaves)
    if start >= steps and start > 0:
        return torch.tensor(float("nan")), start, False

    chunk = (checkpoint_every if (checkpoint_path is not None and checkpoint_every > 0)
             else steps - start)
    v = torch.tensor(float("inf"))
    i = start
    while i < steps:
        n = min(chunk, steps - i)
        for k in range(i, i + n):
            v = one_step(*(() if batch_args is None else tuple(a[k] for a in batch_args)))
        i += n
        if checkpoint_path is not None:
            save_train_state(checkpoint_path, vec, adam_state(opt, vec), i)
    return v, start, True


def fit_adam_scan(model, loss_fn: Callable, steps: int = 1000, lr: float = 1e-2,
                  batch_args=None, checkpoint_path=None,
                  checkpoint_every: int = 0, resume: bool = True) -> FitResult:
    """``oak_tpu``'s device-resident Adam (one ``lax.scan``), as a plain
    loop: PyTorch has no ``lax.scan``, and every step is issued from the
    host. Same update as ``fit_adam`` with non-finite gradient entries set
    to 0; returns the last iterate and the last step's loss.

    ``batch_args``: optional tuple of tensors with leading dimension
    ``steps``; step i calls ``loss_fn(model, *[a[i] for a in batch_args])``.
    With ``checkpoint_path`` the run goes in chunks of ``checkpoint_every``
    steps and saves its state after each (``scan_checkpoint_driver``); a
    rerun with the same arguments resumes from the file."""
    vec = _leaf(model)
    opt = adam(vec, lr)

    def one_step(*args):
        return _adam_step(model, loss_fn, vec, opt, args)

    v, start, ran = scan_checkpoint_driver(one_step, opt, vec, steps, batch_args,
                                           checkpoint_path, checkpoint_every, resume)
    assign_trainable(model, vec.detach())
    if not ran:
        # the checkpoint already covers the requested run: nothing to do,
        # and that is success, not a failed fit
        return FitResult(model=model, fun=float("nan"), num_iters=0, success=True,
                         message=f"checkpoint at step {start} >= steps={steps};"
                                 " nothing to run")
    v = float(v)
    return FitResult(model=model, fun=v, num_iters=steps - start,
                     success=bool(np.isfinite(v)))


# --------------------------------------------------------------------------- #
# scipy
# --------------------------------------------------------------------------- #
def fit_scipy(model, loss_fn: Callable, method: str = "BFGS", max_iters: int = 1000,
              tol: Optional[float] = None, jit: bool = True) -> FitResult:
    """Minimise loss_fn(model) over the trainable vector with
    ``scipy.optimize.minimize``, on float64 host copies of the port's loss
    and gradient (each evaluation runs on the model's device). ``jit`` is
    accepted for ``oak_tpu``'s signature and does nothing: the port is
    eager."""
    del jit
    vec0 = flatten_trainable(model).detach()

    def fun(x):
        v, g = value_and_grad(model, loss_fn, torch.as_tensor(x, dtype=vec0.dtype,
                                                              device=vec0.device))
        return float(v), g.double().cpu().numpy()

    res = sciopt.minimize(fun, vec0.double().cpu().numpy(), jac=True, method=method,
                          tol=tol, options={"maxiter": max_iters})
    assign_trainable(model, torch.as_tensor(res.x, dtype=vec0.dtype, device=vec0.device))
    return FitResult(model=model, fun=float(res.fun), num_iters=int(res.get("nit", -1)),
                     success=bool(res.success), message=str(res.message))


# --------------------------------------------------------------------------- #
# L-BFGS
# --------------------------------------------------------------------------- #
# optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy="one") with its other defaults
MAX_LINESEARCH_STEPS = 20
_INCREASE, _SLOPE_RTOL, _CURV_RTOL = 2.0, 1e-4, 0.9
_APPROX_DEC_RTOL, _STEPSIZE_PRECISION = 1e-6, 1e-5

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass
class LBFGSState:
    """optax's L-BFGS state (``scale_by_lbfgs`` and the linesearch's), with
    the scalars on the host: ``count`` updates so far; ``params`` and
    ``updates`` the vector and gradient of the last update; the memory of
    parameter and gradient differences ``S``, ``Y`` [m, n] and their weights
    ``rho`` [m] (1 / ⟨s, y⟩, 0 where that is 0); ``value`` and ``grad`` where
    the last linesearch ended (``value`` inf before the first, so the first
    iteration evaluates), ``grad_sq`` = ‖grad‖², ``learning_rate`` its
    step."""

    count: int
    params: torch.Tensor
    updates: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    rho: torch.Tensor
    value: float
    grad: torch.Tensor
    grad_sq: float
    learning_rate: float

    _TENSORS = ("params", "updates", "S", "Y", "rho", "grad")
    _SCALARS = ("count", "value", "grad_sq", "learning_rate")

    @classmethod
    def init(cls, vec: torch.Tensor, memory_size: int) -> "LBFGSState":
        z = torch.zeros_like(vec)
        mem = torch.zeros((memory_size,) + tuple(vec.shape), dtype=vec.dtype,
                          device=vec.device)
        return cls(0, z, z.clone(), mem, mem.clone(),
                   torch.zeros((memory_size,), dtype=vec.dtype, device=vec.device),
                   math.inf, z.clone(), 0.0, 1.0)

    def arrays(self, prefix: str) -> Dict[str, np.ndarray]:
        out = {f"{prefix}{k}": _numpy(getattr(self, k)) for k in self._TENSORS}
        out.update({f"{prefix}{k}": np.asarray(getattr(self, k), np.float64)
                    for k in self._SCALARS})
        return out

    @classmethod
    def from_arrays(cls, data, prefix: str, like: torch.Tensor) -> "LBFGSState":
        kw = dict(dtype=like.dtype, device=like.device)
        tensors = {k: torch.as_tensor(data[f"{prefix}{k}"], **kw) for k in cls._TENSORS}
        scalars = {k: float(data[f"{prefix}{k}"]) for k in cls._SCALARS}
        scalars["count"] = int(scalars["count"])
        return cls(**tensors, **scalars)


def _direction(state: LBFGSState, vec: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """``scale_by_lbfgs``'s update (transform.py:1676-1751) on the device:
    store the pair (vec - params, grad - updates) with weight 1 / ⟨s, y⟩
    (0 where that is 0; nothing is skipped), then the two-loop product of
    the inverse-Hessian estimate with grad, its identity scaled by
    ⟨s, y⟩ / ⟨y, y⟩, or by min(1, 1 / ‖grad‖₂) at the first update. Slots
    never written hold zeros, whose terms are exact no-ops, and are
    skipped."""
    m = state.rho.shape[0]
    k = state.count
    prev = (k - 1) % m
    if k > 0:
        s, y = vec - state.params, grad - state.updates
        sy = torch.dot(y, s)
        state.S[prev], state.Y[prev] = s, y
        state.rho[prev] = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
        yy = torch.dot(y, y)
        scale = torch.where(yy > 0.0, sy / yy, torch.ones_like(yy))
    else:
        state.S[prev], state.Y[prev], state.rho[prev] = 0.0, 0.0, 0.0
        norm = torch.linalg.vector_norm(grad)
        scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
    written = set(range(m)) if k >= m else set(range(k))
    order = [i for i in ((k % m + j) % m for j in range(m)) if i in written]
    d, alphas = grad, {}
    for i in reversed(order):
        alphas[i] = state.rho[i] * torch.dot(state.S[i], d)
        d = d + (-alphas[i]) * state.Y[i]
    d = scale * d
    for i in order:
        beta = state.rho[i] * torch.dot(state.Y[i], d)
        d = d + (alphas[i] - beta) * state.S[i]
    state.count, state.params, state.updates = k + 1, vec, grad
    return d


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax linesearch.py:455); NaN when there is none."""
    a, fa, fpa, b, fb, c, fc = map(np.float64, (a, fa, fpa, b, fb, c, fc))
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v1, v2 = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * v1 + -(db ** 2) * v2) / denom
    B = (-(dc ** 3) * v1 + db ** 3 * v2) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax linesearch.py:496)."""
    a, fa, fpa, b, fb = map(np.float64, (a, fa, fpa, b, fb))
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / (db ** 2)))


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's error, or Hager and Zhang's approximate one where smaller;
    0 when satisfied, inf when NaN (optax linesearch.py:710)."""
    armijo = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = np.maximum(slope - (2 * _SLOPE_RTOL - 1.0) * slope_init,
                        value - value_init - _APPROX_DEC_RTOL * np.abs(value_init))
    err = np.maximum(np.minimum(approx, armijo), 0.0)
    return np.inf if np.isnan(err) else err


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), 0.0)
    return np.inf if np.isnan(err) else err


@dataclasses.dataclass
class _Point:
    """A linesearch evaluation: stepsize, value, gradient, slope along the
    direction, ‖gradient‖²."""

    step: np.float64
    value: np.float64
    grad: torch.Tensor
    slope: np.float64
    grad_sq: np.float64


def _evaluate(value_and_grad_fn: ValueAndGrad, vec: torch.Tensor, u: torch.Tensor,
              step) -> _Point:
    """The loss and gradient at vec + step·u, with one host read of (value,
    slope, ‖grad‖²)."""
    value, grad = value_and_grad_fn(vec + float(step) * u)
    v, slope, gsq = torch.stack([value.to(grad.dtype).reshape(()), torch.dot(grad, u),
                                 torch.dot(grad, grad)]).tolist()
    return _Point(np.float64(step), np.float64(v), grad, np.float64(slope), np.float64(gsq))


def zoom_linesearch(value_and_grad_fn: ValueAndGrad, vec: torch.Tensor, u: torch.Tensor,
                    start: _Point, max_steps: int = MAX_LINESEARCH_STEPS) -> _Point:
    """optax's ``zoom_linesearch`` (linesearch.py:576-1282) from ``start``
    (step 0) along the direction u: the interval search from step 1, the
    cubic, quadratic or bisecting zoom, the approximate-decrease switch, and
    the fallback to the best step with sufficient decrease. Returns the
    point where it ends."""
    with np.errstate(all="ignore"):
        v0, s0 = start.value, start.slope
        cur = start  # the running point
        low = high = cubic = start  # the interval's ends and the cubic's reference
        safe = start  # the best step with sufficient decrease (0: none yet)
        dec_err = np.inf
        interval_found = done = failed = False
        count = 0
        while not (done or failed):
            if not interval_found:
                step = np.float64(1.0) if count == 0 else _INCREASE * cur.step
                new = _evaluate(value_and_grad_fn, vec, u, step)
                dec_err = _decrease_error(new.step, new.value, new.slope, v0, s0)
                err = max(dec_err, _curvature_error(new.slope, s0))
                if dec_err <= 0.0:
                    safe = new
                set_high = (dec_err > 0.0) or (new.value >= cur.value and count > 0)
                set_low = new.slope >= 0.0 and not set_high
                low, high = (new, cur) if set_low else (cur, new)
                cubic = low
                interval_found = set_high or set_low or err <= 0.0
                done = err <= 0.0
                failed = count + 1 >= max_steps and not done
            else:
                delta = np.abs(high.step - low.step)
                left, right = min(high.step, low.step), max(high.step, low.step)
                mc = _cubicmin(low.step, low.value, low.slope, high.step, high.value,
                               cubic.step, cubic.value)
                mq = _quadmin(low.step, low.value, low.slope, high.step, high.value)
                if left + 0.2 * delta < mc < right - 0.2 * delta:
                    middle = mc
                elif left + 0.1 * delta < mq < right - 0.1 * delta:
                    middle = mq
                else:
                    middle = (low.step + high.step) / 2.0
                new = _evaluate(value_and_grad_fn, vec, u, middle)
                dec_err = _decrease_error(new.step, new.value, new.slope, v0, s0)
                err = max(dec_err, _curvature_error(new.slope, s0))
                if dec_err <= 0.0 and new.value < safe.value:
                    safe = new
                done = err <= 0.0
                set_high_to_middle = dec_err > 0.0 or new.value >= low.value
                set_high_to_low = (new.slope * (high.step - low.step) >= 0.0
                                   and not set_high_to_middle)
                cubic = high if (set_high_to_middle or set_high_to_low) else low
                if set_high_to_middle:
                    high = new
                elif set_high_to_low:
                    high = low
                if not set_high_to_middle:
                    low = new
                failed = (count + 1 >= max_steps
                          or (delta <= _STEPSIZE_PRECISION and safe.step > 0.0)) and not done
            cur = new
            count += 1
            if failed and (safe.step > 0.0 or np.isinf(dec_err)):
                cur = safe
        return cur


def lbfgs_step(value_and_grad_fn: ValueAndGrad, vec: torch.Tensor,
               state: LBFGSState) -> torch.Tensor:
    """One iteration of ``oak_tpu``'s L-BFGS loop (``value_and_grad_from_state``,
    ``opt.update``, ``apply_updates``): the value and gradient where the last
    linesearch ended are reused, and evaluated afresh only when that value is
    not finite; ``state`` is updated in place; returns the new vector."""
    if np.isfinite(state.value):
        value, grad, gsq = state.value, state.grad, state.grad_sq
    else:
        v, grad = value_and_grad_fn(vec)
        value, gsq = (np.float64(t) for t in torch.stack(
            [v.to(grad.dtype).reshape(()), torch.dot(grad, grad)]).tolist())
    u = -_direction(state, vec, grad)
    start = _Point(np.float64(0.0), np.float64(value), grad,
                   np.float64(torch.dot(u, grad).item()), np.float64(gsq))
    end = zoom_linesearch(value_and_grad_fn, vec, u, start)
    state.value, state.grad, state.grad_sq = float(end.value), end.grad, float(end.grad_sq)
    state.learning_rate = float(end.step)
    return vec + float(end.step) * u


def lbfgs_parts(value_and_grad_fn: ValueAndGrad, tol: float, memory_size: int = 30):
    """The L-BFGS loop of ``fit_lbfgs`` and the multistart, in parts so that
    callers can run it in bounded chunks: ``(init, run_range, stats)`` with

    - ``init(vec) -> state``
    - ``run_range(vec, state, it, limit) -> (vec, state, it)``: iterate while
      ``it < limit`` and (``it == 0`` or ‖grad‖₂ > tol), ``state`` updated in
      place
    - ``stats(state) -> (value, grad)`` where the last linesearch ended.

    ``value_and_grad_fn(vec) -> (loss, grad)`` evaluates the objective."""

    def init(vec):
        return LBFGSState.init(vec, memory_size)

    def run_range(vec, state, it, limit):
        while it < limit and (it == 0 or math.sqrt(state.grad_sq) > tol):
            vec = lbfgs_step(value_and_grad_fn, vec, state)
            it += 1
        return vec, state, it

    def stats(state):
        return state.value, state.grad

    return init, run_range, stats


def lbfgs_loop(value_and_grad_fn: ValueAndGrad, max_iters: int, tol: float,
               memory_size: int = 30):
    """Single-call form of ``lbfgs_parts``: ``run(vec) -> (vec, value,
    grad, iters)``."""
    init, run_range, stats = lbfgs_parts(value_and_grad_fn, tol, memory_size)

    def run(vec):
        vec, state, it = run_range(vec, init(vec), 0, max_iters)
        return (vec, *stats(state), it)

    return run


def save_lbfgs_state(path, vecs: Sequence[torch.Tensor], states: Sequence[LBFGSState],
                     its: Sequence[int], limit: int) -> None:
    """Write the L-BFGS state of one or more lanes (vector, ``LBFGSState``,
    iterations) and the chunk limit reached to one npz, atomically. The
    port's own layout: optax's state tree is not a format users exchange, so
    an ``oak_tpu`` L-BFGS checkpoint does not load here, nor the reverse."""
    arrays = {"limit": np.asarray(limit), "lanes": np.asarray(len(vecs))}
    for k, (vec, state, it) in enumerate(zip(vecs, states, its)):
        arrays.update(state.arrays(f"{k}."))
        arrays[f"{k}.vec"], arrays[f"{k}.it"] = _numpy(vec), np.asarray(it)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_lbfgs_state(path, like: torch.Tensor
                     ) -> Tuple[List[torch.Tensor], List[LBFGSState], List[int], int]:
    """Inverse of ``save_lbfgs_state``: (vecs, states, iterations, limit),
    the tensors in ``like``'s dtype and on its device."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    lanes = range(int(data["lanes"]))
    vecs = [torch.as_tensor(data[f"{k}.vec"], dtype=like.dtype, device=like.device)
            for k in lanes]
    states = [LBFGSState.from_arrays(data, f"{k}.", like) for k in lanes]
    return vecs, states, [int(data[f"{k}.it"]) for k in lanes], int(data["limit"])


def fit_lbfgs(model, loss_fn: Callable, max_iters: int = 500, tol: float = 1e-8,
              memory_size: int = 30, checkpoint_path=None, checkpoint_every: int = 100,
              resume: bool = True) -> FitResult:
    """L-BFGS with the zoom linesearch (optax's rules, see ``lbfgs_step``)
    over the trainable vector, from the model's current values, for at most
    ``max_iters`` iterations or until ‖grad‖₂ <= tol. The value and gradient
    at each linesearch's end are those of the next iteration: one evaluation
    per linesearch step, none repeated.

    With ``checkpoint_path`` the run goes in chunks of ``checkpoint_every``
    iterations and writes the whole state after each (``save_lbfgs_state``);
    a rerun with the same arguments resumes from the file to the same
    trajectory. A non-finite returned vector reports the loss ``inf``."""
    vec = flatten_trainable(model).detach().clone()

    def value_and_grad_fn(v):
        return value_and_grad(model, loss_fn, v)

    init, run_range, stats = lbfgs_parts(value_and_grad_fn, tol, memory_size)
    state, it = init(vec), 0
    if checkpoint_path is not None:
        if resume and os.path.exists(checkpoint_path):
            (vec,), (state,), (it,), _ = load_lbfgs_state(checkpoint_path, vec)
        chunk = checkpoint_every if checkpoint_every > 0 else 100
        limit = it
        while limit < max_iters:
            limit = min(limit + chunk, max_iters)
            vec, state, it = run_range(vec, state, it, limit)
            save_lbfgs_state(checkpoint_path, [vec], [state], [it], limit)
            if it < limit:
                break  # converged inside the chunk; stays stopped
    else:
        vec, state, it = run_range(vec, state, it, max_iters)
    value, _ = stats(state)
    gnorm = math.sqrt(state.grad_sq)
    if not bool(torch.isfinite(vec).all()):
        value = float("inf")
    assign_trainable(model, vec)
    converged = gnorm <= tol
    msg = (f"gradient norm {gnorm:.3e} <= tol after {it} iterations" if converged else
           f"stopped at max_iters={max_iters} with gradient norm {gnorm:.3e}")
    return FitResult(model=model, fun=float(value), num_iters=it, success=converged,
                     message=msg, grad_norm=gnorm)
