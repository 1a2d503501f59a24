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

The layers are spans (``utils.profiling``): ``oak.eval`` each evaluation
of all lanes, ``oak.update`` the optimizer's own work, ``oak.linesearch``
the host linesearch; the counters ``evals.*``, ``lanes.*``,
``host_reads``, ``lbfgs.iters`` and ``lbfgs.trials`` go with them.
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
from ..utils.profiling import count, evaluation, span_steps, spanned, trace_annotation


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
    """Adam on the leaf ``vec`` with optax's defaults; each of its steps is
    the span ``oak.update``, however it is called."""
    return span_steps(torch.optim.Adam([vec], lr=lr, betas=(0.9, 0.999), eps=1e-8),
                      "oak.update")


def host(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a read that waits for the device, counted as
    ``host_reads`` (at its site, whatever the tensor's device)."""
    count("host_reads")
    return t.cpu()


def _leaf(model) -> torch.Tensor:
    return flatten_trainable(model).detach().clone().requires_grad_(True)


def loss_and_grads(model, loss_fn: Callable, raws: Dict[str, torch.Tensor],
                   inputs: Sequence[torch.Tensor], args: Sequence = ()
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """(detached loss, gradients w.r.t. ``inputs``) of ``loss_fn(model,
    *args)`` with the raws of ``raws`` (``params.call_with``). A loss with a
    ``loss_and_grads`` method of its own (``parallel.mesh.MeshLoss``, a sum
    over data shards held by several processes) computes both itself."""
    own = getattr(loss_fn, "loss_and_grads", None)
    if own is not None:
        return own(model, raws, inputs, tuple(args))
    loss = call_with(model, raws, loss_fn, *args)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True, materialize_grads=True)
    return loss.detach(), grads


def value_and_grad(model, loss_fn: Callable, vec: torch.Tensor,
                   *args) -> Tuple[torch.Tensor, torch.Tensor]:
    """(loss, d loss / d vec) of ``loss_fn(model, *args)`` at the trainable
    vector ``vec``; the loss is detached and stays on the device."""
    vec = vec.detach().requires_grad_(True)
    with evaluation("grad", 1):
        loss, (grad,) = loss_and_grads(model, loss_fn, unflatten_trainable(model, vec),
                                       [vec], args)
    return loss, grad


@spanned("oak.update")
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
        v = float(host(losses[-1])) if losses else float("inf")
        return FitResult(model=model, fun=v, num_iters=steps, success=True,
                         losses=_stack(losses, vec))

    best_vec, best_v, losses = adam_best(LaneLoss(model, loss_fn), vec[None], steps, lr)
    assign_trainable(model, best_vec[0])
    return FitResult(model=model, fun=float(host(best_v[0])), num_iters=steps,
                     success=True, losses=losses[:, 0])


class LaneLoss:
    """``loss_fn(model)`` at R lanes of the trainable vector at once: one
    ``torch.func.vmap`` over the lanes of ``grad_and_value`` of the loss of
    one vector (``params.call_with``), so every op of the loss runs once for
    all of them, the fused gram's kernels through their lane axis, as
    ``oak_tpu`` vmaps ``value_and_grad`` over its lanes. A loss with a
    lanes form of its own (``lanes_value_and_grad`` and ``lanes_values``:
    ``parallel.mesh.MeshLoss``, whose collectives cannot run inside vmap)
    evaluates its lanes through it. One lane takes plain autograd (or the
    loss's own ``loss_and_grads``), which computes the same; so does every
    lane, in turn, of a loss whose only entry is a one-vector
    ``loss_and_grads``."""

    def __init__(self, model, loss_fn: Callable):
        self.model, self.loss_fn = model, loss_fn
        self.lanes_form = getattr(loss_fn, "lanes_value_and_grad", None) is not None
        self.vmappable = (getattr(loss_fn, "loss_and_grads", None) is None
                          or self.lanes_form)
        self._grad_and_value = torch.func.vmap(torch.func.grad_and_value(self._loss))
        self._values = torch.func.vmap(self._loss)

    def _loss(self, vec: torch.Tensor) -> torch.Tensor:
        return call_with(self.model, unflatten_trainable(self.model, vec), self.loss_fn)

    def _batched(self, vecs: torch.Tensor) -> bool:
        return self.vmappable and vecs.shape[0] > 1

    def value_and_grad(self, vecs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(losses [R], gradients [R, n]) at the lanes ``vecs`` [R, n],
        detached, on the device."""
        vecs = vecs.detach()
        with evaluation("grad", vecs.shape[0]):
            if not self._batched(vecs):
                return in_turn(lambda v: value_and_grad(self.model, self.loss_fn, v))(vecs)
            if self.lanes_form:
                return self.loss_fn.lanes_value_and_grad(self.model, vecs)
            grads, values = self._grad_and_value(vecs)
            return values.detach(), grads.detach()

    @torch.no_grad()
    def values(self, vecs: torch.Tensor) -> torch.Tensor:
        """The losses [R] at the lanes ``vecs`` [R, n], no gradient."""
        with evaluation("value", vecs.shape[0]):
            if not self._batched(vecs):
                return torch.stack([self._loss(v).reshape(()) for v in vecs])
            if self.lanes_form:
                return self.loss_fn.lanes_values(self.model, vecs.detach())
            return self._values(vecs.detach())


def adam_best(lanes: "LaneLoss", vecs0: torch.Tensor, steps: int, lr: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-batch Adam from the lanes ``vecs0`` [R, n] with non-finite
    gradient entries set to 0, all lanes in one evaluation a step and one
    elementwise Adam on [R, n]: (each lane's best finite iterate [R, n], its
    loss [R], every step's losses [steps, R]). The masked steps never check
    the loss and can wander into a non-finite region, so each lane's best
    finite iterate is kept, tracked on the device with ``torch.where``; each
    step's loss is the loss at its pre-update vector, and the final iterate
    is scored too. A lane with no finite loss gets its start back."""
    vec = vecs0.detach().clone().requires_grad_(True)
    opt = adam(vec, lr)
    losses: List[torch.Tensor] = []
    best_v = torch.full(vec.shape[:1], float("inf"), dtype=vec.dtype, device=vec.device)
    best_vec = vec.detach().clone()

    def consider(v):
        nonlocal best_v, best_vec
        with trace_annotation("oak.update"):
            better = torch.isfinite(v) & (v < best_v)
            best_v = torch.where(better, v, best_v)
            best_vec = torch.where(better[:, None], vec.detach(), best_vec)

    for _ in range(steps):
        v, g = lanes.value_and_grad(vec)
        consider(v)
        vec.grad = finite_or_zero(g)
        opt.step()
        losses.append(v)
    if steps > 0:
        consider(lanes.values(vec))
    return (best_vec, best_v,
            torch.stack(losses) if losses else vec.new_zeros((0, vec.shape[0])).detach())


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
    return host(t.detach()).numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# --------------------------------------------------------------------------- #
# The chunked loop with checkpoints
# --------------------------------------------------------------------------- #
def scan_checkpoint_driver(one_step: Callable, opt: torch.optim.Adam,
                           vec: torch.Tensor, steps: int, batch_args,
                           checkpoint_path, checkpoint_every: int,
                           resume: bool, write: bool = True) -> Tuple[torch.Tensor, int, bool]:
    """Run ``one_step(*args) -> loss`` (which updates ``vec`` and ``opt`` in
    place) for steps start..steps-1, in chunks of ``checkpoint_every``, and
    write (vec, Adam's state, step) after each chunk. With ``resume`` and an
    existing file, ``vec`` and Adam continue from the recorded step and step
    i gets the same ``batch_args`` slice, so the resumed trajectory is the
    uninterrupted one. Returns (last loss, start, ran); ``ran`` is False when
    the checkpoint already covered ``steps``. ``write=False`` reads the file
    but leaves the writing to another process of the same run."""
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
        if checkpoint_path is not None and write:
            save_train_state(checkpoint_path, vec, adam_state(opt, vec), i)
    return v, start, True


def writes_checkpoints(loss_fn: Callable) -> bool:
    """False for a loss whose process leaves checkpoints to another
    (``MeshLoss`` on any rank but its axis's first)."""
    return getattr(loss_fn, "writes_checkpoints", True)


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
                                           checkpoint_path, checkpoint_every, resume,
                                           writes_checkpoints(loss_fn))
    assign_trainable(model, vec.detach())
    if not ran:
        # the checkpoint already covers the requested run: nothing to do,
        # and that is success, not a failed fit
        return FitResult(model=model, fun=float("nan"), num_iters=0, success=True,
                         message=f"checkpoint at step {start} >= steps={steps};"
                                 " nothing to run")
    v = float(host(v))
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
        return float(host(v)), host(g.double()).numpy()

    res = sciopt.minimize(fun, host(vec0.double()).numpy(), jac=True, method=method,
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


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each lane's inner product of the rows of a and b [R, n]: [R]."""
    return torch.linalg.vecdot(a, b)


def _rows(t: torch.Tensor, rows: np.ndarray) -> torch.Tensor:
    """The lanes ``rows`` of t (all of them without a copy)."""
    if len(rows) == t.shape[0] and (rows == np.arange(t.shape[0])).all():
        return t
    return t[torch.as_tensor(rows, device=t.device)]


def _put(t: torch.Tensor, rows: np.ndarray, values: torch.Tensor) -> torch.Tensor:
    """t with its lanes ``rows`` replaced by ``values`` (a new tensor)."""
    return t.index_copy(0, torch.as_tensor(rows, device=t.device), values)


@dataclasses.dataclass
class LBFGSState:
    """optax's L-BFGS state (``scale_by_lbfgs`` and the linesearch's) for R
    lanes, the tensors [R, ...] on the device and the scalars numpy [R] on
    the host: ``count`` updates so far; ``params`` and ``updates`` the
    vector and gradient of the last update; the memory of parameter and
    gradient differences ``S``, ``Y`` [R, m, n] and their weights ``rho``
    [R, m] (1 / ⟨s, y⟩, 0 where that is 0); ``value`` and ``grad`` where the
    last linesearch ended (``value`` inf before the first, so the first
    iteration evaluates), ``grad_sq`` = ‖grad‖², ``learning_rate`` its
    step."""

    count: np.ndarray
    params: torch.Tensor
    updates: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    rho: torch.Tensor
    value: np.ndarray
    grad: torch.Tensor
    grad_sq: np.ndarray
    learning_rate: np.ndarray

    _TENSORS = ("params", "updates", "S", "Y", "rho", "grad")
    _SCALARS = ("count", "value", "grad_sq", "learning_rate")

    @classmethod
    def init(cls, vecs: torch.Tensor, memory_size: int) -> "LBFGSState":
        """The state before the first iteration of the lanes ``vecs`` [R, n]."""
        R = vecs.shape[0]
        z = torch.zeros_like(vecs)
        mem = torch.zeros((R, memory_size) + tuple(vecs.shape[1:]), dtype=vecs.dtype,
                          device=vecs.device)
        return cls(np.zeros(R, np.int64), z, z.clone(), mem, mem.clone(),
                   torch.zeros((R, memory_size), dtype=vecs.dtype, device=vecs.device),
                   np.full(R, np.inf), z.clone(), np.zeros(R), np.ones(R))

    def take(self, rows: np.ndarray) -> "LBFGSState":
        """The state of the lanes ``rows``, as a state of its own."""
        return LBFGSState(**{k: _rows(getattr(self, k), rows) for k in self._TENSORS},
                          **{k: getattr(self, k)[rows].copy() for k in self._SCALARS})

    def put(self, rows: np.ndarray, part: "LBFGSState") -> None:
        """Write ``part``, the state of the lanes ``rows``, back in place."""
        for k in self._TENSORS:
            setattr(self, k, _put(getattr(self, k), rows, getattr(part, k)))
        for k in self._SCALARS:
            getattr(self, k)[rows] = getattr(part, k)

    def arrays(self, prefix: str, lane: int) -> Dict[str, np.ndarray]:
        """Lane ``lane``'s state as named arrays, in the layout of one lane
        of ``save_lbfgs_state``'s file."""
        out = {f"{prefix}{k}": _numpy(getattr(self, k)[lane]) for k in self._TENSORS}
        out.update({f"{prefix}{k}": np.asarray(getattr(self, k)[lane], np.float64)
                    for k in self._SCALARS})
        return out

    @classmethod
    def from_arrays(cls, data, prefixes: Sequence[str], like: torch.Tensor) -> "LBFGSState":
        """The lanes whose arrays ``arrays`` named with ``prefixes``, as one
        state, the tensors in ``like``'s dtype and on its device."""
        kw = dict(dtype=like.dtype, device=like.device)
        tensors = {k: torch.as_tensor(np.stack([data[f"{p}{k}"] for p in prefixes]), **kw)
                   for k in cls._TENSORS}
        scalars = {k: np.array([float(data[f"{p}{k}"]) for p in prefixes])
                   for k in cls._SCALARS}
        scalars["count"] = scalars["count"].astype(np.int64)
        return cls(**tensors, **scalars)


def _direction(state: LBFGSState, vec: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """``scale_by_lbfgs``'s update (transform.py:1676-1751) for every lane
    of ``state`` on the device, [R, n]: store the pair (vec - params, grad
    - updates) with weight 1 / ⟨s, y⟩ (0 where that is 0; nothing is
    skipped), then the two-loop product of the inverse-Hessian estimate
    with grad, its identity scaled by ⟨s, y⟩ / ⟨y, y⟩, or by min(1, 1 /
    ‖grad‖₂) at the first update. Slots never written hold zeros, whose
    terms are exact no-ops, and are skipped. The lanes share their count,
    so the order of the slots is common to them."""
    m = state.rho.shape[1]
    counts = np.unique(state.count)
    if counts.size != 1:
        raise ValueError(f"L-BFGS lanes at different counts {counts.tolist()}")
    k = int(counts[0])
    prev = (k - 1) % m
    if k > 0:
        s, y = vec - state.params, grad - state.updates
        sy = _dot(y, s)
        state.S[:, prev], state.Y[:, prev] = s, y
        state.rho[:, prev] = torch.where(sy == 0.0, torch.zeros_like(sy), 1.0 / sy)
        yy = _dot(y, y)
        scale = torch.where(yy > 0.0, sy / yy, torch.ones_like(yy))
    else:
        state.S[:, prev], state.Y[:, prev], state.rho[:, prev] = 0.0, 0.0, 0.0
        norm = torch.linalg.vector_norm(grad, dim=-1)
        scale = torch.minimum(torch.ones_like(norm), 1.0 / norm)
    written = set(range(m)) if k >= m else set(range(k))
    order = [i for i in ((k % m + j) % m for j in range(m)) if i in written]
    d, alphas = grad, {}
    for i in reversed(order):
        alphas[i] = state.rho[:, i] * _dot(state.S[:, i], d)
        d = d + (-alphas[i])[:, None] * state.Y[:, i]
    d = scale[:, None] * d
    for i in order:
        beta = state.rho[:, i] * _dot(state.Y[:, i], d)
        d = d + (alphas[i] - beta)[:, None] * state.S[:, i]
    state.count, state.params, state.updates = state.count + 1, vec, grad
    return d


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax linesearch.py:455), lane by lane; NaN where there
    is none."""
    a, fa, fpa, b, fb, c, fc = (np.asarray(x, np.float64) for x in (a, fa, fpa, b, fb, c, fc))
    db, dc = b - a, c - a
    denom = (db * dc) ** 2 * (db - dc)
    v1, v2 = fb - fa - fpa * db, fc - fa - fpa * dc
    A = (dc ** 2 * v1 + -(db ** 2) * v2) / denom
    B = (-(dc ** 3) * v1 + db ** 3 * v2) / denom
    return a + (-B + np.sqrt(B * B - 3.0 * A * fpa)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax linesearch.py:496), lane by lane."""
    a, fa, fpa, b, fb = (np.asarray(x, np.float64) for x in (a, fa, fpa, b, fb))
    db = b - a
    return a - fpa / (2.0 * ((fb - fa - fpa * db) / (db ** 2)))


def _decrease_error(stepsize, value, slope, value_init, slope_init):
    """Armijo's error, or Hager and Zhang's approximate one where smaller;
    0 when satisfied, inf when NaN (optax linesearch.py:710), lane by
    lane."""
    armijo = value - value_init - _SLOPE_RTOL * stepsize * slope_init
    approx = np.maximum(slope - (2 * _SLOPE_RTOL - 1.0) * slope_init,
                        value - value_init - _APPROX_DEC_RTOL * np.abs(value_init))
    err = np.maximum(np.minimum(approx, armijo), 0.0)
    return np.where(np.isnan(err), np.inf, err)


def _curvature_error(slope, slope_init):
    err = np.maximum(np.abs(slope) - _CURV_RTOL * np.abs(slope_init), 0.0)
    return np.where(np.isnan(err), np.inf, err)


_FIELDS = ("step", "value", "slope", "grad_sq")


@dataclasses.dataclass
class _Point:
    """Linesearch evaluations of R lanes, each numpy [R] on the host but the
    gradient [R, n]: stepsize, value, gradient, slope along the direction,
    ‖gradient‖²."""

    step: np.ndarray
    value: np.ndarray
    grad: Optional[torch.Tensor]
    slope: np.ndarray
    grad_sq: np.ndarray

    def where(self, mask: np.ndarray, other: "_Point") -> "_Point":
        """Lane by lane, this point where ``mask`` holds and ``other``
        elsewhere (the scalars only)."""
        return _Point(grad=None, **{k: np.where(mask, getattr(self, k), getattr(other, k))
                                    for k in _FIELDS})


def _evaluate(value_and_grad_fn: ValueAndGrad, vec: torch.Tensor, u: torch.Tensor,
              rows: np.ndarray, step: np.ndarray) -> _Point:
    """The loss and gradient of the lanes ``rows`` at vec + step·u: one
    evaluation of those lanes and one host read of their (value, slope,
    ‖grad‖²); ``step`` holds one stepsize a lane."""
    count("lbfgs.trials")
    u = _rows(u, rows)
    at = _rows(vec, rows) + torch.as_tensor(step, dtype=vec.dtype, device=vec.device)[:, None] * u
    value, grad = value_and_grad_fn(at)
    table = host(torch.stack([value.to(grad.dtype).reshape(-1), _dot(grad, u),
                              _dot(grad, grad)], dim=1)).numpy().astype(np.float64)
    return _Point(np.asarray(step, np.float64), table[:, 0], grad, table[:, 1], table[:, 2])


def zoom_linesearch(value_and_grad_fn: ValueAndGrad, vec: torch.Tensor, u: torch.Tensor,
                    start: _Point, max_steps: int = MAX_LINESEARCH_STEPS) -> _Point:
    """optax's ``zoom_linesearch`` (linesearch.py:576-1282) for R lanes from
    ``start`` (step 0) along the directions u [R, n]: the interval search
    from step 1, the cubic, quadratic or bisecting zoom, the
    approximate-decrease switch, and the fallback to the best step with
    sufficient decrease. Every lane takes its own branches, as the vmapped
    ``oak_tpu`` search does; each round evaluates the lanes still searching
    in one call. Returns the points where the lanes end.

    Each round's host arithmetic, before and after its evaluation, is the
    span ``oak.linesearch``; the gradients' bookkeeping on the device is
    ``oak.update``."""
    R = len(start.step)
    with np.errstate(all="ignore"):
        v0, s0 = start.value, start.slope
        cur = start.where(np.ones(R, bool), start)  # the running point
        low = high = cubic = cur  # the interval's ends and the cubic's reference
        safe = cur  # the best step with sufficient decrease (0: none yet)
        cur_grad, safe_grad = start.grad.clone(), start.grad.clone()
        dec_err = np.full(R, np.inf)
        found, done, failed = (np.zeros(R, bool) for _ in range(3))
        count = np.zeros(R, np.int64)
        while True:
            with trace_annotation("oak.linesearch"):
                act = ~(done | failed)
                if not act.any():
                    break
                grow, zoom = act & ~found, act & found
                delta = np.abs(high.step - low.step)
                left, right = np.minimum(high.step, low.step), np.maximum(high.step, low.step)
                mc = _cubicmin(low.step, low.value, low.slope, high.step, high.value,
                               cubic.step, cubic.value)
                mq = _quadmin(low.step, low.value, low.slope, high.step, high.value)
                middle = np.where((left + 0.2 * delta < mc) & (mc < right - 0.2 * delta), mc,
                                  np.where((left + 0.1 * delta < mq) & (mq < right - 0.1 * delta),
                                           mq, (low.step + high.step) / 2.0))
                step = np.where(found, middle, np.where(count == 0, 1.0, _INCREASE * cur.step))
                rows = np.flatnonzero(act)
            got = _evaluate(value_and_grad_fn, vec, u, rows, step[rows])
            with trace_annotation("oak.linesearch"):
                new = cur.where(np.ones(R, bool), cur)
                for k in _FIELDS:
                    getattr(new, k)[rows] = getattr(got, k)
                new_err = _decrease_error(new.step, new.value, new.slope, v0, s0)
                err = np.maximum(new_err, _curvature_error(new.slope, s0))
                dec_err = np.where(act, new_err, dec_err)
                ok = err <= 0.0
                # the interval search
                set_high = (new_err > 0.0) | ((new.value >= cur.value) & (count > 0))
                set_low = (new.slope >= 0.0) & ~set_high
                grow_low = new.where(set_low, cur)
                grow_high = cur.where(set_low, new)
                # the zoom
                high_to_middle = (new_err > 0.0) | (new.value >= low.value)
                high_to_low = (new.slope * (high.step - low.step) >= 0.0) & ~high_to_middle
                zoom_cubic = high.where(high_to_middle | high_to_low, low)
                zoom_high = new.where(high_to_middle, low.where(high_to_low, high))
                zoom_low = low.where(high_to_middle, new)
                to_safe = (grow & (new_err <= 0.0)) | (zoom & (new_err <= 0.0)
                                                       & (new.value < safe.value))
                safe = new.where(to_safe, safe)
                low, high, cubic = (grow_low.where(grow, zoom_low.where(zoom, low)),
                                    grow_high.where(grow, zoom_high.where(zoom, high)),
                                    grow_low.where(grow, zoom_cubic.where(zoom, cubic)))
                last = count + 1 >= max_steps
                failed = np.where(grow, last & ~ok, np.where(
                    zoom, (last | ((delta <= _STEPSIZE_PRECISION) & (safe.step > 0.0))) & ~ok,
                    failed))
                found = np.where(grow, set_high | set_low | ok, found)
                done = np.where(act, ok, done)
                cur = new.where(act, cur)
                count = count + act
                back = act & failed & ((safe.step > 0.0) | np.isinf(dec_err))
                cur = safe.where(back, cur)
            # the gradients of the lanes' running and safe points
            with trace_annotation("oak.update"):
                safe_rows = np.flatnonzero(to_safe[rows])
                if len(safe_rows):
                    safe_grad = _put(safe_grad, rows[safe_rows], _rows(got.grad, safe_rows))
                cur_grad = _put(cur_grad, rows, got.grad)
                if back.any():
                    back_rows = np.flatnonzero(back)
                    cur_grad = _put(cur_grad, back_rows, _rows(safe_grad, back_rows))
        cur.grad = cur_grad
        return cur


def lbfgs_step(value_and_grad_fn: ValueAndGrad, vec: torch.Tensor,
               state: LBFGSState) -> torch.Tensor:
    """One iteration of ``oak_tpu``'s L-BFGS loop (``value_and_grad_from_state``,
    ``opt.update``, ``apply_updates``) for every lane of ``state``: the value
    and gradient where the last linesearch ended are reused, and evaluated
    afresh for the lanes where that value is not finite; ``state`` is
    updated in place; returns the new vectors [R, n]. ``value_and_grad_fn``
    takes lanes [r, n] to (losses [r], gradients [r, n])."""
    count("lbfgs.iters")
    value, grad, gsq = state.value.copy(), state.grad, state.grad_sq.copy()
    fresh = np.flatnonzero(~np.isfinite(value))
    if len(fresh):
        count("lbfgs.trials")
        v, g = value_and_grad_fn(_rows(vec, fresh))
        read = host(torch.stack([v.to(g.dtype).reshape(-1), _dot(g, g)], dim=1)).numpy()
        value[fresh], gsq[fresh] = read[:, 0], read[:, 1]
        grad = _put(grad, fresh, g)
    with trace_annotation("oak.update"):
        u = -_direction(state, vec, grad)
        slope = host(_dot(u, grad)).numpy().astype(np.float64)
    start = _Point(np.zeros(len(value)), value.astype(np.float64), grad, slope,
                   gsq.astype(np.float64))
    end = zoom_linesearch(value_and_grad_fn, vec, u, start)
    state.value, state.grad, state.grad_sq = end.value, end.grad, end.grad_sq
    state.learning_rate = end.step
    with trace_annotation("oak.update"):
        return vec + torch.as_tensor(end.step, dtype=vec.dtype, device=vec.device)[:, None] * u


def lbfgs_lanes(value_and_grad_fn: ValueAndGrad, tol: float, memory_size: int = 30):
    """The L-BFGS loop of ``fit_lbfgs`` and the multistart over R lanes, in
    parts so that callers can run it in bounded chunks: ``(init, run_range,
    stats)`` with

    - ``init(vecs) -> state`` for the lanes ``vecs`` [R, n]
    - ``run_range(vecs, state, its, limit) -> (vecs, state, its)``: each
      lane iterates while its ``it < limit`` and (``it == 0`` or ‖grad‖₂ >
      tol); a lane that stops is frozen, as ``oak_tpu``'s vmapped while
      loop masks it, and the others go on. ``its`` are numpy [R]; ``state``
      is updated in place
    - ``stats(state) -> (values, grads)`` where the last linesearches ended.

    ``value_and_grad_fn(vecs) -> (losses, grads)`` evaluates lanes [r, n]
    (``LaneLoss.value_and_grad``): one call per linesearch step for all the
    lanes still searching."""

    def init(vecs):
        return LBFGSState.init(vecs, memory_size)

    def run_range(vecs, state, its, limit):
        its = np.array(its, np.int64)
        while True:
            active = (its < limit) & ((its == 0) | (np.sqrt(state.grad_sq) > tol))
            if not active.any():
                break
            if active.all():
                vecs = lbfgs_step(value_and_grad_fn, vecs, state)
            else:
                rows = np.flatnonzero(active)
                part = state.take(rows)
                vecs = _put(vecs, rows, lbfgs_step(value_and_grad_fn, _rows(vecs, rows), part))
                state.put(rows, part)
            its = its + active
        return vecs, state, its

    def stats(state):
        return state.value, state.grad

    return init, run_range, stats


def in_turn(value_and_grad_fn: ValueAndGrad) -> ValueAndGrad:
    """A function of one vector [n] -> (loss, grad) as one of lanes [r, n],
    evaluating them one after another."""

    def lanes(vecs):
        out = [value_and_grad_fn(v) for v in vecs]
        return (torch.stack([v.reshape(()) for v, _ in out]),
                torch.stack([g for _, g in out]))

    return lanes


def lbfgs_parts(value_and_grad_fn: ValueAndGrad, tol: float, memory_size: int = 30):
    """``lbfgs_lanes`` for one vector: ``(init, run_range, stats)`` with

    - ``init(vec) -> state``
    - ``run_range(vec, state, it, limit) -> (vec, state, it)``
    - ``stats(state) -> (value, grad)``

    where ``value_and_grad_fn(vec) -> (loss, grad)`` evaluates one vector."""
    init, run_range, stats = lbfgs_lanes(in_turn(value_and_grad_fn), tol, memory_size)

    def run_one(vec, state, it, limit):
        vecs, state, its = run_range(vec[None], state, [it], limit)
        return vecs[0], state, int(its[0])

    def stats_one(state):
        value, grad = stats(state)
        return float(value[0]), grad[0]

    return lambda vec: init(vec[None]), run_one, stats_one


def lbfgs_loop(value_and_grad_fn: ValueAndGrad, max_iters: int, tol: float,
               memory_size: int = 30):
    """Single-call form of ``lbfgs_parts``: ``run(vec) -> (vec, value,
    grad, iters)``."""
    init, run_range, stats = lbfgs_parts(value_and_grad_fn, tol, memory_size)

    def run(vec):
        vec, state, it = run_range(vec, init(vec), 0, max_iters)
        return (vec, *stats(state), it)

    return run


def save_lbfgs_state(path, vecs: torch.Tensor, state: LBFGSState, its: Sequence[int],
                     limit: int) -> None:
    """Write the L-BFGS state of R lanes (vectors [R, n], ``LBFGSState``,
    iterations) and the chunk limit reached to one npz, atomically, one
    lane's arrays after another under the prefix "k.". The port's own
    layout: optax's state tree is not a format users exchange, so an
    ``oak_tpu`` L-BFGS checkpoint does not load here, nor the reverse."""
    arrays = {"limit": np.asarray(limit), "lanes": np.asarray(len(vecs))}
    for k in range(len(vecs)):
        arrays.update(state.arrays(f"{k}.", k))
        arrays[f"{k}.vec"], arrays[f"{k}.it"] = _numpy(vecs[k]), np.asarray(its[k])
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_lbfgs_state(path, like: torch.Tensor
                     ) -> Tuple[torch.Tensor, LBFGSState, np.ndarray, int]:
    """Inverse of ``save_lbfgs_state``: (vecs [R, n], state, iterations
    [R], limit), the tensors in ``like``'s dtype and on its device."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    prefixes = [f"{k}." for k in range(int(data["lanes"]))]
    vecs = torch.as_tensor(np.stack([data[f"{p}vec"] for p in prefixes]), dtype=like.dtype,
                           device=like.device)
    its = np.array([int(data[f"{p}it"]) for p in prefixes], np.int64)
    return vecs, LBFGSState.from_arrays(data, prefixes, like), its, int(data["limit"])


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
    init, run_range, stats = lbfgs_parts(lambda v: value_and_grad(model, loss_fn, v), tol,
                                         memory_size)
    state, it = init(vec), 0
    if checkpoint_path is not None:
        if resume and os.path.exists(checkpoint_path):
            vecs, state, its, _ = load_lbfgs_state(checkpoint_path, vec)
            vec, it = vecs[0], int(its[0])
        chunk = checkpoint_every if checkpoint_every > 0 else 100
        limit = it
        while limit < max_iters:
            limit = min(limit + chunk, max_iters)
            vec, state, it = run_range(vec, state, it, limit)
            save_lbfgs_state(checkpoint_path, vec[None], state, [it], limit)
            if it < limit:
                break  # converged inside the chunk; stays stopped
    else:
        vec, state, it = run_range(vec, state, it, max_iters)
    value, _ = stats(state)
    gnorm = math.sqrt(state.grad_sq[0])
    if not bool(host(torch.isfinite(vec).all())):
        value = float("inf")
    assign_trainable(model, vec)
    converged = gnorm <= tol
    msg = (f"gradient norm {gnorm:.3e} <= tol after {it} iterations" if converged else
           f"stopped at max_iters={max_iters} with gradient norm {gnorm:.3e}")
    return FitResult(model=model, fun=float(value), num_iters=it, success=converged,
                     message=msg, grad_norm=gnorm)
