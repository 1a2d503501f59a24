"""Adam over the flat trainable vector (``oak_tpu.optim.fit``, the part the
SVGP training path uses), with mid-training checkpoint and resume.

Every optimizer works on the vector ``params.flatten_trainable`` gives: the
loss is evaluated on views of it through ``params.call_with``, so
non-trainable Params (fixed inducing points, pinned base variances) are
never touched, and the model's own raws are written once, at the end
(``params.assign_trainable``): the model passed in is updated in place and
returned as ``FitResult.model``.

Adam is ``torch.optim.Adam`` with optax's defaults (lr 1e-2, β 0.9 / 0.999,
eps 1e-8), which computes optax's update. Its state is saved under optax's
leaf order (count, mu, nu), so a train state has ``oak_tpu``'s npz layout.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..params import assign_trainable, call_with, flatten_trainable, unflatten_trainable


@dataclasses.dataclass
class FitResult:
    model: object
    fun: float
    num_iters: int
    success: bool
    message: str = ""
    grad_norm: Optional[float] = None
    # the loss at each step's start point, on the model's device (not in
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
    opt = adam(vec, lr)
    losses: List[torch.Tensor] = []

    if batch_fn is not None:
        for i in range(steps):
            losses.append(_adam_step(model, loss_fn, vec, opt, batch_fn(i), mask=False))
        assign_trainable(model, vec.detach())
        v = float(losses[-1]) if losses else float("inf")
        return FitResult(model=model, fun=v, num_iters=steps, success=True,
                         losses=_stack(losses, vec))

    # the masked steps never check the loss and can wander into a
    # non-finite region: keep the best finite iterate; each step's loss is
    # the loss at its PRE-update vector
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
    assign_trainable(model, best_vec)
    return FitResult(model=model, fun=float(best_v), num_iters=steps,
                     success=True, losses=_stack(losses, vec))


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
