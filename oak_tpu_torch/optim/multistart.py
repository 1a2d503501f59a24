"""Multi-start optimisation (``oak_tpu.optim.multistart``): K jittered
initialisations of the trainable vector are each optimised, and the best
accepted one is kept.

``oak_tpu`` runs the lanes as one batched program (a vmapped L-BFGS, a
batched Adam scan). Here the lanes run one after another, each as its own
vector through ``params.call_with``, with the model left as it was until the
end. The lanes are independent and Adam is elementwise, so every lane's
trajectory and the selection are ``oak_tpu``'s. Running the lanes together
through the fused gram kernels is ROADMAP perf work.

``mesh=`` (a ``DeviceMesh``) shards the lanes: each of its ranks runs a
contiguous block of them, and the lanes' vectors and losses are then
gathered so that every rank picks the same best (``parallel``). A mesh of
(restart, data) axes, whose ranks also shard each lane's data, is
``parallel.fit_lbfgs_multistart_sharded``.
"""

from __future__ import annotations

import copy
import math
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..params import assign_trainable, call_with, flatten_trainable, unflatten_trainable
from .fit import (FitResult, LBFGSState, _adam_step, adam, adam_best, lbfgs_parts,
                  load_lbfgs_state, save_lbfgs_state, value_and_grad, writes_checkpoints)
from .natgrad import natgrad_adam_step, warn_if_q_diag


def _make_starts(vec0: torch.Tensor, n_starts: int, jitter: float, seed: int,
                 include_init: bool) -> torch.Tensor:
    """[n_starts, n] starts: vec0 plus jitter times standard normals from
    ``default_rng(seed)``, drawn as ``oak_tpu`` draws them (so the starts
    are bitwise equal); the first is vec0 itself with ``include_init``."""
    rng = np.random.default_rng(seed)
    v0 = vec0.detach().cpu().numpy()
    starts = v0[None, :] + jitter * rng.standard_normal(
        (n_starts, v0.shape[0])).astype(v0.dtype)
    if include_init and n_starts > 0:
        starts[0] = v0
    return torch.as_tensor(starts, dtype=vec0.dtype, device=vec0.device)


def _lanes(mesh, n_starts: int):
    """(this rank's block of lanes, the lane axis): the lanes split over
    every rank of ``mesh`` (a ``DeviceMesh``, or a ``parallel.mesh.Axis``);
    all of them and None without a mesh."""
    if mesh is None:
        return slice(0, n_starts), None
    from ..parallel.mesh import Axis

    axis = mesh if isinstance(mesh, Axis) else Axis.whole(mesh)
    if n_starts % axis.size:
        raise ValueError(f"n_starts={n_starts} must be divisible by the mesh size "
                         f"{axis.size}")
    return axis.rows(n_starts), axis


def _gather_lanes(axis, n_starts: int, vecs: Sequence[torch.Tensor], *columns):
    """Every lane's vector and numbers (one sequence per column) on every
    rank of the lane axis, from each rank's block; as given without one."""
    if axis is None:
        return (list(vecs), *[list(c) for c in columns])
    v = torch.stack(list(vecs))
    numbers = torch.as_tensor(np.asarray(columns, np.float64).reshape(len(columns), -1).T,
                              device=v.device)
    table = axis.gather_rows(torch.cat([v.double(), numbers], dim=1), n_starts)
    n = v.shape[1]
    cols = table[:, n:].cpu().numpy().T
    return (list(table[:, :n].to(v.dtype)), *[list(c) for c in cols])


def _any(axis, flag: bool, device) -> bool:
    """``flag`` on any rank of the axis (every rank takes the same branch)."""
    if axis is None:
        return flag
    return bool(axis.all_reduce(torch.tensor([float(flag)], device=device)).item() > 0)


def _pack_state(vec: torch.Tensor, state: LBFGSState, it: int) -> torch.Tensor:
    scalars = [state.count, state.value, state.grad_sq, state.learning_rate, it]
    return torch.cat([vec.double()] + [getattr(state, k).double().reshape(-1)
                                      for k in LBFGSState._TENSORS]
                     + [torch.tensor(scalars, dtype=torch.float64, device=vec.device)])


def _unpack_state(row: torch.Tensor, like: torch.Tensor, memory_size: int):
    n = like.shape[0]
    sizes = [n, n, n, memory_size * n, memory_size * n, memory_size, n, 5]
    vec, params, updates, S, Y, rho, grad, scalars = torch.split(row, sizes)
    kw = dict(dtype=like.dtype)
    count, value, grad_sq, lr, it = scalars.tolist()
    state = LBFGSState(int(count), params.to(**kw), updates.to(**kw),
                       S.view(memory_size, n).to(**kw), Y.view(memory_size, n).to(**kw),
                       rho.to(**kw), value, grad.to(**kw), grad_sq, lr)
    return vec.to(**kw), state, int(it)


def _gather_states(axis, n_starts: int, vecs, states, its, like: torch.Tensor,
                   memory_size: int):
    """Every lane's (vector, L-BFGS state, iterations), for a checkpoint."""
    if axis is None:
        return vecs, states, its
    table = axis.gather_rows(torch.stack([_pack_state(v, s, i)
                                          for v, s, i in zip(vecs, states, its)]), n_starts)
    lanes = [_unpack_state(row, like, memory_size) for row in table]
    return tuple(list(x) for x in zip(*lanes))


def model_at(model, vec: torch.Tensor):
    """A copy of ``model`` holding the trainable vector ``vec``; ``model``
    is not touched."""
    return assign_trainable(copy.deepcopy(model), vec)


@torch.no_grad()
def _loss_at(model, loss_fn: Callable, vec: torch.Tensor) -> float:
    return float(call_with(model, unflatten_trainable(model, vec), loss_fn))


def _pick_best(vecs: Sequence[torch.Tensor], values: np.ndarray, model,
               accept_fn: Optional[Callable]) -> int:
    """The best lane by loss whose model ``accept_fn`` accepts (each
    candidate judged on its own copy of the model), or the best overall when
    no finite lane is accepted."""
    order = np.argsort(values, kind="stable")
    best = int(order[0])
    if accept_fn is not None:
        for i in order:
            if not np.isfinite(values[i]):
                break
            if accept_fn(model_at(model, vecs[i])):
                best = int(i)
                break
    return best


def _finish_multistart(vecs: Sequence[torch.Tensor], values, model,
                       accept_fn: Optional[Callable], kind: str, num_iters,
                       gnorms: Optional[Sequence[float]] = None,
                       tol: float = 0.0) -> FitResult:
    """Write the best accepted lane into ``model`` and report it; with every
    lane diverged, ``model`` stays as it was and ``fun`` is inf.
    ``num_iters``: one count, or one per lane; with ``gnorms``, the chosen
    lane has succeeded when its gradient norm is at most ``tol``.
    ``FitResult.losses`` holds each lane's loss (inf where not finite), on
    the host."""
    values = np.asarray(values, np.float64)
    values = np.where(np.isfinite(values), values, np.inf)
    label = f"parallel {kind} restarts" if kind else "parallel restarts"
    lanes = torch.as_tensor(values)
    if not np.isfinite(values).any():
        return FitResult(model=model, fun=float("inf"), num_iters=0, success=False,
                         message=f"all {len(vecs)} {label} diverged", losses=lanes)
    best = _pick_best(vecs, values, model, accept_fn)
    assign_trainable(model, vecs[best])
    gnorm = None if gnorms is None else float(gnorms[best])
    msg = (f"best of {len(vecs)} {label} (losses: "
           + ", ".join(f"{v:.4g}" for v in values) + ")")
    return FitResult(model=model, fun=float(values[best]),
                     num_iters=num_iters[best] if isinstance(num_iters, list) else num_iters,
                     success=gnorm is None or gnorm <= tol, message=msg, grad_norm=gnorm,
                     losses=lanes)


def fit_lbfgs_multistart(model, loss_fn: Callable, n_starts: int = 4, jitter: float = 0.3,
                         seed: int = 0, max_iters: int = 500, tol: float = 1e-8,
                         memory_size: int = 30, warm_adam_steps: int = 0,
                         warm_lr: float = 2e-2, include_init: bool = True,
                         accept_fn: Optional[Callable] = None, mesh=None,
                         chunk_iters: Optional[int] = None, checkpoint_path=None,
                         resume: bool = True) -> FitResult:
    """Optimise ``loss_fn(model)`` from ``n_starts`` jittered starts; write
    the best accepted lane into ``model`` and return it.

    - ``warm_adam_steps``: Adam before L-BFGS, each lane handed its best
      finite iterate (``fit.adam_best``);
    - ``accept_fn(model) -> bool``: the best accepted lane by loss wins,
      else the best overall;
    - ``mesh``: each rank of the mesh runs its block of lanes (``n_starts``
      divisible by the mesh size);
    - ``checkpoint_path``: every lane's whole state is written after each
      chunk of ``chunk_iters`` iterations (100 by default), by the mesh's
      first rank; a rerun resumes to the same result.

    Each lane's loss is evaluated afresh at its returned vector (inf where
    the vector or the loss is not finite). If every lane diverged, ``model``
    is returned untouched with ``fun=inf``. The lanes' losses are in
    ``FitResult.losses`` and ``message``."""
    vec0 = flatten_trainable(model).detach()
    starts = _make_starts(vec0, n_starts, jitter, seed, include_init)
    lanes, axis = _lanes(mesh, n_starts)
    write = writes_checkpoints(loss_fn) and (axis is None or axis.is_first)

    def value_and_grad_fn(v):
        return value_and_grad(model, loss_fn, v)

    init, run_range, _ = lbfgs_parts(value_and_grad_fn, tol, memory_size)
    chunk = chunk_iters or 100
    limit = 0
    if checkpoint_path is not None and resume and os.path.exists(checkpoint_path):
        vecs, states, its, limit = load_lbfgs_state(checkpoint_path, vec0)
        vecs, states, its = vecs[lanes], states[lanes], its[lanes]
    else:
        vecs: List[torch.Tensor] = [
            adam_best(model, loss_fn, s, warm_adam_steps, warm_lr)[0]
            if warm_adam_steps > 0 else s for s in starts[lanes]]
        states: List[LBFGSState] = [init(v) for v in vecs]
        its = [0] * len(vecs)
    while limit < max_iters:
        limit = min(limit + chunk, max_iters)
        for k in range(len(vecs)):
            vecs[k], states[k], its[k] = run_range(vecs[k], states[k], its[k], limit)
        if checkpoint_path is not None:
            every = _gather_states(axis, n_starts, vecs, states, its, vec0, memory_size)
            if write:
                save_lbfgs_state(checkpoint_path, *every, limit)
        # a lane stopped below the limit has converged and stays stopped
        if not _any(axis, any(it >= limit for it in its), vec0.device):
            break

    # the loss OF each returned vector, not the state's last accepted value,
    # which stays finite when a lane's last update poisoned its vector
    values = [_loss_at(model, loss_fn, v) if bool(torch.isfinite(v).all()) else np.inf
              for v in vecs]
    vecs, values, gnorms, its = _gather_lanes(
        axis, n_starts, vecs, values, [math.sqrt(s.grad_sq) for s in states], its)
    return _finish_multistart(vecs, values, model, accept_fn, "", [int(i) for i in its],
                              gnorms=gnorms, tol=tol)


def fit_adam_multistart(model, loss_fn: Callable, n_starts: int = 4, jitter: float = 0.3,
                        seed: int = 0, steps: int = 1000, lr: float = 1e-2,
                        include_init: bool = True,
                        accept_fn: Optional[Callable] = None, mesh=None) -> FitResult:
    """K jittered Adam runs (non-finite gradient entries set to 0); the
    best accepted lane by the loss at its last iterate wins. ``mesh``: each
    rank runs its block of lanes."""
    vec0 = flatten_trainable(model).detach()
    lanes, axis = _lanes(mesh, n_starts)
    vecs, values = [], []
    for s in _make_starts(vec0, n_starts, jitter, seed, include_init)[lanes]:
        vec = s.clone().requires_grad_(True)
        opt = adam(vec, lr)
        for _ in range(steps):
            _adam_step(model, loss_fn, vec, opt)
        vecs.append(vec.detach())
        values.append(_loss_at(model, loss_fn, vecs[-1]))
    vecs, values = _gather_lanes(axis, n_starts, vecs, values)
    return _finish_multistart(vecs, values, model, accept_fn, "adam", steps)


def fit_natgrad_multistart(model, loss_fn: Callable, n_starts: int = 4,
                           jitter: float = 0.3, seed: int = 0, steps: int = 200,
                           gamma: float = 0.1, hyper_lr: float = 1e-2,
                           include_init: bool = True,
                           accept_fn: Optional[Callable] = None, mesh=None,
                           staggered: bool = False) -> FitResult:
    """K jittered natgrad + Adam runs through ``natgrad.natgrad_adam_step``,
    the update the single-start optimisers run; the best accepted lane by
    the loss at its last iterate wins. ``mesh``: each rank runs its block
    of lanes."""
    warn_if_q_diag(model)
    vec0 = flatten_trainable(model).detach()
    lanes, axis = _lanes(mesh, n_starts)
    vecs, values = [], []
    for s in _make_starts(vec0, n_starts, jitter, seed, include_init)[lanes]:
        vec = s.clone().requires_grad_(True)
        step = natgrad_adam_step(adam(vec, hyper_lr), vec, model, loss_fn, gamma,
                                 staggered=staggered)
        for _ in range(steps):
            step()
        vecs.append(vec.detach())
        values.append(_loss_at(model, loss_fn, vecs[-1]))
    vecs, values = _gather_lanes(axis, n_starts, vecs, values)
    return _finish_multistart(vecs, values, model, accept_fn, "natgrad", steps)
