"""Multi-start optimisation (``oak_tpu.optim.multistart``): K jittered
initialisations of the trainable vector are each optimised, and the best
accepted one is kept.

The lanes run as one batched program, as ``oak_tpu``'s do: every step
evaluates the loss and gradient of all of a rank's lanes in one
``torch.func.vmap`` of ``grad_and_value`` over the flat trainable vector
(``fit.LaneLoss``), so each op of the loss runs once for all lanes, and the
fused gram's CUDA kernels launch once per gram through their lane axis.
Adam is elementwise on [lanes, n]; L-BFGS is ``fit.lbfgs_lanes``, one
definition over lanes whose linesearch takes each lane's branches on the
host and evaluates the lanes still searching in one call, and whose
stopped lanes stay frozen. The model is left as it was until the end, and
every lane's trajectory and the selection are ``oak_tpu``'s.

``mesh=`` (a ``DeviceMesh``) shards the lanes: each of its ranks runs a
contiguous block of them, and the lanes' vectors and losses are then
gathered so that every rank picks the same best (``parallel``). A mesh of
(restart, data) axes, whose ranks also shard each lane's data, is
``parallel.fit_lbfgs_multistart_sharded``: its loss (``parallel.mesh.MeshLoss``)
evaluates the rank's lanes in one vmapped program too, with its two
all-reduces outside the transforms, each over all the lanes.
"""

from __future__ import annotations

import copy
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..params import assign_trainable, flatten_trainable
from .fit import (FitResult, LaneLoss, LBFGSState, adam, adam_best, finite_or_zero, host,
                  lbfgs_lanes, load_lbfgs_state, save_lbfgs_state, writes_checkpoints)
from .natgrad import natgrad_lanes_step, warn_if_q_diag


def _make_starts(vec0: torch.Tensor, n_starts: int, jitter: float, seed: int,
                 include_init: bool) -> torch.Tensor:
    """[n_starts, n] starts: vec0 plus jitter times standard normals from
    ``default_rng(seed)``, drawn as ``oak_tpu`` draws them (so the starts
    are bitwise equal); the first is vec0 itself with ``include_init``."""
    rng = np.random.default_rng(seed)
    v0 = host(vec0.detach()).numpy()
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


def _gather_lanes(axis, n_starts: int, vecs: torch.Tensor, *columns):
    """Every lane's vector [n_starts, n] and numbers (one sequence per
    column) on every rank of the lane axis, from each rank's block; as
    given without one."""
    if axis is None:
        return (vecs, *[list(c) for c in columns])
    numbers = torch.as_tensor(np.asarray(columns, np.float64).reshape(len(columns), -1).T,
                              device=vecs.device)
    table = axis.gather_rows(torch.cat([vecs.double(), numbers], dim=1), n_starts)
    n = vecs.shape[1]
    cols = host(table[:, n:]).numpy().T
    return (table[:, :n].to(vecs.dtype), *[list(c) for c in cols])


def _any(axis, flag: bool, device) -> bool:
    """``flag`` on any rank of the axis (every rank takes the same branch)."""
    if axis is None:
        return flag
    return bool(host(axis.all_reduce(torch.tensor([float(flag)], device=device))).item() > 0)


def _pack_state(vecs: torch.Tensor, state: LBFGSState, its) -> torch.Tensor:
    """Each lane's vector, L-BFGS state and iterations as one float64 row."""
    scalars = np.stack([state.count, state.value, state.grad_sq, state.learning_rate,
                        np.asarray(its)], axis=1).astype(np.float64)
    R = vecs.shape[0]
    return torch.cat([vecs.double()] + [getattr(state, k).double().reshape(R, -1)
                                        for k in LBFGSState._TENSORS]
                     + [torch.as_tensor(scalars, device=vecs.device)], dim=1)


def _unpack_state(table: torch.Tensor, like: torch.Tensor, memory_size: int):
    R, n = table.shape[0], like.shape[0]
    sizes = [n, n, n, memory_size * n, memory_size * n, memory_size, n, 5]
    vecs, params, updates, S, Y, rho, grad, scalars = torch.split(table, sizes, dim=1)
    kw = dict(dtype=like.dtype)
    count, value, grad_sq, lr, its = host(scalars).numpy().T
    state = LBFGSState(count.astype(np.int64), params.to(**kw), updates.to(**kw),
                       S.reshape(R, memory_size, n).to(**kw),
                       Y.reshape(R, memory_size, n).to(**kw), rho.to(**kw), value.copy(),
                       grad.to(**kw), grad_sq.copy(), lr.copy())
    return vecs.to(**kw), state, its.astype(np.int64)


def _gather_states(axis, n_starts: int, vecs, state, its, like: torch.Tensor,
                   memory_size: int):
    """Every lane's (vector, L-BFGS state, iterations), for a checkpoint."""
    if axis is None:
        return vecs, state, its
    table = axis.gather_rows(_pack_state(vecs, state, its), n_starts)
    return _unpack_state(table, like, memory_size)


def model_at(model, vec: torch.Tensor):
    """A copy of ``model`` holding the trainable vector ``vec``; ``model``
    is not touched."""
    return assign_trainable(copy.deepcopy(model), vec)


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
    loss = LaneLoss(model, loss_fn)
    init, run_range, _ = lbfgs_lanes(loss.value_and_grad, tol, memory_size)
    chunk = chunk_iters or 100
    limit = 0
    if checkpoint_path is not None and resume and os.path.exists(checkpoint_path):
        vecs, state, its, limit = load_lbfgs_state(checkpoint_path, vec0)
        rows = np.arange(n_starts)[lanes]
        vecs, state, its = vecs[lanes], state.take(rows), its[rows]
    else:
        vecs = starts[lanes]
        if warm_adam_steps > 0:
            vecs = adam_best(loss, vecs, warm_adam_steps, warm_lr)[0]
        state, its = init(vecs), np.zeros(vecs.shape[0], np.int64)
    while limit < max_iters:
        limit = min(limit + chunk, max_iters)
        vecs, state, its = run_range(vecs, state, its, limit)
        if checkpoint_path is not None:
            every = _gather_states(axis, n_starts, vecs, state, its, vec0, memory_size)
            if write:
                save_lbfgs_state(checkpoint_path, *every, limit)
        # a lane stopped below the limit has converged and stays stopped
        if not _any(axis, bool((its >= limit).any()), vec0.device):
            break

    vecs, values, gnorms, its = _gather_lanes(
        axis, n_starts, vecs, _final_losses(loss, vecs), np.sqrt(state.grad_sq), its)
    return _finish_multistart(vecs, values, model, accept_fn, "", [int(i) for i in its],
                              gnorms=gnorms, tol=tol)


def _final_losses(loss: LaneLoss, vecs: torch.Tensor) -> np.ndarray:
    """The loss OF each lane's returned vector, not the state's last
    accepted value, which stays finite when a lane's last update poisoned
    its vector: inf where the vector is not finite."""
    finite = host(torch.isfinite(vecs).all(dim=1)).numpy()
    values = np.full(vecs.shape[0], np.inf)
    rows = np.flatnonzero(finite)
    if len(rows):
        values[rows] = host(loss.values(vecs[torch.as_tensor(rows, device=vecs.device)])).numpy()
    return values


def fit_adam_multistart(model, loss_fn: Callable, n_starts: int = 4, jitter: float = 0.3,
                        seed: int = 0, steps: int = 1000, lr: float = 1e-2,
                        include_init: bool = True,
                        accept_fn: Optional[Callable] = None, mesh=None) -> FitResult:
    """K jittered Adam runs (non-finite gradient entries set to 0), all of a
    rank's lanes in one evaluation a step and one elementwise Adam on
    [lanes, n]; the best accepted lane by the loss at its last iterate wins.
    ``mesh``: each rank runs its block of lanes."""
    vec0 = flatten_trainable(model).detach()
    lanes, axis = _lanes(mesh, n_starts)
    loss = LaneLoss(model, loss_fn)
    vecs = _make_starts(vec0, n_starts, jitter, seed, include_init)[lanes].clone().requires_grad_(True)
    opt = adam(vecs, lr)
    for _ in range(steps):
        vecs.grad = finite_or_zero(loss.value_and_grad(vecs)[1])
        opt.step()
    vecs = vecs.detach()
    vecs, values = _gather_lanes(axis, n_starts, vecs, host(loss.values(vecs)).numpy())
    return _finish_multistart(vecs, values, model, accept_fn, "adam", steps)


def fit_natgrad_multistart(model, loss_fn: Callable, n_starts: int = 4,
                           jitter: float = 0.3, seed: int = 0, steps: int = 200,
                           gamma: float = 0.1, hyper_lr: float = 1e-2,
                           include_init: bool = True,
                           accept_fn: Optional[Callable] = None, mesh=None,
                           staggered: bool = False) -> FitResult:
    """K jittered natgrad + Adam runs through ``natgrad.natgrad_lanes_step``,
    the update the single-start optimisers run vmapped over the lanes: all
    of a rank's lanes in one evaluation a step; the best accepted lane by
    the loss at its last iterate wins. ``mesh``: each rank runs its block of
    lanes."""
    warn_if_q_diag(model)
    vec0 = flatten_trainable(model).detach()
    lanes, axis = _lanes(mesh, n_starts)
    vecs = _make_starts(vec0, n_starts, jitter, seed, include_init)[lanes].clone().requires_grad_(True)
    step = natgrad_lanes_step(adam(vecs, hyper_lr), vecs, model, loss_fn, gamma,
                              staggered=staggered)
    for _ in range(steps):
        step()
    vecs = vecs.detach()
    values = host(LaneLoss(model, loss_fn).values(vecs)).numpy()
    vecs, values = _gather_lanes(axis, n_starts, vecs, values)
    return _finish_multistart(vecs, values, model, accept_fn, "natgrad", steps)
