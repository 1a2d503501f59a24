"""Data- and restart-parallel training, prediction and the process mesh
(``oak_tpu.parallel.sharding``), on ``torch.distributed``.

``oak_tpu`` is single-controller: one process holds a ``jax.sharding.Mesh``
and XLA inserts the psums. The port is SPMD: one process per device
(``torchrun --nproc-per-node=K``, NCCL between cards, gloo on the CPU), each
calling the same function with the same full host arrays and the same
model, and a ``torch.distributed.device_mesh.DeviceMesh`` with named axes in
place of the JAX mesh. Every rank gets what ``oak_tpu``'s sharded function
gives, the unsharded result up to reduction order.

The natural axis is N: the inducing points and hyperparameters are small
and replicated, and the [*, N] grams and the per-row terms of each loss are
computed shard-local (each model's ``elbo_terms``; GPR gathers its gram's
rows), reduced, and finished on every rank (``mesh.MeshLoss``). The gradient
counts the replicated tail once. M-sharding (a distributed Cholesky of Kuu)
is not needed at the reference's M <= 512.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..models import GPR, SGPR, SVGP
from ..optim.fit import (FitResult, _adam_step, adam, adam_state, fit_lbfgs,
                         set_adam_state)
from ..params import flatten_trainable
from .mesh import DATA_AXIS, Axis, MeshLoss


def _init_from_env() -> None:
    """The default process group from ``torchrun``'s environment (NCCL with
    a card, gloo without); a world of one when there is no such environment
    and at most one card is visible."""
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend)
        return
    if torch.cuda.device_count() > 1:
        raise RuntimeError(
            f"{torch.cuda.device_count()} cards are visible, but no process group is "
            "initialised and there is no torchrun environment: launch one process per "
            "card with torchrun --nproc-per-node=K")
    if backend == "nccl":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS) -> DeviceMesh:
    """A 1-D mesh named ``axis`` over the first ``n_devices`` ranks (all by
    default), on the process group already initialised or one initialised
    from ``torchrun``'s environment. With NCCL each rank's device becomes
    ``cuda:{LOCAL_RANK}``. Every process calls it; a rank outside the mesh
    then calls no sharded function on it."""
    if not dist.is_initialized():
        _init_from_env()
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n_devices} for a world of {world} processes; "
                         f"launch with torchrun --nproc-per-node={n}")
    nccl = dist.get_backend() == "nccl"
    if nccl:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())))
    return DeviceMesh("cuda" if nccl else "cpu", list(range(n)), mesh_dim_names=(axis,))


def shard_batch(mesh: DeviceMesh, *arrays, axis: str = DATA_AXIS):
    """This rank's contiguous block of rows of each array (``oak_tpu``'s
    ``P(axis)`` in device order); every rank passes the same full arrays.
    The leading dimension must be divisible by the axis's size."""
    ax = Axis.of(mesh, axis)
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.shape[0] % ax.size:
            raise ValueError(f"leading dimension {t.shape[0]} must be divisible by the "
                             f"mesh's '{axis}' axis size {ax.size}")
        out.append(t[ax.rows(t.shape[0])])
    return tuple(out) if len(out) > 1 else out[0]


def replicate(mesh: DeviceMesh, tree):
    """``tree`` (a tensor, a module, or lists, tuples and dicts of them) as
    the mesh's first rank holds it, on every rank of the mesh: tensors are
    broadcast into new tensors, a module's parameters and buffers in place."""
    ax = Axis.whole(mesh)

    def bcast(t):
        out = t.detach().clone().contiguous()
        dist.broadcast(out, src=ax.first, group=ax.group)
        return out

    def walk(x):
        if isinstance(x, torch.Tensor):
            return bcast(x)
        if isinstance(x, nn.Module):
            with torch.no_grad():
                for t in list(x.parameters()) + list(x.buffers()):
                    t.copy_(bcast(t))
            return x
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return x

    return walk(tree)


def mesh_loss(model, axis: Axis, X=None, Y=None) -> MeshLoss:
    """The training loss of ``model`` as a ``MeshLoss`` over ``axis``: an
    SVGP on this rank's rows of (X, Y), an SGPR on its rows of its own data,
    a GPR on the rows of its gram K(X) that this rank computes, gathered
    (its [N, N] Cholesky runs on every rank, as in ``oak_tpu``). A GPR's
    lanes form all-reduces an [N, N] block a lane (268 MB at N = 8192 in
    float32), so it takes its lanes in chunks of at most
    ``mesh.LANES_BYTES_CAP`` (2 GiB) of them: past 8 lanes a rank at
    N = 8192, which no configuration of the repo reaches (the UCI
    configurations' 4 restarts hold at most 4 lanes a rank, 1.07 GB)."""
    if isinstance(model, SVGP):
        if X is None:
            raise ValueError("model carries no data leaves; pass X= and Y= explicitly "
                             "(SVGP contract)")
        ref = flatten_trainable(model)
        X, Y = (torch.as_tensor(a, dtype=ref.dtype, device=ref.device) for a in (X, Y))
        Y = Y[:, None] if Y.dim() == 1 else Y
        n = X.shape[0]
        rows = axis.rows(n)
        return MeshLoss(lambda m: m.elbo_terms(X[rows], Y[rows]),
                        lambda m, terms: m.training_loss_from_terms(terms, n), axis)
    if X is not None:
        raise ValueError(f"a {type(model).__name__} takes its data from its own X and Y; "
                         "pass no X= or Y=")
    n = model.X.shape[0]
    rows = axis.rows(n)
    if isinstance(model, SGPR):
        return MeshLoss(lambda m: m.elbo_terms(m.X[rows], m.Y[rows]),
                        lambda m, terms: m.training_loss_from_terms(terms, n), axis)
    if isinstance(model, GPR):
        def local(m):
            block = m.kernel.K(m.X[rows], m.X)
            return (torch.nn.functional.pad(block, (0, 0, rows.start, n - rows.stop)),)

        return MeshLoss(local, lambda m, terms: m.training_loss_from_gram(terms[0]), axis,
                        lane_numel=n * n)
    raise TypeError(f"no data-sharded loss for {type(model).__name__}")


def minibatch_loss(mesh: DeviceMesh, X: torch.Tensor, Y: torch.Tensor,
                   batch_size: int, axis: str = DATA_AXIS) -> MeshLoss:
    """An SVGP's minibatch loss ``loss(m, ib)`` over the batch of row
    indices ``ib`` [batch_size], each rank taking its block of the batch."""
    ax = Axis.of(mesh, axis)
    rows = ax.rows(batch_size)
    return MeshLoss(lambda m, ib: m.elbo_terms(X[ib[rows]], Y[ib[rows]]),
                    lambda m, terms, ib: m.training_loss_from_terms(terms, batch_size), ax)


def _replicated_step(model, mesh: DeviceMesh, lr: float, axis: str, update):
    """(step_fn, (vec0, opt_state, unflatten)) of a data-parallel step whose
    ``update(opt, leaf, loss_fn, X, Y) -> loss`` changes ``leaf`` and Adam
    ``opt`` in place; ``loss_fn`` is the SVGP loss on the shards (X, Y) the
    step is called with."""
    ax = Axis.of(mesh, axis)
    loss_fn = MeshLoss(lambda m, X, Y: m.elbo_terms(X, Y),
                       lambda m, terms, X, Y: m.training_loss_from_terms(
                           terms, X.shape[0] * ax.size), ax)
    vec0 = replicate(mesh, flatten_trainable(model).detach())

    def step(vec, opt_state, X, Y):
        leaf = vec.detach().clone().requires_grad_(True)
        opt = adam(leaf, lr)
        set_adam_state(opt, leaf, opt_state)
        loss = update(opt, leaf, loss_fn, X, Y)
        return leaf.detach(), adam_state(opt, leaf), loss

    def unflatten(vec):
        from ..optim.multistart import model_at

        return model_at(model, vec)

    return step, (vec0, adam_state(adam(vec0, lr), vec0), unflatten)


def data_parallel_elbo_step(model, mesh: DeviceMesh, learning_rate: float = 1e-2,
                            axis: str = DATA_AXIS):
    """A data-parallel Adam step on an SVGP's ELBO.

    Returns (step_fn, (vec0, opt_state, unflatten)): ``step_fn(vec,
    opt_state, X, Y)`` takes the flat trainable vector and Adam's state
    (optax's leaves [count, mu, nu]) replicated and this rank's shard of
    the batch (``shard_batch``), and returns (vec, opt_state, loss at the
    start point), the same on every rank. ``unflatten(vec)`` is a copy of
    the model holding ``vec``."""
    def update(opt, leaf, loss_fn, X, Y):
        return _adam_step(model, loss_fn, leaf, opt, (X, Y), mask=False)

    return _replicated_step(model, mesh, learning_rate, axis, update)


def data_parallel_natgrad_step(model, mesh: DeviceMesh, gamma: float = 0.2,
                               hyper_lr: float = 1e-2, axis: str = DATA_AXIS,
                               staggered: bool = False):
    """The data-parallel natural-gradient step on q(u) with Adam on the
    hyperparameters, under ``data_parallel_elbo_step``'s contract; the
    update is ``optim.natgrad.natgrad_adam_step``, the one shared
    definition."""
    from ..optim.natgrad import natgrad_adam_step, warn_if_q_diag

    warn_if_q_diag(model)

    def update(opt, leaf, loss_fn, X, Y):
        return natgrad_adam_step(opt, leaf, model, loss_fn, gamma, staggered=staggered)(X, Y)

    return _replicated_step(model, mesh, hyper_lr, axis, update)


def _check_data(model, X, n_dev: int, message: str) -> None:
    if X is None and not (hasattr(model, "X") and hasattr(model, "Y")):
        raise ValueError("model carries no data leaves; pass X= and Y= explicitly "
                         "(SVGP contract)")
    n_data = (X if X is not None else model.X).shape[0]
    if n_data % n_dev:
        raise ValueError(message.format(n=n_data, d=n_dev))


def fit_lbfgs_sharded(model, mesh: DeviceMesh, X=None, Y=None, max_iters: int = 500,
                      tol: float = 1e-8, memory_size: int = 30,
                      axis: str = DATA_AXIS) -> FitResult:
    """Full-batch L-BFGS (``optim.fit_lbfgs``) with the data axis sharded
    over the mesh: every loss and gradient computes its [*, N] grams and
    row terms on the rank's rows and is all-reduced, so every rank takes the
    same linesearch branches and stops at the same iteration. SVGP: pass
    (X, Y); GPR and SGPR: their own X and Y. The model is updated in place,
    on every rank."""
    ax = Axis.of(mesh, axis)
    _check_data(model, X, ax.size,
                "N={n} must be divisible by the mesh's {d} devices (same contract as the "
                "other data-parallel paths); trim or pad the data")
    return fit_lbfgs(model, mesh_loss(model, ax, X, Y), max_iters=max_iters, tol=tol,
                     memory_size=memory_size)


def fit_lbfgs_multistart_sharded(model, mesh: DeviceMesh, X=None, Y=None,
                                 n_starts: int = 4, jitter: float = 0.3, seed: int = 0,
                                 max_iters: int = 500, tol: float = 1e-8,
                                 memory_size: int = 30, warm_adam_steps: int = 0,
                                 warm_lr: float = 2e-2, include_init: bool = True,
                                 accept_fn=None, chunk_iters=None,
                                 axis: str = DATA_AXIS) -> FitResult:
    """Multistart L-BFGS on a 2-D mesh: the restarts over one axis and each
    lane's data over the other, ``axis`` ("data"). The ranks of one restart
    block run its lanes together, each on its rows; the lanes are then
    gathered over the restart axis, and every rank keeps the same best.
    Same lanes as the unsharded ``optim.fit_lbfgs_multistart`` up to
    reduction order, through its lane-batched L-BFGS: each evaluation runs
    all of the rank's lanes in one vmapped program with two all-reduces
    over the data axis (``MeshLoss.lanes_value_and_grad``), as ``oak_tpu``
    vmaps its lanes with the psums inside. Data as in
    ``fit_lbfgs_sharded``; no checkpointing on this path."""
    from ..optim.multistart import fit_lbfgs_multistart

    axes = list(mesh.mesh_dim_names or ())
    if len(axes) != 2 or axis not in axes:
        raise ValueError(
            f"fit_lbfgs_multistart_sharded needs a 2-D mesh with a '{axis}' axis plus a "
            f"restarts axis (got axes {axes}); use optim.fit_lbfgs_multistart(mesh=) for "
            "restarts-only or fit_lbfgs_sharded for data-only sharding")
    restart_axis = axes[0] if axes[1] == axis else axes[1]
    lanes, data = Axis.of(mesh, restart_axis), Axis.of(mesh, axis)
    if n_starts % lanes.size:
        raise ValueError(f"n_starts={n_starts} must be divisible by the mesh's "
                         f"'{restart_axis}' axis size {lanes.size}")
    _check_data(model, X, data.size,
                "N={n} must be divisible by the mesh's '" + axis + "' axis size {d}")
    res = fit_lbfgs_multistart(model, mesh_loss(model, data, X, Y), n_starts=n_starts,
                               jitter=jitter, seed=seed, max_iters=max_iters, tol=tol,
                               memory_size=memory_size, warm_adam_steps=warm_adam_steps,
                               warm_lr=warm_lr, include_init=include_init,
                               accept_fn=accept_fn, mesh=lanes, chunk_iters=chunk_iters)
    if res.losses is not None and "diverged" not in res.message:
        res.message = (f"best of {n_starts} restarts on a {lanes.size}x{data.size} "
                       "(restart x data) mesh (losses: "
                       + ", ".join(f"{v:.4g}" for v in res.losses.tolist()) + ")")
    return res


def sharded_predict_f(model, mesh: DeviceMesh, axis: str = DATA_AXIS):
    """``predict(X) -> (mean, var)``: each rank predicts its block of the
    rows of X (the same full X on every rank) and the blocks are gathered,
    so every rank holds the whole mean and variance. The model is the same
    on every rank (SPMD); X goes to its device and dtype."""
    ax = Axis.of(mesh, axis)
    ref = flatten_trainable(model)

    @torch.no_grad()
    def predict(X):
        X = torch.as_tensor(X, dtype=ref.dtype, device=ref.device)
        n = X.shape[0]
        mean, var = model.predict_f(X[ax.rows(n)])
        both = ax.gather_rows(torch.cat([mean, var], dim=1), n)
        return both[:, :mean.shape[1]], both[:, mean.shape[1]:]

    return predict
