"""The collectives under the port's multi-device layer (``parallel``).

The layer is SPMD: one process per device (``torchrun``), each calling the
same entry point with the same full host arrays, and each reducing over the
process group of one named axis of a ``DeviceMesh``. Only ``all_reduce``
and ``broadcast`` are used: they are the collectives gloo supports on CUDA
tensors, so several gloo ranks can share one card and run the same code as
NCCL ranks on several cards. A gather of rows is an ``all_reduce`` over a
zero-filled buffer into which each rank has written its own rows (exact:
each entry has one non-zero contribution).

``MeshLoss`` is a loss summed over data shards: each rank computes the terms
of its rows (``local``), the terms are all-reduced, and the rest of the loss
(``tail``: Kuu's Cholesky, the KL, the priors) runs on every rank on the
reduced terms. Its gradient is the tail's counted once plus every rank's
local part; ``torch.distributed.nn``'s differentiable all-reduce would count
the tail once per rank, since its backward all-reduces the incoming
gradient. Its lanes form evaluates R trainable vectors at once (a
multistart's lanes on one rank, as ``oak_tpu`` vmaps its lanes with the
psums inside): the local terms and the tail under ``torch.func.vmap``, the
two all-reduces outside any transform, each over all the lanes at once.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..params import call_with, unflatten_trainable

DATA_AXIS = "data"
# a lanes evaluation takes its lanes in chunks whose all-reduced local terms
# stay below this many bytes (a GPR's are a zero-padded [N, N] block a lane)
LANES_BYTES_CAP = 2 << 30


class Axis:
    """This rank's view of one axis of a mesh (or of the whole mesh): the
    process group, its size, this rank's index along it and the global rank
    of its first member."""

    def __init__(self, group, size: int, index: int, first: int):
        self.group, self.size, self.index, self.first = group, size, index, first

    @classmethod
    def of(cls, mesh, axis: str) -> "Axis":
        names = list(mesh.mesh_dim_names or ())
        if axis not in names:
            raise ValueError(f"mesh has no '{axis}' axis (axes {names})")
        _check_member(mesh)
        dim = names.index(axis)
        group = mesh.get_group(axis)
        return cls(group, mesh.size(dim), mesh.get_local_rank(axis),
                   dist.get_global_rank(group, 0))

    @classmethod
    def whole(cls, mesh) -> "Axis":
        """Every rank of the mesh, in its flattened order."""
        _check_member(mesh)
        ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
        if mesh.ndim == 1:
            group = mesh.get_group(0)
        elif len(ranks) == dist.get_world_size():
            group = dist.group.WORLD
        else:
            raise ValueError("a mesh of several axes must span every process to be "
                             "used as one group")
        return cls(group, len(ranks), ranks.index(dist.get_rank()), ranks[0])

    @property
    def is_first(self) -> bool:
        return self.index == 0

    def rows(self, n: int) -> slice:
        """This rank's contiguous block of n rows (``np.array_split``'s
        blocks: the first n % size ranks take one row more)."""
        q, r = divmod(n, self.size)
        start = self.index * q + min(self.index, r)
        return slice(start, start + q + (self.index < r))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the axis, as a new tensor."""
        out = t.detach().clone().contiguous()
        dist.all_reduce(out, group=self.group)
        return out

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The [n, ...] tensor whose ``rows(n)`` block each rank holds."""
        buf = local.new_zeros((n,) + tuple(local.shape[1:]))
        buf[self.rows(n)] = local.detach()
        dist.all_reduce(buf, group=self.group)
        return buf

    def first_only(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` on the axis's first rank, zeros elsewhere: summed over the
        axis it counts once, and every rank then holds the same bits."""
        return t if self.is_first else torch.zeros_like(t)


def _check_member(mesh) -> None:
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                         f"{mesh.mesh.tolist()}; only its ranks call the sharded functions")


def _flat(terms: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in terms])


def _unflat(flat: torch.Tensor, shapes: Sequence[torch.Size]) -> List[torch.Tensor]:
    pieces = torch.split(flat, [s.numel() for s in shapes])
    return [p.view(s) for p, s in zip(pieces, shapes)]


def _shapes(terms: Sequence[torch.Tensor]) -> List[torch.Size]:
    return [t.shape for t in terms]


class MeshLoss:
    """``loss(m, *args) = tail(m, Σ_ranks local(m, *args), *args)`` over an
    axis's group.

    - ``local(m, *args)``: a tuple of tensors, the terms of this rank's
      rows, summed over the axis;
    - ``tail(m, terms, *args)``: the scalar loss from the reduced terms;
    - ``lane_numel``: the number of elements of one evaluation's local
      terms where they are large (a GPR's [N, N]), so that a lanes
      evaluation chunks its lanes below ``LANES_BYTES_CAP``; None for
      terms that are small.

    Called as a function it is the loss's value, the same bits on every
    rank. ``optim.fit.loss_and_grads`` takes its gradient through
    ``loss_and_grads``, and ``optim.fit.LaneLoss`` evaluates several lanes
    through ``lanes_value_and_grad`` and ``lanes_values``, so every
    optimizer of ``optim`` runs on it unchanged, in lockstep on the axis's
    ranks."""

    def __init__(self, local: Callable, tail: Callable, axis: Axis,
                 lane_numel: Optional[int] = None):
        self.local, self.tail, self.axis = local, tail, axis
        self.lane_numel = lane_numel

    @property
    def writes_checkpoints(self) -> bool:
        """Only the axis's first rank writes a training checkpoint."""
        return self.axis.is_first

    def __call__(self, model, *args):
        terms = self.local(model, *args)
        reduced = _unflat(self.axis.all_reduce(_flat(terms)), _shapes(terms))
        loss = self.tail(model, reduced, *args)
        return self.axis.all_reduce(self.axis.first_only(loss))

    def loss_and_grads(self, model, raws, inputs: Sequence[torch.Tensor],
                       args: Tuple = ()) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """(loss, gradients w.r.t. ``inputs``) with the raws of ``raws``
        (``params.call_with``): the reduced terms enter the tail as a fresh
        leaf S; one backward gives the tail's gradient and dloss/dS, a
        second carries dloss/dS through this rank's local terms, and one
        all-reduce sums the local parts with the first rank's tail part."""
        terms = call_with(model, raws, self.local, *args)
        flat = _flat(terms)
        S = self.axis.all_reduce(flat).requires_grad_(True)
        loss = call_with(model, raws, lambda m: self.tail(m, _unflat(S, _shapes(terms)), *args))
        *g_tail, g_S = torch.autograd.grad(loss, [*inputs, S], allow_unused=True,
                                           materialize_grads=True, retain_graph=True)
        if flat.requires_grad:
            g_local = torch.autograd.grad(flat, inputs, grad_outputs=g_S, allow_unused=True,
                                          materialize_grads=True)
        else:
            g_local = [torch.zeros_like(t) for t in inputs]
        own = self.axis.first_only(_flat([loss.detach().reshape(1), *g_tail]))
        packed = self.axis.all_reduce(own + _flat([torch.zeros_like(own[:1]), *g_local]))
        out = _unflat(packed, [packed[:1].shape, *_shapes(inputs)])
        return out[0].reshape(()), tuple(out[1:])

    # ------------------------------------------------------------------ #
    # The lanes form: R trainable vectors [R, n] of ``model`` at once
    # ------------------------------------------------------------------ #
    def _lane_fns(self, model, args: Tuple):
        """(local(vec) -> this rank's terms flattened [T], tail(vec, S) ->
        the loss from reduced terms S [T]) of one trainable vector, for
        ``torch.func.vmap``; ``shapes`` holds the terms' shapes once local
        has run."""
        shapes: List[torch.Size] = []

        def local(vec):
            terms = call_with(model, unflatten_trainable(model, vec), self.local, *args)
            shapes[:] = _shapes(terms)
            return _flat(terms)

        def tail(vec, S):
            return call_with(model, unflatten_trainable(model, vec),
                             lambda m: self.tail(m, _unflat(S, shapes), *args))

        return local, tail

    def _chunks(self, vecs: torch.Tensor) -> List[slice]:
        """The lanes in chunks whose local terms stay below
        ``LANES_BYTES_CAP``: one chunk unless ``lane_numel`` is large. The
        chunks depend only on shapes, so every rank of the axis makes the
        same collectives in the same order."""
        R = vecs.shape[0]
        if self.lane_numel is None:
            return [slice(0, R)]
        per = max(1, LANES_BYTES_CAP // (self.lane_numel * vecs.element_size()))
        return [slice(i, min(i + per, R)) for i in range(0, R, per)]

    def lanes_value_and_grad(self, model, vecs: torch.Tensor, args: Tuple = ()
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(losses [R], gradients [R, n]) at the trainable vectors ``vecs``
        [R, n], each lane what ``loss_and_grads`` gives it, with two
        all-reduces for all the lanes (per chunk, ``_chunks``): the local
        terms of every lane in one vmap, flattened to [R, T] and
        all-reduced; the tail and its gradient w.r.t. (vec, S) in one vmap
        of ``grad_and_value``, each lane's reduced row S a fresh input; the
        local part of the gradient by one vector-Jacobian product of the
        vmapped local terms against dloss/dS; then [loss, tail gradient]
        from the first rank plus every rank's [0, local gradient], [R,
        1 + n], all-reduced. ``args`` are shared by every lane. No
        collective runs inside a transform."""
        losses, grads = zip(*(self._lanes_value_and_grad(model, vecs[rows].detach(), args)
                              for rows in self._chunks(vecs)))
        return torch.cat(losses), torch.cat(grads)

    def _lanes_value_and_grad(self, model, vecs, args):
        local, tail = self._lane_fns(model, args)
        flat, local_vjp = torch.func.vjp(torch.func.vmap(local), vecs)
        S = self.axis.all_reduce(flat)
        (g_tail, g_S), losses = torch.func.vmap(
            torch.func.grad_and_value(tail, argnums=(0, 1)))(vecs, S)
        (g_local,) = local_vjp(g_S)
        own = self.axis.first_only(torch.cat([losses.detach()[:, None], g_tail], dim=1))
        packed = self.axis.all_reduce(
            own + torch.cat([torch.zeros_like(own[:, :1]), g_local.detach()], dim=1))
        return packed[:, 0], packed[:, 1:]

    @torch.no_grad()
    def lanes_values(self, model, vecs: torch.Tensor, args: Tuple = ()) -> torch.Tensor:
        """The losses [R] at ``vecs`` [R, n], as ``lanes_value_and_grad``
        gives them, with two all-reduces for all the lanes (per chunk)."""
        out = []
        for rows in self._chunks(vecs):
            local, tail = self._lane_fns(model, args)
            lanes = vecs[rows].detach()
            S = self.axis.all_reduce(torch.func.vmap(local)(lanes))
            out.append(self.axis.all_reduce(self.axis.first_only(
                torch.func.vmap(tail)(lanes, S))))
        return torch.cat(out)


def first_axis(mesh) -> Optional[Axis]:
    """The mesh's first axis, or None without a mesh."""
    return None if mesh is None else Axis.of(mesh, mesh.mesh_dim_names[0])
