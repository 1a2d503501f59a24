"""One rank of the 4-process gloo job that ``test_torch_sharding.py`` starts.

    python tests/torch_sharding_worker.py RANK WORLD DIR

DIR holds ``specs`` of the models (``SPECS``), their parameters as keypath
npz files written by ``oak_tpu.checkpoint.save_params`` (``<name>.npz``) and
receives ``rank<R>.npz`` (every case's arrays under ``<case>/<key>``) and
``rank<R>.json`` (each case's error, if it raised). The ranks import only
torch, numpy and ``oak_tpu_torch``; every case runs on every rank, on a 1-D
mesh of the 4 ranks ("m4") and on the data axis of a 2 x 2 ("restart",
"data") mesh ("m22"), in float64 on the CPU. The unsharded references of
the port are computed on rank 0 only.
"""

from __future__ import annotations

import json
import sys
import time
import traceback
from pathlib import Path

import numpy as np

SEED = 83
# name -> (model kind, rows N, dims D, inducing M, depth, likelihood)
SPECS = {
    "svgp": ("svgp", 64, 3, 8, 2, "gaussian"),
    "sgpr": ("sgpr", 64, 3, 8, 2, "gaussian"),
    "gpr": ("gpr", 32, 4, 0, 3, "gaussian"),
    "bern": ("svgp", 64, 3, 8, 2, "bernoulli"),
}
PREDICT_ROWS = 48
LANES, LANE_JITTER = 3, 0.1  # the lanes form's lanes: odd, to catch row slicing
MINIBATCH = 16


def data(name):
    """(X, Y, Z) of a spec, from numpy seeds."""
    _, n, d, m, _, lik = SPECS[name]
    rng = np.random.default_rng(SEED + sorted(SPECS).index(name))
    X = rng.normal(size=(n, d))
    f = np.sin(X[:, 0]) + X[:, 1] * X[:, -1]
    Y = (f > 0).astype(np.float64) if lik == "bernoulli" else f + 0.1 * rng.normal(size=n)
    return X, Y.reshape(-1, 1), X[:m].copy()


def lane_vectors(name, vec):
    """[LANES, n] trainable vectors around ``vec`` (numpy), from a seed."""
    rng = np.random.default_rng(SEED + 10 + sorted(SPECS).index(name))
    return vec[None, :] + LANE_JITTER * rng.normal(size=(LANES, vec.shape[0]))


def kernel_kwargs(name):
    _, _, d, _, depth, _ = SPECS[name]
    return dict(num_dims=d, max_interaction_depth=depth, use_sparsity_prior=True,
                lengthscale_bounds=[1e-3, 1e3])


def build(name, folder=None, n=None):
    """The port's model of a spec in float64 on the CPU, its parameters
    loaded from ``folder/<name>.npz`` when given; ``n`` keeps its first n
    rows."""
    import torch

    from oak_tpu_torch import checkpoint
    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.models import GPR, SGPR, SVGP, Bernoulli, Gaussian

    kw = dict(dtype=torch.float64, device="cpu")
    kind, N, _, _, _, lik = SPECS[name]
    X, Y, Z = data(name)
    X, Y = X[:n], Y[:n]
    k = OAKKernel.create(**kernel_kwargs(name), **kw)
    if kind == "svgp":
        likelihood = Bernoulli.create() if lik == "bernoulli" else Gaussian.create(0.1, **kw)
        m = SVGP.create(k, likelihood, Z, num_data=N, **kw)
    elif kind == "sgpr":
        m = SGPR.create(X, Y, k, Z, noise_variance=0.1, **kw)
    else:
        m = GPR.create(X, Y, k, noise_variance=0.1, **kw)
    if folder is not None:
        checkpoint.load_params(m, str(Path(folder) / f"{name}.npz"))
    return m, torch.as_tensor(X), torch.as_tensor(Y)


# --------------------------------------------------------------------------- #
CASES = []


def case(fn):
    CASES.append(fn)
    return fn


def _vec(m):
    from oak_tpu_torch.params import flatten_trainable

    return flatten_trainable(m).detach().numpy()


def _loss_fn(name, X, Y):
    if SPECS[name][0] == "svgp":
        return lambda m: m.training_loss(X, Y)
    return lambda m: m.training_loss()


@case
def loss_grad(ctx):
    """Each model's training loss and gradient at its loaded parameters,
    over the data axis of both meshes."""
    from oak_tpu_torch.optim.fit import value_and_grad
    from oak_tpu_torch.parallel.mesh import Axis
    from oak_tpu_torch.parallel.sharding import mesh_loss

    out = {}
    for mesh_name in ("m4", "m22"):
        axis = Axis.of(ctx[mesh_name], "data")
        for name in ("svgp", "sgpr", "gpr"):
            m, X, Y = build(name, ctx["dir"])
            loss = mesh_loss(m, axis, *((X, Y) if SPECS[name][0] == "svgp" else ()))
            v, g = value_and_grad(m, loss, torch_vec(m))
            out[f"{name}_{mesh_name}_loss"], out[f"{name}_{mesh_name}_grad"] = v, g
            out[f"{name}_{mesh_name}_value"] = loss(m)  # the forward-only call
    return out


def torch_vec(m):
    from oak_tpu_torch.params import flatten_trainable

    return flatten_trainable(m).detach()


class _Counting:
    """Counts the calls of a class's method while in a ``with`` block."""

    def __init__(self, cls, name):
        self.cls, self.name, self.calls = cls, name, 0

    def __enter__(self):
        original = getattr(self.cls, self.name)

        def counted(*args, **kw):
            self.calls += 1
            return original(*args, **kw)

        self.original = original
        setattr(self.cls, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.name, self.original)


@case
def lanes_form(ctx):
    """Each model's mesh_loss at LANES lanes through ``fit.LaneLoss`` (the
    lanes form) over the data axis of both meshes, against the same lanes
    in turn through ``loss_and_grads``; the all-reduces of one batched
    evaluation at 1, 2 and LANES lanes; the SVGP's minibatch loss at LANES
    lanes, one batch of rows for all of them."""
    import torch

    from oak_tpu_torch.optim.fit import LaneLoss, value_and_grad
    from oak_tpu_torch.parallel.mesh import Axis
    from oak_tpu_torch.parallel.sharding import mesh_loss, minibatch_loss

    out = {}
    for mesh_name in ("m4", "m22"):
        axis = Axis.of(ctx[mesh_name], "data")
        for name in ("svgp", "sgpr", "gpr"):
            m, X, Y = build(name, ctx["dir"])
            loss = mesh_loss(m, axis, *((X, Y) if SPECS[name][0] == "svgp" else ()))
            vecs = torch.as_tensor(lane_vectors(name, _vec(m)))
            lanes = LaneLoss(m, loss)
            key = f"{name}_{mesh_name}"
            for R in range(1, LANES + 1):
                with _Counting(Axis, "all_reduce") as grads, \
                        _Counting(type(loss), "lanes_value_and_grad") as form:
                    v, g = lanes.value_and_grad(vecs[:R])
                with _Counting(Axis, "all_reduce") as values:
                    lanes.values(vecs[:R])
                out[f"{key}_reduces_{R}"] = [grads.calls, values.calls, form.calls]
            out[f"{key}_loss"], out[f"{key}_grad"] = v, g
            out[f"{key}_values"] = lanes.values(vecs)
            turn = [value_and_grad(m, loss, vec) for vec in vecs]
            out[f"{key}_turn_loss"] = torch.stack([t[0] for t in turn])
            out[f"{key}_turn_grad"] = torch.stack([t[1] for t in turn])
        # the minibatch loss: its batch of row indices shared by every lane
        m, X, Y = build("svgp", ctx["dir"])
        loss = minibatch_loss(ctx[mesh_name], X, Y, MINIBATCH)
        ib = torch.as_tensor(np.random.default_rng(SEED).permutation(len(X))[:MINIBATCH])
        vecs = torch.as_tensor(lane_vectors("svgp", _vec(m)))
        out[f"minibatch_{mesh_name}_loss"], out[f"minibatch_{mesh_name}_grad"] = \
            loss.lanes_value_and_grad(m, vecs, (ib,))
        out[f"minibatch_{mesh_name}_values"] = loss.lanes_values(m, vecs, (ib,))
        turn = [value_and_grad(m, loss, vec, ib) for vec in vecs]
        out[f"minibatch_{mesh_name}_turn_loss"] = torch.stack([t[0] for t in turn])
        out[f"minibatch_{mesh_name}_turn_grad"] = torch.stack([t[1] for t in turn])
    return out


def _k_through_ops(self, X, X2=None):
    """OAKKernel.K through the card's route (``ops.oak_gram.fused_op``:
    FusedGram or the registered op) on CPU tensors."""
    from oak_tpu_torch.ops import oak_gram as og

    return og.fused_op(og._prep(self, X, X if X2 is None else X2),
                       self.max_interaction_depth)


@case
def lanes_form_fused(ctx):
    """The SVGP's lanes form with its grams through FusedGram and the
    registered ops (their vmap rules under vjp and grad), against the lanes
    in turn; the plain versions' entries of one batched evaluation and of
    one lane's, which are equal when every gram runs once for all lanes."""
    import torch

    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.optim.fit import LaneLoss, value_and_grad
    from oak_tpu_torch.parallel.mesh import Axis
    from oak_tpu_torch.parallel.sharding import mesh_loss

    m, X, Y = build("svgp", ctx["dir"])
    loss = mesh_loss(m, Axis.of(ctx["m22"], "data"), X, Y)
    vecs = torch.as_tensor(lane_vectors("svgp", _vec(m)))
    old_k = OAKKernel.K
    OAKKernel.K = _k_through_ops
    try:
        with _Counting(og, "oak_gram_plain") as f1, _Counting(og, "oak_gram_bwd_plain") as b1:
            value_and_grad(m, loss, vecs[0])
        with _Counting(og, "oak_gram_plain") as fR, _Counting(og, "oak_gram_bwd_plain") as bR:
            v, g = LaneLoss(m, loss).value_and_grad(vecs)
        turn = [value_and_grad(m, loss, vec) for vec in vecs]
    finally:
        OAKKernel.K = old_k
    return {"loss": v, "grad": g, "turn_loss": torch.stack([t[0] for t in turn]),
            "turn_grad": torch.stack([t[1] for t in turn]),
            "plain_entries": [f1.calls, b1.calls, fR.calls, bR.calls]}


@case
def predict(ctx):
    from oak_tpu_torch.parallel import sharded_predict_f

    m, _, _ = build("svgp", ctx["dir"])
    Xt = np.random.default_rng(7).normal(size=(PREDICT_ROWS, SPECS["svgp"][2]))
    out = {}
    for mesh_name in ("m4", "m22"):
        out[f"{mesh_name}_mean"], out[f"{mesh_name}_var"] = sharded_predict_f(
            m, ctx[mesh_name])(Xt)
    return out


@case
def sobol(ctx):
    """GPR Sobol values, per-order totals and components under each mesh."""
    from oak_tpu_torch import sobol as sb

    m, _, _ = build("gpr", ctx["dir"])
    n, d = m.X.shape[0], m.kernel.num_dims
    out = {}
    for mesh_name in ("m4", "m22"):
        mesh = ctx[mesh_name]
        out[f"{mesh_name}_values"] = sb.compute_sobol_oak(m, mesh=mesh)[1]
        out[f"{mesh_name}_by_order"] = sb.compute_sobol_by_order(m, mesh=mesh)
        out[f"{mesh_name}_components"] = sb.get_prediction_component(m, mesh=mesh)
        # a cap of one [D, N²] prefix matrix: the ladder hands order 3 to the
        # chunked route midway
        old, sb._LADDER_BYTES_CAP = sb._LADDER_BYTES_CAP, d * n * n * 8
        try:
            out[f"{mesh_name}_values_chunked"] = sb.compute_sobol_oak(m, mesh=mesh)[1]
        finally:
            sb._LADDER_BYTES_CAP = old
    return out


@case
def dp_step(ctx):
    """One data-parallel Adam step against the port's one-device step."""
    from oak_tpu_torch.optim import fit_adam
    from oak_tpu_torch.parallel import data_parallel_elbo_step, shard_batch

    m, X, Y = build("svgp", ctx["dir"])
    mesh = ctx["m4"]
    step, (vec, opt_state, unflatten) = data_parallel_elbo_step(m, mesh, learning_rate=1e-2)
    vec1, _, loss = step(vec, opt_state, *shard_batch(mesh, X, Y))
    out = {"loss": loss, "vec": vec1, "unflatten_same": float(
        np.array_equal(_vec(unflatten(vec1)), vec1.numpy()))}
    if ctx["rank"] == 0:
        ref = fit_adam(build("svgp", ctx["dir"])[0], lambda mm, a, b: mm.training_loss(a, b),
                       steps=1, lr=1e-2, batch_fn=lambda i: (X, Y))
        out["ref_vec"] = _vec(ref.model)
    return out


@case
def dp_improves(ctx):
    from oak_tpu_torch.parallel import data_parallel_elbo_step, shard_batch

    m, X, Y = build("svgp", ctx["dir"])
    mesh = ctx["m4"]
    step, (vec, opt_state, _) = data_parallel_elbo_step(m, mesh, learning_rate=5e-2)
    Xs, Ys = shard_batch(mesh, X, Y)
    losses = []
    for _ in range(10):
        vec, opt_state, loss = step(vec, opt_state, Xs, Ys)
        losses.append(float(loss))
    return {"losses": np.array(losses)}


@case
def subset_mesh(ctx):
    """A mesh of ranks 0 and 1 of the four; the others call nothing on it."""
    from oak_tpu_torch.optim.fit import value_and_grad
    from oak_tpu_torch.parallel import data_parallel_elbo_step, make_mesh, shard_batch

    mesh = make_mesh(2)
    if ctx["rank"] >= 2:
        return {"in_mesh": 0.0}
    m, X, Y = build("svgp", ctx["dir"], n=32)
    step, (vec, opt_state, _) = data_parallel_elbo_step(m, mesh)
    _, _, loss = step(vec, opt_state, *shard_batch(mesh, X, Y))
    ref = value_and_grad(m, lambda mm: mm.training_loss(X, Y), vec)[0]
    return {"in_mesh": 1.0, "loss": loss, "ref": ref}


def _bernoulli_oak(n=256, d=3):
    import torch

    from oak_tpu_torch.model import oak_model

    rng = np.random.default_rng(SEED)
    X = rng.normal(size=(n, d))
    y = (np.sin(X[:, 0]) + X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    oak = oak_model(max_interaction_depth=2, num_inducing=16, likelihood="bernoulli",
                    use_normalising_flow=False, dtype=torch.float64, device="cpu")
    oak.fit(X, y, optimise=False)
    return oak


@case
def minibatch(ctx):
    """optimise_minibatch(mesh=) against the one-device trajectory, Adam and
    natgrad; a batch that does not divide raises."""
    mesh = ctx["m4"]
    out = {}
    for opt in ("adam", "natgrad"):
        oak = _bernoulli_oak()
        res = oak.optimise_minibatch(batch_size=64, steps=6, lr=1e-2, seed=3, mesh=mesh,
                                     optimizer=opt)
        out[f"{opt}_vec"], out[f"{opt}_fun"] = _vec(oak.m), res.fun
        if ctx["rank"] == 0:
            ref = _bernoulli_oak()
            res0 = ref.optimise_minibatch(batch_size=64, steps=6, lr=1e-2, seed=3,
                                          optimizer=opt)
            out[f"{opt}_ref_vec"], out[f"{opt}_ref_fun"] = _vec(ref.m), res0.fun
    try:
        _bernoulli_oak(64).optimise_minibatch(batch_size=10, steps=1, mesh=mesh)
    except ValueError as e:
        out["divisible_error"] = np.array(str(e))
    return out


@case
def oak_model_sobol(ctx):
    """oak_model.get_sobol(mesh=), and the chunked route under a mesh."""
    import torch

    from oak_tpu_torch import sobol as sb
    from oak_tpu_torch.model import oak_model

    rng = np.random.default_rng(SEED + 1)
    out = {}
    for n, key in ((96, "entry"), (80, "chunked")):
        X = rng.normal(size=(n, 4))
        oak = oak_model(max_interaction_depth=2, use_normalising_flow=False,
                        dtype=torch.float64, device="cpu")
        oak.fit(X, np.sin(X[:, 0]) + X[:, 1], optimise=False)
        if key == "entry":
            out["s0"], out["s1"] = oak.get_sobol(), oak.get_sobol(mesh=ctx["m4"])
        else:
            out["full"] = sb.compute_sobol_oak(oak.m)[1]
            old = sb._LADDER_BYTES_CAP
            sb._LADDER_BYTES_CAP = 1
            try:
                out["chunked"] = sb.compute_sobol_oak(oak.m, mesh=ctx["m4"])[1]
            finally:
                sb._LADDER_BYTES_CAP = old
    return out


@case
def lbfgs_sharded(ctx):
    from oak_tpu_torch.optim import fit_lbfgs
    from oak_tpu_torch.parallel import fit_lbfgs_sharded

    out = {}
    for name, iters in (("sgpr", 10), ("svgp", 10)):
        m, X, Y = build(name, ctx["dir"])
        ext = (X, Y) if name == "svgp" else ()
        res = fit_lbfgs_sharded(m, ctx["m4"], *ext, max_iters=iters)
        out[f"{name}_fun"], out[f"{name}_vec"] = res.fun, _vec(res.model)
        out[f"{name}_iters"] = res.num_iters
        if name == "sgpr":
            out["sgpr_rows"] = res.model.X.shape[0]
        if ctx["rank"] == 0:
            m0, X, Y = build(name, ctx["dir"])
            r0 = fit_lbfgs(m0, _loss_fn(name, X, Y), max_iters=iters)
            out[f"{name}_ref_fun"], out[f"{name}_ref_vec"] = r0.fun, _vec(r0.model)
            out[f"{name}_ref_iters"] = r0.num_iters
    return out


def _errors(calls):
    """{key: the message of the ValueError each call raised}."""
    out = {}
    for key, fn in calls.items():
        try:
            fn()
        except ValueError as e:
            out[key] = np.array(str(e))
    return out


@case
def lbfgs_validation(ctx):
    import torch

    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.models import SGPR, SVGP, Gaussian
    from oak_tpu_torch.parallel import fit_lbfgs_sharded

    kw = dict(dtype=torch.float64, device="cpu")
    X = np.random.default_rng(1).normal(size=(62, 2))  # 62 rows on 4 ranks
    k = OAKKernel.create(num_dims=2, max_interaction_depth=1, **kw)
    sgpr = SGPR.create(X, X[:, :1], k, Z=X[:4].copy(), noise_variance=0.1, **kw)
    sv = SVGP.create(k, Gaussian.create(0.1, **kw), X[:4].copy(), num_data=64, **kw)
    return _errors({"divisible": lambda: fit_lbfgs_sharded(sgpr, ctx["m4"], max_iters=1),
                    "no_data": lambda: fit_lbfgs_sharded(sv, ctx["m4"], max_iters=1)})


def _regression_oak(n=64, d=3, depth=2):
    import torch

    from oak_tpu_torch.model import oak_model

    rng = np.random.default_rng(SEED + 2)
    X = rng.normal(size=(n, d))
    oak = oak_model(max_interaction_depth=depth, use_normalising_flow=False,
                    dtype=torch.float64, device="cpu")
    oak.fit(X, np.sin(X[:, 0]) + 0.5 * X[:, -1], optimise=False)
    return oak


@case
def optimise_data_mesh(ctx):
    out = {}
    oak = _regression_oak()
    out["fun"] = oak.optimise(max_iters=10, data_mesh=ctx["m4"]).fun
    if ctx["rank"] == 0:
        out["ref_fun"] = _regression_oak().optimise(max_iters=10).fun
    bad = _regression_oak()
    out.update(_errors({
        "restarts": lambda: bad.optimise(restarts=2, data_mesh=ctx["m4"]),
        "checkpoint": lambda: bad.optimise(checkpoint_path="unused.npz",
                                           data_mesh=ctx["m4"])}))
    bad.optimizer = "adam"
    out.update(_errors({"optimizer": lambda: bad.optimise(data_mesh=ctx["m4"])}))
    return out


@case
def dp_natgrad(ctx):
    from oak_tpu_torch.optim import fit_natgrad_adam
    from oak_tpu_torch.parallel import data_parallel_natgrad_step, shard_batch

    m, X, Y = build("bern", ctx["dir"])
    mesh = ctx["m4"]
    step, (vec, opt_state, _) = data_parallel_natgrad_step(m, mesh, gamma=0.2, hyper_lr=1e-2)
    vec1, _, loss = step(vec, opt_state, *shard_batch(mesh, X, Y))
    out = {"vec": vec1, "loss": loss}
    if ctx["rank"] == 0:
        res = fit_natgrad_adam(build("bern", ctx["dir"])[0],
                               lambda mm, a, b: mm.training_loss(a, b), steps=1, gamma=0.2,
                               hyper_lr=1e-2, batch_fn=lambda i: (X, Y))
        out["ref_vec"], out["ref_loss"] = _vec(res.model), res.fun
    return out


@case
def multistart_2d(ctx):
    """4 starts on the 2 x 2 mesh: 2 lanes per rank, through the lanes
    form."""
    from oak_tpu_torch.optim import fit_lbfgs_multistart
    from oak_tpu_torch.parallel import fit_lbfgs_multistart_sharded
    from oak_tpu_torch.parallel.mesh import MeshLoss

    out = {}
    for name, kw in (("sgpr", dict(max_iters=10)),
                     ("svgp", dict(max_iters=5, warm_adam_steps=5))):
        m, X, Y = build(name, ctx["dir"])
        ext = (X, Y) if name == "svgp" else ()
        with _Counting(MeshLoss, "lanes_value_and_grad") as form:
            res = fit_lbfgs_multistart_sharded(m, ctx["mesh2d"], *ext, n_starts=4, seed=0,
                                               **kw)
        out[f"{name}_lanes_form"] = form.calls
        out[f"{name}_fun"], out[f"{name}_vec"] = res.fun, _vec(res.model)
        out[f"{name}_lanes"], out[f"{name}_message"] = res.losses.numpy(), np.array(res.message)
        if ctx["rank"] == 0:
            m0, X, Y = build(name, ctx["dir"])
            r0 = fit_lbfgs_multistart(m0, _loss_fn(name, X, Y), n_starts=4, seed=0, **kw)
            out[f"{name}_ref_fun"], out[f"{name}_ref_vec"] = r0.fun, _vec(r0.model)
            out[f"{name}_ref_lanes"] = r0.losses.numpy()
    return out


@case
def multistart_2d_validation(ctx):
    import torch

    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.models import SGPR
    from oak_tpu_torch.parallel import fit_lbfgs_multistart_sharded

    kw = dict(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(2)
    X, Xbad = rng.normal(size=(64, 2)), rng.normal(size=(63, 2))  # 63 rows on 2 data ranks
    k = OAKKernel.create(num_dims=2, max_interaction_depth=1, **kw)
    model = SGPR.create(X, X[:, :1], k, Z=X[:4].copy(), noise_variance=0.1, **kw)
    bad = SGPR.create(Xbad, Xbad[:, :1], k, Z=Xbad[:4].copy(), noise_variance=0.1, **kw)
    return _errors({
        "one_axis": lambda: fit_lbfgs_multistart_sharded(model, ctx["m4"], n_starts=2),
        "n_starts": lambda: fit_lbfgs_multistart_sharded(model, ctx["mesh2d"], n_starts=3),
        "rows": lambda: fit_lbfgs_multistart_sharded(bad, ctx["mesh2d"], n_starts=2)})


@case
def optimise_restarts_2d(ctx):
    """Every lane takes oak_model's 300 warm-up Adam steps: the smallest
    model, 4 restarts (2 lanes per rank) through the lanes form."""
    from oak_tpu_torch.parallel.mesh import MeshLoss

    kw = dict(n=16, d=1, depth=1)
    with _Counting(MeshLoss, "lanes_value_and_grad") as form:
        out = {"fun": _regression_oak(**kw).optimise(max_iters=4, restarts=4,
                                                     data_mesh=ctx["mesh2d"]).fun}
    out["lanes_form"] = form.calls
    if ctx["rank"] == 0:
        out["ref_fun"] = _regression_oak(**kw).optimise(max_iters=4, restarts=4).fun
    return out


@case
def restarts_mesh(ctx):
    """Each multistart with a restarts-only mesh= (one lane per rank) against
    its unsharded lanes; the L-BFGS one checkpointed and resumed."""
    from oak_tpu_torch.optim import (fit_adam_multistart, fit_lbfgs_multistart,
                                     fit_natgrad_multistart)

    ckpt = str(Path(ctx["dir"]) / "multistart.npz")
    runs = {
        "lbfgs": lambda m, X, Y, **kw: fit_lbfgs_multistart(
            m, _loss_fn("sgpr", X, Y), n_starts=4, max_iters=4, chunk_iters=2, **kw),
        "adam": lambda m, X, Y, **kw: fit_adam_multistart(
            m, _loss_fn("sgpr", X, Y), n_starts=4, steps=4, **kw),
        "natgrad": lambda m, X, Y, **kw: fit_natgrad_multistart(
            m, _loss_fn("bern", X, Y), n_starts=4, steps=2, gamma=0.2, **kw)}
    out = {}
    for kind, run in runs.items():
        name = "bern" if kind == "natgrad" else "sgpr"
        extra = dict(checkpoint_path=ckpt) if kind == "lbfgs" else {}
        res = run(*build(name, ctx["dir"]), mesh=ctx["m4"], **extra)
        out[f"{kind}_lanes"], out[f"{kind}_vec"] = res.losses.numpy(), _vec(res.model)
        if ctx["rank"] == 0:
            r0 = run(*build(name, ctx["dir"]))
            out[f"{kind}_ref_lanes"], out[f"{kind}_ref_vec"] = r0.losses.numpy(), _vec(r0.model)
    # the checkpoint holds every lane; a rerun resumes from it to the same fit
    res = runs["lbfgs"](*build("sgpr", ctx["dir"]), mesh=ctx["m4"], checkpoint_path=ckpt)
    out["resumed_vec"] = _vec(res.model)
    with np.load(ckpt) as f:
        out["checkpoint_lanes"] = int(f["lanes"])
    return out


@case
def sgpr_clamps(ctx):
    """Kuu's factor shifted by a fraction f of its smallest eigenvalue
    (bisected) that inflates the Nyström trace until one shard's
    Σ K_diag/σ² − tr(AAᵀ) is negative while the sum over the shards stays
    positive: the clamp applied per shard would change the bound, applied to
    the reduced sums it does not."""
    import torch

    from oak_tpu_torch.models import sgpr as sgpr_module
    from oak_tpu_torch.ops import psd
    from oak_tpu_torch.optim.fit import value_and_grad
    from oak_tpu_torch.parallel.mesh import Axis
    from oak_tpu_torch.parallel.sharding import mesh_loss

    axis = Axis.of(ctx["m4"], "data")
    m, _, _ = build("sgpr", ctx["dir"])
    rows = axis.rows(m.X.shape[0])
    old = sgpr_module.cholesky
    out = {}
    try:
        lo, hi = 0.0, 1.0
        for _ in range(60):  # bisect the shift for min(gaps) < 0 < sum(gaps)
            f = 0.5 * (lo + hi)

            def short(K, jitter=None, f=f):
                eye = torch.eye(K.shape[0], dtype=K.dtype)
                return psd.cholesky(K - f * torch.linalg.eigvalsh(K)[0] * eye, jitter=0.0)

            sgpr_module.cholesky = short
            with torch.no_grad():
                terms = m.elbo_terms(m.X[rows], m.Y[rows])
                gap = (terms[3] / m.likelihood.variance.value - terms[4]).reshape(1)
            gaps = axis.gather_rows(gap, axis.size)
            if gaps.min() >= 0.0:
                lo = f
            elif gaps.sum() <= 0.0:
                hi = f
            else:
                break
        out["shift"], out["local_gaps"] = f, gaps
        out["loss"], out["grad"] = value_and_grad(m, mesh_loss(m, axis), torch_vec(m))
        if ctx["rank"] == 0:
            out["ref_loss"], out["ref_grad"] = value_and_grad(
                m, lambda mm: mm.training_loss(), torch_vec(m))
            with torch.no_grad():
                terms = m.elbo_terms(m.X, m.Y)
                out["global_gap"] = terms[3] / m.likelihood.variance.value - terms[4]
    finally:
        sgpr_module.cholesky = old
    return out


@case
def mesh_basics(ctx):
    import torch

    from oak_tpu_torch.parallel import make_mesh, replicate, shard_batch

    out = _errors({"too_many": lambda: make_mesh(5),
                   "shard": lambda: shard_batch(ctx["m4"], np.zeros((6, 2)))})
    mine = torch.full((3,), float(ctx["rank"]), dtype=torch.float64)
    out["replicated"] = replicate(ctx["m4"], {"a": [mine]})["a"][0]
    out["block"] = shard_batch(ctx["m4"], np.arange(8.0))
    return out


@case
def hygiene(ctx):
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "optax", "oak_tpu"))
    return {"bad": np.array(str(bad))}


# --------------------------------------------------------------------------- #
def main(rank: int, world: int, folder: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{folder}/store", rank=rank,
                            world_size=world)
    from oak_tpu_torch.parallel import make_mesh

    ctx = {"rank": rank, "dir": folder, "m4": make_mesh(),
           "mesh2d": init_device_mesh("cpu", (2, 2), mesh_dim_names=("restart", "data"))}
    ctx["m22"] = ctx["mesh2d"]
    results, errors = {}, {}
    for fn in CASES:
        t0 = time.perf_counter()
        try:
            for key, value in fn(ctx).items():
                if isinstance(value, torch.Tensor):
                    value = value.detach().numpy()
                results[f"{fn.__name__}/{key}"] = np.asarray(value)
        except Exception:  # reported by the test of this case
            errors[fn.__name__] = traceback.format_exc()
        results[f"seconds/{fn.__name__}"] = np.asarray(time.perf_counter() - t0)
    np.savez(Path(folder) / f"rank{rank}.npz", **results)
    (Path(folder) / f"rank{rank}.json").write_text(json.dumps(errors))
    dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
