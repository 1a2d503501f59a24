"""Whole multistart L-BFGS fits, one after another (closed loop), as
``oak_model._optimise_lbfgs`` runs them with ``restarts``:
``optim.multistart.fit_lbfgs_multistart`` with the configuration's
``restarts`` jittered starts (the first the model's own), each lane's
``warm_adam_steps`` Adam steps at ``warm_lr`` and then ``max_iters``
L-BFGS iterations, the cell's ``jitter``, the fits' acceptance rule, every
evaluation of all the lanes still searching one batched program
(``fit.LaneLoss``). Each fit starts from the built model's parameters with
a start seed of its own.

The loss handed in is the model's training loss wrapped to count the
evaluations (the unit of ``train_device_ms`` and ``host_step_ms.train``: a
loss-and-gradient evaluation
of the lanes, batched or of one lane) and the lanes each one had.

Set-up builds the model (flows, scalers, k-means, SGPR) and runs the first
fit, recording its evaluations up to the second L-BFGS iteration's first:
their lane vectors, losses and gradients. After the window the reference
checks, each against its limit:

- ``flow_gap``: the flows. The reference fits its own flows to the seed's
  rows in float64; the worst column's objective at the program's flow
  parameters above the reference's optimum, in nats.
- ``lloyd_gain``: the inducing points. On the rows that the reference's
  own flows make, the share by which one more Lloyd step lowers the
  inertia of the program's k-means centres (converged centres read 0).
- ``loss_rel``, ``grad_leaf``: the bound and its gradient, the reference's
  at the recorded lane vectors, on the rows it transforms with the
  program's flows, with the program's centres (both judged above).
- ``adam_rel``: Adam's first move, against -warm_lr g / (|g| + eps) of the
  reference's gradient, over the leaves whose gradient is not nought to
  rounding (a thousandth of the median leaf's or more).
- ``update_rel``: L-BFGS's first move, min(1, 1/|g|) g down the gradient.
- ``dir2_rel``: the second L-BFGS iteration's first trial against the
  reference's two-loop direction, built from its own gradients at the
  first iterate and at each point of the first linesearch, the best match
  (the program's linesearch picked one of them).

The starts (the model's vector plus ``jitter`` standard normals from the
fit's seed) are the reference's too, read as ``start_rel`` on standard
error; neither the control nor a fault moves that number, so it decides
nothing.

Parameters: ``jitter``, ``limits`` (the numbers above).

Faults (tests): ``unchanged`` (the L-BFGS direction is zero, so no
L-BFGS step moves the vector), ``half_batch`` (the set-up and the bound on
the first half of the rows: flows, k-means and SGPR), ``altered`` (every
evaluation's losses off by 1e-3 of themselves), ``steepest`` (every
L-BFGS direction down the gradient, at the length of the two-loop's).
"""

from __future__ import annotations

import importlib
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark import devtrace, harness, roofline
from benchmark.reference import flows as ref_flows
from benchmark.reference import kmeans as ref_kmeans
from benchmark.reference import oak as ref_oak

ADAM_EPS = 1e-8
# a point lies on a linesearch's line when its distance to the line is
# under this share of the vectors' size (float32 rounding is ~1e-7)
ON_LINE = 1e-4


class CountingLoss:
    """``loss_fn`` with a lanes form (``lanes_value_and_grad``,
    ``lanes_values``) that the multistart's ``LaneLoss`` calls for more than
    one lane; it evaluates them with a ``LaneLoss`` of the plain loss, the
    same batched program, and logs each evaluation: ("grad" or "value",
    lanes). One lane comes through ``__call__``."""

    def __init__(self, model, loss_fn, fault=None):
        from oak_tpu_torch.optim.fit import LaneLoss

        self.loss_fn, self.fault = loss_fn, fault
        self.inner = LaneLoss(model, loss_fn)
        self.log: List[tuple] = []
        self.record: List[dict] = []
        self.record_limit = 0

    def __call__(self, m):
        self.log.append(("grad" if torch.is_grad_enabled() else "value", 1))
        return self._altered(self.loss_fn(m))

    def _altered(self, v):
        return v * (1 + 1e-3) if self.fault == "altered" else v

    def lanes_value_and_grad(self, model, vecs):
        v, g = self.inner.value_and_grad(vecs)
        v = self._altered(v)
        self.log.append(("grad", vecs.shape[0]))
        if len(self.record) < self.record_limit:
            # copies: Adam steps its vector in place
            self.record.append({"vecs": vecs.detach().double().cpu().clone(),
                                "values": v.detach().double().cpu().clone(),
                                "grads": g.detach().double().cpu().clone()})
        return v, g

    def lanes_values(self, model, vecs):
        self.log.append(("value", vecs.shape[0]))
        return self._altered(self.inner.values(vecs))


class Workload:
    def __init__(self, cell: dict, seed: int, device: torch.device, fault=None):
        from oak_tpu_torch.optim import fit as fit_mod
        from oak_tpu_torch.optim.multistart import fit_lbfgs_multistart
        from oak_tpu_torch.params import assign_trainable, flatten_trainable

        self.cell, self.cfg, self.p = cell, cell["config"], cell["params"]
        self.seed, self.device, self.fault = seed, device, fault
        self._restore = None
        if fault in ("unchanged", "steepest"):
            direction = fit_mod._direction

            def zero_direction(state, vec, grad):
                return torch.zeros_like(direction(state, vec, grad))

            def steepest(state, vec, grad):
                d = direction(state, vec, grad)
                return grad * (torch.linalg.vector_norm(d, dim=1, keepdim=True)
                               / torch.linalg.vector_norm(grad, dim=1, keepdim=True))

            fit_mod._direction = zero_direction if fault == "unchanged" else steepest
            self._restore = (fit_mod, direction)
        self.kind = importlib.import_module(f"benchmark.models.{self.cfg['model']}")
        self.inputs = self.kind.inputs(self.cfg, seed)
        if fault == "half_batch":
            h = self.inputs["X"].shape[0] // 2
            self.inputs = {k: v[:h] for k, v in self.inputs.items()}
        oak = self.kind.build(self.cfg, self.inputs, device)
        self.state = self.kind.state(oak)
        model = oak.m
        loss_fn = oak._loss_fn()
        self.oak, self.model = oak, model
        self.loss = CountingLoss(model, loss_fn, fault)
        self.vec0 = flatten_trainable(model).detach().clone()
        self.names = list(self.kind.leaves(model, self.vec0))
        self.assign, self.multistart = assign_trainable, fit_lbfgs_multistart
        self.fits, self.fit_seeds, self.failed_evals = 0, [], 0

        # Adam's steps, L-BFGS's first evaluation and its first linesearch,
        # then the second iteration's first trial
        self.loss.record_limit = (self.cfg["warm_adam_steps"] + 3
                                  + fit_mod.MAX_LINESEARCH_STEPS)
        self.fit()
        self.loss.record_limit = 0
        self.readings = self.loss.record
        self.loss.log.clear()
        self.failed_evals = 0
        self.work = None

    def _accept(self, m) -> bool:
        return not (self.oak._degenerate_noise_fit(m) or self.oak._pathological_fit(m))

    def fit(self) -> None:
        """One whole multistart fit from the built model's parameters."""
        fit_seed = (self.seed * 1000003 + self.fits) % 2 ** 32
        self.fit_seeds.append(fit_seed)
        self.fits += 1
        self.assign(self.model, self.vec0)
        before = len(self.loss.log)
        res = self.multistart(self.model, self.loss, n_starts=self.cfg["restarts"],
                              jitter=self.p["jitter"], seed=fit_seed,
                              max_iters=self.cfg["max_iters"],
                              warm_adam_steps=self.cfg["warm_adam_steps"],
                              warm_lr=self.cfg["warm_lr"], include_init=True,
                              accept_fn=self._accept)
        if not np.isfinite(res.fun):
            self.failed_evals += sum(1 for kind, _ in self.loss.log[before:] if kind == "grad")

    def _evals(self) -> int:
        return sum(1 for kind, _ in self.loss.log if kind == "grad")

    def window(self, seconds: float) -> harness.Window:
        self.loss.log.clear()
        self.failed_evals = 0
        w = harness.closed_loop(self.fit, seconds, self.device)
        return harness.Window(units=self._evals(), failed=self.failed_evals, seconds=w.seconds)

    def traced_window(self, seconds: float):
        """An untraced window of ``seconds`` first, whose evaluation time the
        FLOP share is taken over, then one whole fit under the profiler."""
        plain = self.window(seconds)
        self.loss.log.clear()
        trace = devtrace.traced(self.fit)
        c = self.cfg
        N, M, D, P = c["train_rows"], c["num_inducing"], c["num_dims"], c["max_interaction_depth"]
        K1, K2, flops = [], [], 0.0
        for kind, lanes in self.loss.log:
            grad = kind == "grad"
            K1 += [roofline.k1(M, M, D, P, lanes=lanes), roofline.k1(M, N, D, P, lanes=lanes)]
            if grad:
                K2 += [roofline.k2(M, M, D, P, lanes=lanes), roofline.k2(M, N, D, P, lanes=lanes)]
            flops += lanes * roofline.sgpr_flops(N, M, D, P, grad)
        evals = self._evals()
        self.work = {"units": evals, "K1": K1, "K2": K2, "unit_flops": flops / evals,
                     "unit_s": plain.seconds / plain.units}
        seconds_ = trace.window_s if trace is not None else float("nan")
        return harness.Window(units=evals, failed=self.failed_evals, seconds=seconds_), trace

    def end_to_end(self, w: harness.Window) -> Dict[str, float]:
        """The device's busy time a evaluation over the whole window; nothing
        where the window saw no device."""
        busy = w.extra.get("busy_s")
        return {} if busy is None else {"train_device_ms": 1e3 * busy / w.units}

    def release(self) -> None:
        self.first_fit_seed = self.fit_seeds[0]
        self.oak = self.model = self.loss = None
        if self._restore is not None:
            module, direction = self._restore
            module._direction = direction
            self._restore = None

    def checks(self) -> List[harness.Check]:
        return compare(self.cell, self.seed, self.device, self.readings, self.state,
                       self.names, self.first_fit_seed)


def _flat(d: Dict[str, torch.Tensor], names: List[str]) -> torch.Tensor:
    return torch.cat([d[k].reshape(-1).double() for k in names])


def reference_rows(cell: dict, seed: int, state: dict, device, precision):
    """The training rows as the reference makes them for the bound: the
    flows with the program's fitted parameters, the targets
    standardised."""
    cfg = cell["config"]
    kind = importlib.import_module(f"benchmark.models.{cfg['model']}")
    inp = kind.inputs(cfg, seed)
    kw = dict(dtype=torch.float64, device=device)
    x = torch.as_tensor(inp["X"], **kw)
    flows = {k: torch.as_tensor(state[k], **kw)
             for k in ("skewness", "tailweight", "scale", "shift", "offset")}
    y = torch.as_tensor(inp["Y"], **kw)
    y = (y - y.mean()) / y.std(unbiased=False)
    X = ref_flows.transform(x, flows)
    return (X.to(precision.dtype), y.to(precision.dtype),
            torch.as_tensor(state["Z"], dtype=precision.dtype, device=device))


def set_up_checks(cell: dict, seed: int, state: dict, device) -> Dict[str, float]:
    """``flow_gap`` and ``lloyd_gain``: the program's flows and k-means
    centres against the reference's own flows, fitted in float64 to the
    seed's rows."""
    cfg = cell["config"]
    kind = importlib.import_module(f"benchmark.models.{cfg['model']}")
    x = torch.as_tensor(kind.inputs(cfg, seed)["X"], dtype=torch.float64, device=device)
    ref = ref_flows.fit(x)
    prog = {k: torch.as_tensor(state[k], dtype=torch.float64, device=device)
            for k in ("skewness", "tailweight", "scale", "shift", "offset")}
    with torch.no_grad():
        at_prog = ref_flows.objective_columns(x, ref_flows.raw_of(prog), prog["offset"])
        at_ref = ref_flows.objective_columns(x, ref_flows.raw_of(ref), ref["offset"])
        rows = ref_flows.transform(x, ref).cpu().numpy()
    return {"flow_gap": float((at_prog - at_ref).max()),
            "lloyd_gain": ref_kmeans.lloyd_gain(rows, state["Z"])}


def reference_at(cell: dict, seed: int, state: dict, names: List[str], device, precision):
    """vec -> (loss, split gradient) of the reference in ``precision`` at a
    lane vector laid out as the program's (leaf ``names``)."""
    cfg = cell["config"]
    kind = importlib.import_module(f"benchmark.models.{cfg['model']}")
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    X, Y, Z = reference_rows(cell, seed, state, device, precision)
    like = ref.initial_leaves(cfg, precision, device)
    split_like = kind.split(like)
    sizes = [split_like[k].numel() for k in names]

    def at(vec: torch.Tensor):
        pieces = torch.split(vec.reshape(-1).double(), sizes)
        lv = kind.join(dict(zip(names, pieces)), like)
        value, g = ref_oak.value_and_grad(lambda l: ref.loss(cfg, X, Y, Z, l, precision), lv)
        return float(value), kind.split(g)

    return at


def _off_line(v: torch.Tensor, x0: torch.Tensor, u: torch.Tensor) -> float:
    """The distance of v from the line x0 + a u, over the vectors' size."""
    w = v - x0
    rest = w - (w @ u) / (u @ u) * u
    return float(torch.linalg.vector_norm(rest)
                 / (torch.linalg.vector_norm(x0) + torch.linalg.vector_norm(w)))


def _two_loop(s: torch.Tensor, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The L-BFGS direction H g with one pair (s, y): the identity scaled by
    <s, y> / <y, y>, then the pair's update (Nocedal and Wright, alg. 7.4)."""
    sy, yy = float(s @ y), float(y @ y)
    rho = 0.0 if sy == 0.0 else 1.0 / sy
    a = rho * float(s @ g)
    q = g - a * y
    r = (sy / yy if yy > 0.0 else 1.0) * q
    return r + (a - rho * float(y @ r)) * s


def second_direction(records: List[dict], grad_at) -> float:
    """``dir2_rel``: records[0] is L-BFGS's first evaluation (every lane),
    records[1] its first trial, then the linesearch's rounds and the second
    iteration's first trial. For each lane, the second trial against c -
    H g(c) of each point c of the lane's first linesearch, the best of
    them; the worst lane. ``grad_at(i, lane)``: the reference's flat
    gradient at records[i]'s row ``lane``."""
    x0 = records[0]["vecs"]
    R = x0.shape[0]
    if len(records) < 3 or records[1]["vecs"].shape[0] != R:
        return float("inf")
    u = records[1]["vecs"] - x0
    if not bool((torch.linalg.vector_norm(u, dim=1) > 0).all()):
        return float("inf")
    points: List[List[tuple]] = [[(1, lane)] for lane in range(R)]
    for i in range(2, len(records)):
        vecs = records[i]["vecs"]
        gaps = [[_off_line(v, x0[l], u[l]) for l in range(R)] for v in vecs]
        if all(min(g) < ON_LINE for g in gaps):
            for row, g in enumerate(gaps):
                points[int(np.argmin(g))].append((i, row))
            continue
        if vecs.shape[0] != R:
            return float("inf")
        worst = 0.0
        for lane in range(R):
            g0 = grad_at(0, lane)
            best = float("inf")
            for j, row in points[lane]:
                c, gc = records[j]["vecs"][row], grad_at(j, row)
                r = _two_loop(c - x0[lane], gc - g0, gc)
                best = min(best, float(torch.linalg.vector_norm(vecs[lane] - (c - r))
                                       / torch.linalg.vector_norm(r)))
            worst = max(worst, best)
        return worst
    return float("inf")


def compare(cell: dict, seed: int, device, readings: List[dict], state: dict,
            names: List[str], fit_seed: int) -> List[harness.Check]:
    """The numbers of the module's docstring, each with its limit.
    ``start_rel``, the first evaluation's vectors against the reference's
    starts, is printed only."""
    cfg, p = cell["config"], cell["params"]
    limits = p["limits"]
    W = cfg["warm_adam_steps"]
    values = dict(set_up_checks(cell, seed, state, device))
    if len(readings) < W + 2:
        values.update({k: float("inf") for k in limits if k not in values})
        return [harness.Check(k, values[k], limits[k]) for k in limits]
    at = reference_at(cell, seed, state, names, device, ref_oak.F64)
    cache: Dict[tuple, tuple] = {}
    loss_rel = grad_leaf = 0.0

    def ref(i: int, lane: int):
        """The reference's (split, flat) gradient at readings[i]'s row
        ``lane``, the loss and gradient gaps taken on the way; (None, NaNs)
        where its bound has no value (rows or centres that make a factor
        singular), which nothing the program says can match."""
        nonlocal loss_rel, grad_leaf
        if (i, lane) not in cache:
            ev = readings[i]
            try:
                value, g = at(ev["vecs"][lane])
            except torch.linalg.LinAlgError:
                loss_rel = grad_leaf = float("inf")
                cache[i, lane] = (None, torch.full_like(ev["grads"][lane], float("nan")))
                return cache[i, lane]
            gap = abs(float(ev["values"][lane]) - value) / abs(value)
            loss_rel = max(loss_rel, gap if np.isfinite(gap) else float("inf"))
            prog = dict(zip(names, torch.split(ev["grads"][lane],
                                               [g[k].numel() for k in names])))
            grad_leaf = max(grad_leaf, harness.leaf_gap(prog, g))
            cache[i, lane] = (g, _flat(g, names))
        return cache[i, lane]

    R = readings[0]["vecs"].shape[0]
    # Adam's first move, over the leaves that are not nought to rounding
    adam_rel = float("inf") if W >= 2 else 0.0
    if W >= 2 and readings[1]["vecs"].shape == readings[0]["vecs"].shape:
        adam_rel = 0.0
        for lane in range(R):
            g, flat = ref(0, lane)
            if g is None:
                adam_rel = float("inf")
                continue
            norms = {k: float(torch.linalg.vector_norm(v)) for k, v in g.items()}
            median = sorted(norms.values())[len(norms) // 2]
            keep = torch.cat([torch.full((g[k].numel(),), norms[k] >= 1e-3 * median)
                              for k in names])
            dropped = {k: norms[k] / median for k in names if norms[k] < 1e-3 * median}
            if dropped:
                print(f"adam_rel lane {lane} leaves out {dropped!r} (|g| over the median "
                      f"leaf's)", file=sys.stderr)
            move = (readings[1]["vecs"][lane] - readings[0]["vecs"][lane])[keep]
            expect = (-cfg["warm_lr"] * flat / (flat.abs() + ADAM_EPS))[keep]
            adam_rel = max(adam_rel, float(torch.linalg.vector_norm(move - expect)
                                           / torch.linalg.vector_norm(expect)))

    lb = readings[W:]
    update_rel = float("inf")
    if len(lb) > 1 and lb[1]["vecs"].shape == lb[0]["vecs"].shape:
        g0 = torch.stack([ref(W, lane)[1] for lane in range(R)])
        move = lb[1]["vecs"] - lb[0]["vecs"]
        norm = torch.linalg.vector_norm(g0, dim=1, keepdim=True)
        expect = -torch.clamp(1.0 / norm, max=1.0) * g0
        update_rel = float((torch.linalg.vector_norm(move - expect, dim=1)
                            / torch.linalg.vector_norm(expect, dim=1)).max())
    dir2_rel = second_direction(lb, lambda i, lane: ref(W + i, lane)[1])
    # every recorded evaluation up to the second iteration's first trial
    # has been compared; Adam's first evaluation too
    for lane in range(R):
        ref(0, lane)

    kind = importlib.import_module(f"benchmark.models.{cfg['model']}")
    refmod = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    v0 = _flat(kind.split(refmod.initial_leaves(cfg)), names).numpy()
    rng = np.random.default_rng(fit_seed)
    starts = v0[None, :] + p["jitter"] * rng.standard_normal((cfg["restarts"], v0.shape[0]))
    starts[0] = v0
    first = readings[0]["vecs"].numpy()
    start_rel = (float(np.abs(first - starts).max() / np.abs(starts).max())
                 if first.shape == starts.shape else float("inf"))
    print(f"start_rel (not compared): {start_rel!r}", file=sys.stderr)
    smallest = min((abs(float(readings[i]["values"][lane])) for i, lane in cache), default=0.0)
    print(f"the smallest |loss| compared: {smallest!r}", file=sys.stderr)
    values.update(loss_rel=loss_rel, grad_leaf=grad_leaf, adam_rel=adam_rel,
                  update_rel=update_rel, dir2_rel=dir2_rel)
    return [harness.Check(k, values[k], limits[k]) for k in limits]


def control_checks(cell: dict, seed: int, device: torch.device) -> List[harness.Check]:
    """The control: the program's set-up and first fit record the lane
    vectors; the reference in TF32 takes the program's place at them (its
    losses and gradients), judged as the program is."""
    s = Workload(cell, seed, device)
    s.release()
    at = reference_at(cell, seed, s.state, s.names, device, ref_oak.TF32)
    readings = []
    for ev in s.readings:
        lanes = [at(v) for v in ev["vecs"]]
        readings.append({"vecs": ev["vecs"],
                         "values": torch.tensor([v for v, _ in lanes], dtype=torch.float64),
                         "grads": torch.stack([_flat(g, s.names) for _, g in lanes])})
    return compare(cell, seed, device, readings, s.state, s.names, s.first_fit_seed)
