"""Whole multistart L-BFGS fits of a model with continuous, binary and
categorical columns (``models/svgp_oak_mixed.py``), one after another
(closed loop): ``traffic/lbfgs_fits.py``'s fits, loss wrapper, readings and
checks, with this module's reference rows and set-up checks and its
account of the traced launches.

- The reference's rows: the flows with the program's fitted parameters on
  the continuous columns alone, the discrete columns as codes and the
  labels left in {0, 1}.
- ``flow_gap``: as ``lbfgs_fits``'s, over the continuous columns.
- ``lloyd_gain``: as ``lbfgs_fits``'s, on the continuous block of the
  rows and of the inducing points.
- ``z_codes``: the slots of the inducing points' discrete columns off a
  frequency-proportional allocation to the levels of the seed's rows
  (``code_gap``), over all such columns.
- ``loss_rel``, ``grad_leaf``, ``adam_rel``, ``update_rel``, ``dir2_rel``:
  ``lbfgs_fits``'s definitions, against ``reference/svgp_bernoulli.py``.
  A program whose inducing points are not the configuration's number (the
  ``half_batch`` fault, below that number of rows) reads inf in each.

The traced window's K1 and K2 launches carry the discrete dims as E extra
grams a lane (``roofline.k1``, ``roofline.k2``), and its FLOPs are
``svgp_flops``'s.

Parameters and faults: ``lbfgs_fits``'s.
"""

from __future__ import annotations

import importlib
import importlib.util
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import devtrace, harness, roofline
from benchmark.reference import flows as ref_flows
from benchmark.reference import kmeans as ref_kmeans
from benchmark.reference import svgp_bernoulli


def _lbfgs_fits():
    """A copy of ``traffic/lbfgs_fits.py`` of this module's own, whose
    reference rows and set-up checks this module sets."""
    name = "benchmark._loaded.lbfgs_fits_of_mixed"
    spec = importlib.util.spec_from_file_location(name, harness.BENCH / "traffic" / "lbfgs_fits.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


base = _lbfgs_fits()


def _flows(state: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(state[k], dtype=torch.float64, device=device)
            for k in ("skewness", "tailweight", "scale", "shift", "offset")}


def reference_rows(cell: dict, seed: int, state: dict, device, precision):
    """The training rows as the reference makes them for the bound: the
    continuous columns through the flows with the program's fitted
    parameters, the discrete ones as codes, the labels raw."""
    cfg = cell["config"]
    kind = importlib.import_module(f"benchmark.models.{cfg['model']}")
    inp = kind.inputs(cfg, seed)
    continuous = svgp_bernoulli.dims(cfg)[0]
    X = torch.as_tensor(inp["X"], dtype=torch.float64, device=device)
    X[:, continuous] = ref_flows.transform(X[:, continuous], _flows(state, device))
    return (X.to(precision.dtype),
            torch.as_tensor(inp["Y"], dtype=precision.dtype, device=device),
            torch.as_tensor(state["Z"], dtype=precision.dtype, device=device))


def code_gap(col: np.ndarray, z: np.ndarray) -> float:
    """How far the codes ``z`` of a discrete column's inducing points are
    from a frequency-proportional allocation of their slots to the levels
    of ``col``: each level's slots against its share of them, floored and
    ceiled (each at least 1, so that a tie of remainders may go either
    way), the slots outside that range summed, plus the slots that hold no
    level of ``col``."""
    levels, counts = np.unique(col, return_counts=True)
    share = counts / counts.sum() * len(z)
    have = np.array([(z == level).sum() for level in levels])
    low, high = np.maximum(np.floor(share), 1), np.maximum(np.ceil(share), 1)
    return float(np.maximum(low - have, 0).sum() + np.maximum(have - high, 0).sum()
                 + len(z) - have.sum())


def set_up_checks(cell: dict, seed: int, state: dict, device) -> Dict[str, float]:
    """``flow_gap``, ``lloyd_gain`` and ``z_codes``: the program's flows,
    k-means centres and discrete codes against the reference's, fitted in
    float64 to the seed's rows."""
    cfg = cell["config"]
    continuous, binary, categorical = svgp_bernoulli.dims(cfg)
    kind = importlib.import_module(f"benchmark.models.{cfg['model']}")
    x = torch.as_tensor(kind.inputs(cfg, seed)["X"], dtype=torch.float64, device=device)
    xc = x[:, continuous]
    ref = ref_flows.fit(xc)
    prog = _flows(state, device)
    with torch.no_grad():
        at_prog = ref_flows.objective_columns(xc, ref_flows.raw_of(prog), prog["offset"])
        at_ref = ref_flows.objective_columns(xc, ref_flows.raw_of(ref), ref["offset"])
        rows = ref_flows.transform(xc, ref).cpu().numpy()
    Z = state["Z"]
    codes = x.cpu().numpy()
    off = sum(code_gap(codes[:, d], Z[:, d]) for d in binary + categorical)
    return {"flow_gap": float((at_prog - at_ref).max()),
            "lloyd_gain": ref_kmeans.lloyd_gain(rows, Z[:, continuous]),
            "z_codes": off}


class CountingLoss(base.CountingLoss):
    """``lbfgs_fits``'s, recording one lane's evaluations too (as [1, n]): a
    lane whose linesearch goes on alone after the others' have ended is
    evaluated through ``loss_and_grads``, not the lanes form, and
    ``dir2_rel`` needs its points. The loss and gradient are computed as
    ``optim.fit.loss_and_grads`` computes them without it."""

    def loss_and_grads(self, model, raws, inputs, args):
        from oak_tpu_torch.params import call_with

        loss = call_with(model, raws, self, *args)
        grads = torch.autograd.grad(loss, inputs, allow_unused=True, materialize_grads=True)
        loss = loss.detach()
        if len(self.record) < self.record_limit:
            self.record.append({"vecs": inputs[0].detach().double().cpu().reshape(1, -1).clone(),
                                "values": loss.double().cpu().reshape(1),
                                "grads": grads[0].detach().double().cpu().reshape(1, -1)})
        return loss, grads


base.CountingLoss = CountingLoss
base.reference_rows = reference_rows
base.set_up_checks = set_up_checks
control_checks = base.control_checks


def svgp_flops(N: int, M: int, D: int, E: int, depth: int, Q: int, grad: bool) -> float:
    """Model FLOPs of one evaluation of the Bernoulli SVGP bound over N rows
    and M inducing points, D continuous dims and E discrete ones, without
    or with its gradient: ``roofline.svgp_step_flops``'s account of the
    grams, Cholesky, solve and moments (the extra grams' P FMAs an element
    forward, and with the gradient the forward again and 2P - 1 operations
    more), and the quadrature's Q points a row (the grid, the link's
    sigmoid and logs, the weighted sum: about 12 FLOPs a point forward,
    twice that backward)."""
    P = roofline.clamped_depth(depth, D, E)
    if grad:
        body = roofline.svgp_step_flops(N, M, D, depth)
        extra = 2 * (M * M + M * N) * E * (4 * P - 1)
        return body + extra + 3 * 12 * N * Q
    grams = roofline.gram_flops(M, M, D, depth, False) + roofline.gram_flops(M, N, D, depth, False)
    fwd = M ** 3 / 3 + M * M * N + 3 * 2 * M * N
    return (grams + roofline.diag_flops(N, D, depth) + fwd
            + 2 * (M * M + M * N) * E * P + 12 * N * Q)


class Workload(base.Workload):
    def traced_window(self, seconds: float):
        """An untraced window of ``seconds`` first, whose evaluation time the
        FLOP share is taken over, then one whole fit under the profiler."""
        plain = self.window(seconds)
        self.loss.log.clear()
        trace = devtrace.traced(self.fit)
        c = self.cfg
        continuous, binary, categorical = svgp_bernoulli.dims(c)
        N, M, P = c["train_rows"], svgp_bernoulli.inducing(c), c["max_interaction_depth"]
        D, E = len(continuous), len(binary) + len(categorical)
        K1, K2, flops = [], [], 0.0
        for kind, lanes in self.loss.log:
            grad = kind == "grad"
            K1 += [roofline.k1(M, M, D, P, E, lanes), roofline.k1(M, N, D, P, E, lanes)]
            if grad:
                K2 += [roofline.k2(M, M, D, P, E, lanes), roofline.k2(M, N, D, P, E, lanes)]
            flops += lanes * svgp_flops(N, M, D, E, P, c["num_gh"], grad)
        evals = self._evals()
        self.work = {"units": evals, "K1": K1, "K2": K2, "unit_flops": flops / evals,
                     "unit_s": plain.seconds / plain.units}
        seconds_ = trace.window_s if trace is not None else float("nan")
        return harness.Window(units=evals, failed=self.failed_evals, seconds=seconds_), trace

    def checks(self) -> List[harness.Check]:
        if self.state["Z"].shape[0] == svgp_bernoulli.inducing(self.cfg):
            return super().checks()
        values = set_up_checks(self.cell, self.seed, self.state, self.device)
        limits = self.p["limits"]
        return [harness.Check(k, values.get(k, math.inf), limits[k]) for k in limits]
