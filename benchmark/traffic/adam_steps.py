"""Closed-loop full-batch Adam steps, one after another, through
``optim.fit_adam``'s step: one loss-and-gradient evaluation of the lane
(``fit.LaneLoss``), the best finite iterate tracked on the device, the
non-finite gradient entries zeroed, ``torch.optim.Adam``'s update.

Set-up builds the model and the one step object (vector, optimizer, loss),
drives it through its first ``check_steps`` steps, whose losses, first
gradient (from Adam's first moment after one step) and change of the
parameters the reference checks, then warms up ``warm_steps`` more. The
window continues the same object. Unit: one step.

Parameters: ``lr``, ``check_steps``, ``warm_steps``, ``trace_units``,
``limits`` (``loss_rel``, ``grad_leaf``, ``step_leaf``).

Faults (tests): ``unchanged`` (the step leaves the vector as it was),
``half_batch`` (the loss over the first half of the rows, scaled to all),
``altered`` (the step's loss off by 1e-3 of itself).
"""

from __future__ import annotations

import importlib
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark import devtrace, harness, roofline
from benchmark.reference import oak as ref_oak

BETA1 = 0.9


class Workload:
    def __init__(self, cell: dict, seed: int, device: torch.device, fault=None):
        from oak_tpu_torch.optim.fit import LaneLoss, adam, finite_or_zero
        from oak_tpu_torch.params import flatten_trainable

        self.cell, self.cfg, self.p = cell, cell["config"], cell["params"]
        self.seed, self.device, self.fault = seed, device, fault
        self.kind = importlib.import_module(f"benchmark.models.{self.cfg['model']}")
        self.inputs = self.kind.inputs(self.cfg, seed)
        model = self.kind.build(self.cfg, self.inputs, device)
        dt = self.kind.dtype(self.cfg)
        X = torch.as_tensor(self.inputs["X"], dtype=dt, device=device)
        Y = torch.as_tensor(self.inputs["Y"], dtype=dt, device=device)[:, None]
        if fault == "half_batch":
            X, Y = X[: X.shape[0] // 2], Y[: Y.shape[0] // 2]

        self.model = model
        self.lanes = LaneLoss(model, lambda m: m.training_loss(X, Y))
        self.vec = flatten_trainable(model).detach().clone()[None].requires_grad_(True)
        self.opt = adam(self.vec, self.p["lr"])
        self.finite_or_zero = finite_or_zero
        self.best_v = torch.full((1,), float("inf"), dtype=dt, device=device)
        self.best_vec = self.vec.detach().clone()
        self.losses: List[torch.Tensor] = []

        vec0 = self.vec.detach().clone()
        first: List[torch.Tensor] = []
        g1 = None
        for i in range(self.p["check_steps"]):
            first.append(self.step())
            if i == 0:
                # the gradient as Adam got it: its first moment after one
                # step over (1 - beta1); none where the step was not taken
                state = self.opt.state[self.vec]
                g1 = (state["exp_avg"].detach().clone() / (1 - BETA1) if state
                      else torch.zeros_like(self.vec.detach()))
        self.readings = {
            "losses": torch.cat(first).double().cpu().numpy(),
            "grad": self.kind.leaves(model, g1),
            "change": self.kind.leaves(model, self.vec.detach() - vec0),
        }
        for _ in range(self.p["warm_steps"]):
            self.step()
        self.losses.clear()
        self.work = None

    def step(self) -> torch.Tensor:
        """fit_adam's step; returns its loss (on the device)."""
        v, g = self.lanes.value_and_grad(self.vec)
        if self.fault == "altered":
            v = v * (1 + 1e-3)
        better = torch.isfinite(v) & (v < self.best_v)
        self.best_v = torch.where(better, v, self.best_v)
        self.best_vec = torch.where(better[:, None], self.vec.detach(), self.best_vec)
        self.vec.grad = self.finite_or_zero(g)
        if self.fault != "unchanged":
            self.opt.step()
        self.losses.append(v)
        return v

    def _failed(self) -> int:
        if not self.losses:
            return 0
        n = int((~torch.isfinite(torch.cat(self.losses))).sum())
        self.losses.clear()
        return n

    def window(self, seconds: float) -> harness.Window:
        w = harness.closed_loop(self.step, seconds, self.device)
        w.failed = self._failed()
        return w

    def traced_window(self, seconds: float):
        """An untraced window of ``seconds`` first, whose step time the
        whole step's FLOP share is taken over (the profiler slows the host),
        then ``trace_units`` steps under the profiler."""
        plain = self.window(seconds)
        n = self.p["trace_units"]

        def steps():
            for _ in range(n):
                self.step()

        trace = devtrace.traced(steps)
        c = self.cfg
        N, M, D, P = c["num_data"], c["num_inducing"], c["num_dims"], c["max_interaction_depth"]
        self.work = {
            "units": n,
            "K1": [roofline.k1(M, M, D, P), roofline.k1(M, N, D, P)] * n,
            "K2": [roofline.k2(M, M, D, P), roofline.k2(M, N, D, P)] * n,
            "unit_flops": roofline.svgp_step_flops(N, M, D, P),
            "unit_s": plain.seconds / plain.units,
        }
        seconds_ = trace.window_s if trace is not None else float("nan")
        return harness.Window(units=n, failed=self._failed(), seconds=seconds_), trace

    def end_to_end(self, w: harness.Window) -> Dict[str, float]:
        """The device's busy time a step over the whole window; nothing
        where the window saw no device."""
        busy = w.extra.get("busy_s")
        return {} if busy is None else {"train_device_ms": 1e3 * busy / w.units}

    def release(self) -> None:
        for name in ("model", "lanes", "vec", "opt", "best_v", "best_vec"):
            setattr(self, name, None)

    def checks(self) -> List[harness.Check]:
        ref = reference_readings(self.cell, self.seed, self.device, ref_oak.F64)
        return compare(self.cell, self.readings, ref)


def reference_readings(cell: dict, seed: int, device: torch.device,
                       precision: ref_oak.Precision) -> dict:
    """The reference's first ``check_steps`` Adam steps from the model's
    initial values, in ``precision``: the same readings as the program's."""
    cfg, p = cell["config"], cell["params"]
    kind = importlib.import_module(f"benchmark.models.{cfg['model']}")
    ref = importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    inp = kind.inputs(cfg, seed)
    kw = dict(dtype=precision.dtype, device=device)
    X, Y, Z = (torch.as_tensor(inp[k], **kw) for k in ("X", "Y", "Z"))
    leaves = ref.initial_leaves(cfg, Z.shape[0], precision, device)
    start = {k: v.clone() for k, v in leaves.items()}
    adam = ref_oak.Adam(leaves, p["lr"])
    losses, grad = [], None
    for i in range(p["check_steps"]):
        value, g = ref_oak.value_and_grad(
            lambda lv: ref.loss(cfg, X, Y, Z, lv, precision), leaves)
        losses.append(float(value))
        if i == 0:
            grad = g
        leaves = adam.step(leaves, g)
    change = {k: leaves[k] - start[k] for k in leaves}
    return {"losses": np.asarray(losses), "grad": kind.split(grad),
            "change": kind.split(change)}


def compare(cell: dict, prog: dict, ref: dict) -> List[harness.Check]:
    """``loss_rel``: the largest relative gap of a checked step's loss;
    ``grad_leaf``: the worst leaf's gap of the first gradient's norm;
    ``step_leaf``: the worst leaf's gap of the change's norm, over the leaves
    whose reference gradient is at least a thousandth of the median
    leaf's."""
    limits = cell["params"]["limits"]
    loss_rel = float(np.max(np.abs(prog["losses"] - ref["losses"]) / np.abs(ref["losses"])))
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in ref["grad"].items()}
    median = sorted(norms.values())[len(norms) // 2]
    moved = [k for k, n in norms.items() if n >= 1e-3 * median]
    dropped = {k: n / median for k, n in norms.items() if n < 1e-3 * median}
    if dropped:
        print(f"step_leaf leaves out {dropped!r} (|g| over the median leaf's)", file=sys.stderr)
    return [harness.Check("loss_rel", loss_rel, limits["loss_rel"]),
            harness.Check("grad_leaf", harness.leaf_gap(prog["grad"], ref["grad"]),
                          limits["grad_leaf"]),
            harness.Check("step_leaf", harness.leaf_gap(prog["change"], ref["change"], moved),
                          limits["step_leaf"])]


def control_checks(cell: dict, seed: int, device: torch.device) -> List[harness.Check]:
    """The control: the reference in the program's place, in TF32, judged
    as the program is."""
    ref = reference_readings(cell, seed, device, ref_oak.F64)
    return compare(cell, reference_readings(cell, seed, device, ref_oak.TF32), ref)
