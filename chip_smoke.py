#!/usr/bin/env python3
"""Smoke run of the PyTorch port (oak_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of findings; any failure raises and exits
non-zero before the result line:

0. device: a CUDA card, its name and power limit from nvidia-smi, float32
   matmuls in full precision (no TF32);
1. build: compiles csrc/*.cu with nvcc into .kernel_build/ (ptxas registers
   and spills of both kernels);
2. kernel: the fused OAK gram forward kernel against its plain torch version
   on the card, at the predict path's Kus and Kuu (from the model below), a
   ragged shape, every depth 1..8 and a mixed case with 2 extra grams; max
   error relative to max |plain| under 1e-4; both timed with CUDA events at
   Kus;
2b. backward kernel: every cotangent of the gram backward kernel against
   autograd of the plain gram and against the written-out plain backward,
   for a seeded gbar, at the training path's Kuf and Kuu and the same shared
   cases; max error relative to max |reference| under 1e-3; forward plus
   backward timed at Kuf in turns plain, kernel, kernel, plain;
3. predict path: the bench's SVGP (N = 8192, D = 32, M = 512, depth 3,
   q_diag, whitened, float32) on the card answers predict_y requests of 1,
   100, 2048 and 8192 rows; the outputs are finite, the kernel was launched,
   and the 8192 request agrees with the same model in float64 on the CPU
   (the plain per-dim route) within 1e-3 relative to max magnitude;
4. training path: the bench's SVGP as bench.py builds it (create defaults):
   the training-loss gradient at the start point against the same model in
   float64 on the card (the per-dim route; loss within 1e-3 relative,
   gradient within 1e-2 of max |g|); 50 fit_adam steps;
   20 Adam steps of the bench's Bernoulli variant; 20 fit_natgrad_adam steps
   (γ 0.1) on a q_diag=False copy. Every loss is finite, each best loss is
   below its first, and both kernels were launched.

Then one JSON line about the kernels, and as the last line
{"ok": true, "device": {...}}. Imports no JAX.

    python3 chip_smoke.py --profile

runs phases 0-1 and then, in place of the checks, the breakdown of a warm
predict_y request and of a warm training step (PERF.md "Where the time
goes"); it prints no result line.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N, D, M, DEPTH = 8192, 32, 512, 3
KERNEL_TOL = 1e-4  # the Pallas gate's forward bound, relative to max |plain|
GRAD_TOL = 1e-3  # the Pallas gate's gradient bound (bench.py:1326-1327)
E2E_TOL = 1e-3  # f32 on the card against f64 on the CPU, relative to max magnitude
LOSS_TOL, TRAIN_GRAD_TOL = 1e-3, 1e-2  # the training gradient against f64
BATCHES = (1, 100, 2048, 8192)
TIMING_ITERS = 20
ADAM_STEPS, BERNOULLI_STEPS, NATGRAD_STEPS = 50, 20, 20  # bench.py's --steps default
GRAD_NAMES = ("du1", "du2", "dc1", "dc2", "dextra", "dlogb", "dsig2")


def synth_pumadyn(n=8192, d=32, seed=0):
    """The bench's synthetic pumadyn-shaped data (bench.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d) / np.sqrt(d)
    y = np.tanh(X @ w) + 0.5 * X[:, 0] * X[:, 1] + 0.1 * rng.normal(size=n)
    return X.astype(np.float32), y.reshape(-1, 1).astype(np.float32)


def build_model(device, dtype=torch.float32):
    """The bench's SVGP with parameters drawn from a seed (an untrained model
    predicts 0): lengthscales U(1, 3), order variances (1, 0.5, 0.2, 0.05),
    q_mu N(0, 1), q_sqrt U(0.1, 0.5)."""
    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.models import SVGP, Gaussian

    X, _ = synth_pumadyn(N, D)
    Z = X[np.random.default_rng(1).choice(N, M, replace=False)]
    kernel = OAKKernel.create(num_dims=D, max_interaction_depth=DEPTH,
                              use_sparsity_prior=True, lengthscale_bounds=[1e-3, 1e3],
                              dtype=dtype, device=device)
    model = SVGP.create(kernel, Gaussian.create(0.01, dtype=dtype, device=device), Z,
                        num_data=N, q_diag=True, whiten=True, dtype=dtype, device=device)
    rng = np.random.default_rng(2)
    for k in model.kernel.kernels:
        k.lengthscale.assign(rng.uniform(1.0, 3.0))
    for v, value in zip(model.kernel.variances, (1.0, 0.5, 0.2, 0.05)):
        v.assign(value)
    model.q_mu.assign(rng.normal(size=(M, 1)))
    model.q_sqrt.assign(rng.uniform(0.1, 0.5, size=(M, 1)))
    return model, X


def build_bench_model(device, likelihood="gaussian", q_diag=True, dtype=torch.float32):
    """The bench's SVGP exactly as bench.py::_build_model builds it: create
    defaults, sparsity prior, lengthscale bounds [1e-3, 1e3], Gaussian 0.01
    or the Bernoulli variant (labels drawn through a logistic link, seed 2).
    Returns (model, X, Y) with X, Y on the card."""
    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.models import SVGP, Bernoulli, Gaussian

    X, Y = synth_pumadyn(N, D)
    if likelihood == "bernoulli":
        rng = np.random.default_rng(2)
        p = 1.0 / (1.0 + np.exp(-3.0 * Y[:, 0]))
        Y = (rng.uniform(size=len(p)) < p).astype(np.float32).reshape(-1, 1)
        lik = Bernoulli.create()
    else:
        lik = Gaussian.create(0.01, dtype=dtype, device=device)
    Z = X[np.random.default_rng(1).choice(N, M, replace=False)]
    kernel = OAKKernel.create(num_dims=D, max_interaction_depth=DEPTH,
                              use_sparsity_prior=True, lengthscale_bounds=[1e-3, 1e3],
                              dtype=dtype, device=device)
    model = SVGP.create(kernel, lik, Z, num_data=N, q_diag=q_diag, dtype=dtype,
                        device=device)
    return (model, torch.as_tensor(X, dtype=dtype, device=device),
            torch.as_tensor(Y, dtype=dtype, device=device))


def serve(model, X, device):
    """Answer one predict_y request per batch size: rows go host -> card,
    predictions card -> host. Returns [(rows, seconds, mean, var)]."""
    out = []
    with torch.no_grad():
        for b in BATCHES:
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean, var = model.predict_y(torch.from_numpy(X[:b]).to(device))
            # the copy to the host waits for the card
            mean, var = mean.cpu().numpy(), var.cpu().numpy()
            out.append((b, time.perf_counter() - t0, mean, var))
    return out


def rel_err(a, ref):
    return float(np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max())


def _cuda_ms(fn, iters):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs only on a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    if torch.get_float32_matmul_precision() != "highest" or \
            torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("float32 matmuls are not in full precision (TF32 is on)")
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase 0 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, TF32 off")


def phase_build():
    from oak_tpu_torch import _build

    b = _build.build()
    # ptxas -v: per entry function, a stack/spill line then a registers line
    ptxas, entry = [], "?"
    for line in b.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            depth = re.search(r"oak_gram_(fwd|bwd)_kernelILi(\d+)E", m.group(1))
            entry = f"{depth.group(1)} P={depth.group(2)}" if depth else m.group(1)
        elif "registers" in line or "spill" in line:
            ptxas.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    print(f"phase 1 build: {b.seconds:.2f} s -> {b.path.relative_to(REPO)}; "
          f"ptxas: {' | '.join(ptxas)}")
    return b.seconds


def phase_kernel(model, X, device):
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import KERNEL_CASES, prescaled_inputs

    with torch.no_grad():
        Z = model.Z.value
        Xd = torch.from_numpy(X).to(device)
        cases = [("Kus", og._prep(model.kernel, Z, Xd) + (DEPTH,)),
                 ("Kuu", og._prep(model.kernel, Z, Z) + (DEPTH,))]
        cases += [(name, tuple(prescaled_inputs(seed, d, n, m, e, p, device)) + (p,))
                  for seed, (name, d, n, m, e, p) in enumerate(KERNEL_CASES, start=3)]
        findings = []
        for name, args in cases:
            out = og.oak_gram_fused(*args)
            torch.cuda.synchronize()
            ref = og.oak_gram_plain(*args)
            torch.cuda.synchronize()
            if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"kernel {name}: shape {tuple(out.shape)} or non-finite")
            err = float((out - ref).abs().max() / ref.abs().max())
            if name == "Kus":
                kus_abs_err = float((out - ref).abs().max())
            findings.append(f"{name} {err:.2e}")
            if not err < KERNEL_TOL:
                raise RuntimeError(f"kernel {name}: error {err:.3e} >= {KERNEL_TOL}")

        kus = cases[0][1]
        for _ in range(3):  # warm-up
            og.oak_gram_fused(*kus)
            og.oak_gram_plain(*kus)
        torch.cuda.synchronize()
        turns = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = og.oak_gram_plain if which == "plain" else og.oak_gram_fused
            turns[which].append(_cuda_ms(lambda: fn(*kus), TIMING_ITERS))
        kuu = cases[1][1]
        kuu_ms = _cuda_ms(lambda: og.oak_gram_fused(*kuu), TIMING_ITERS)
        kuu_plain_ms = _cuda_ms(lambda: og.oak_gram_plain(*kuu), TIMING_ITERS)
    ms, plain_ms = float(np.mean(turns["kernel"])), float(np.mean(turns["plain"]))
    print(f"phase 2 kernel vs plain (max err / max |plain|, tol {KERNEL_TOL}): "
          f"{', '.join(findings)}; Kus 512x8192 kernel {turns['kernel']} ms, "
          f"plain {turns['plain']} ms (turns plain, kernel, kernel, plain; "
          f"{TIMING_ITERS} launches each); Kuu 512x512 kernel {kuu_ms:.4f} ms, "
          f"plain {kuu_plain_ms:.4f} ms")
    return dict(max_abs_err=kus_abs_err, ms=ms, plain_ms=plain_ms)


def _rel(a, ref):
    return float((a - ref).abs().max() / ref.abs().max())


def phase_kernel_bwd(model, X, device):
    """The backward kernel against autograd of the plain gram and against
    the written-out plain backward, every cotangent; then forward plus
    backward at Kuf in turns, and the backward alone against its plain
    version."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import KERNEL_CASES, prescaled_inputs

    with torch.no_grad():
        Z = model.Z.value
        Xd = torch.from_numpy(X).to(device)
        cases = [("Kuf", og._prep(model.kernel, Z, Xd) + (DEPTH,)),
                 ("Kuu", og._prep(model.kernel, Z, Z) + (DEPTH,))]
    cases += [(name, tuple(prescaled_inputs(seed, d, n, m, e, p, device)) + (p,))
              for seed, (name, d, n, m, e, p) in enumerate(KERNEL_CASES, start=3)]
    findings, kuf_abs_err = [], 0.0
    for k, (name, args) in enumerate(cases):
        *inputs, depth = args
        inputs = [t.detach().contiguous() for t in inputs]
        N_, M_ = inputs[0].shape[1], inputs[1].shape[1]
        gbar = torch.as_tensor(np.random.default_rng(100 + k).normal(size=(N_, M_)),
                               dtype=torch.float32, device=device)
        ours = og.oak_gram_bwd(*inputs, gbar, depth)
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        auto = torch.autograd.grad(og.oak_gram_plain(*leaves, depth), leaves, gbar,
                                   allow_unused=True, materialize_grads=True)
        plain = og.oak_gram_bwd_plain(*inputs, gbar, depth)
        errs = []
        for gname, o, a, p in zip(GRAD_NAMES, ours, auto, plain):
            if o.shape != a.shape or not bool(torch.isfinite(o).all()):
                raise RuntimeError(f"backward kernel {name} {gname}: shape "
                                   f"{tuple(o.shape)} or non-finite")
            if a.numel() == 0:
                continue
            e = max(_rel(o, a), _rel(o, p))
            errs.append(f"{gname} {e:.1e}")
            if not e < GRAD_TOL:
                raise RuntimeError(f"backward kernel {name} {gname}: error {e:.3e} "
                                   f">= {GRAD_TOL}")
            if name == "Kuf":
                kuf_abs_err = max(kuf_abs_err, float((o - a).abs().max()))
        findings.append(f"{name} [{', '.join(errs)}]")

    kuf, = [a for n, a in cases if n == "Kuf"]
    *inputs, _ = kuf
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    gbar = torch.as_tensor(np.random.default_rng(99).normal(size=(M, N)),
                           dtype=torch.float32, device=device)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*leaves, DEPTH), leaves, gbar,
                                           allow_unused=True)

    fns = {"plain": fwd_bwd(og.oak_gram_plain), "kernel": fwd_bwd(og.oak_gram_fused)}
    for fn in fns.values():  # warm-up
        fn()
    torch.cuda.synchronize()
    turns = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        turns[which].append(_cuda_ms(fns[which], TIMING_ITERS // 4))
    bwd = {"kernel": lambda: og.oak_gram_bwd(*inputs, gbar, DEPTH),
           "plain": lambda: og.oak_gram_bwd_plain(*inputs, gbar, DEPTH)}
    for fn in bwd.values():
        fn()
    bwd_turns = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        bwd_turns[which].append(_cuda_ms(bwd[which], TIMING_ITERS // 4))
    print(f"phase 2b backward kernel vs plain (max err / max |ref| against autograd "
          f"and the written-out backward, tol {GRAD_TOL}): {'; '.join(findings)}; "
          f"Kuf 512x8192 forward+backward: kernels {turns['kernel']} ms, plain "
          f"autograd {turns['plain']} ms; backward alone: kernel {bwd_turns['kernel']} "
          f"ms, oak_gram_bwd_plain {bwd_turns['plain']} ms (turns plain, kernel, "
          f"kernel, plain; {TIMING_ITERS // 4} calls each)")
    return dict(max_abs_err=kuf_abs_err, ms=float(np.mean(bwd_turns["kernel"])),
                plain_ms=float(np.mean(bwd_turns["plain"])))


def phase_main_path(model, X, device):
    from oak_tpu_torch.ops import oak_gram as og

    og.LAUNCHES = 0
    cold = serve(model, X, device)
    warm = serve(model, X, device)
    launches = og.LAUNCHES
    for b, _, mean, var in cold + warm:
        if mean.shape != (b, 1) or var.shape != (b, 1) or \
                not (np.isfinite(mean).all() and np.isfinite(var).all()):
            raise RuntimeError(f"request of {b} rows: bad shape or non-finite output")
    if launches == 0:
        raise RuntimeError("the predict path did not launch the CUDA kernel")

    model64 = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
    with torch.no_grad():
        mean64, var64 = (t.numpy() for t in model64.predict_y(torch.from_numpy(X).double()))
    _, _, mean, var = warm[-1]
    mean_err, var_err = rel_err(mean, mean64), rel_err(var, var64)
    if not (mean_err < E2E_TOL and var_err < E2E_TOL):
        raise RuntimeError(f"f32 card vs f64 CPU: mean {mean_err:.3e}, var "
                           f"{var_err:.3e} (tol {E2E_TOL})")
    times = ", ".join(f"{b}: {1e3 * tc:.3f} / {1e3 * tw:.3f} ms"
                      for (b, tc, _, _), (_, tw, _, _) in zip(cold, warm))
    print(f"phase 3 main path: predict_y requests (rows: first / second pass, "
          f"host clock incl. transfers) {times}; kernel launches {launches}; "
          f"8192 rows vs f64 CPU: mean {mean_err:.2e}, var {var_err:.2e} "
          f"(tol {E2E_TOL})")
    return launches


def _grad_at_start(model, X, Y):
    from oak_tpu_torch.optim import fit

    vec = fit._leaf(model)
    loss, g = fit.value_and_grad(model, lambda m: m.training_loss(X, Y), vec)
    return float(loss), g.double().cpu()


def _check_losses(name, losses, first_launch, first_bwd):
    from oak_tpu_torch.ops import oak_gram as og

    losses = losses.double().cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{name}: non-finite loss in {losses}")
    if not losses.min() < losses[0]:
        raise RuntimeError(f"{name}: best loss {losses.min()} not below the first {losses[0]}")
    if og.LAUNCHES == first_launch or og.BWD_LAUNCHES == first_bwd:
        raise RuntimeError(f"{name}: the forward or backward kernel was not launched")
    rises = int(np.sum(np.diff(losses) > 0))
    return (f"{name}: first loss {losses[0]:.6g}, best {losses.min():.6g}, last "
            f"{losses[-1]:.6g}, {rises} of {len(losses) - 1} steps raised it")


def phase_training(device):
    """The training path at full width: the gradient against float64, then
    fit_adam, the Bernoulli variant and natural gradients."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.optim import fit_adam, fit_natgrad_adam

    og.LAUNCHES = og.BWD_LAUNCHES = 0
    model, X, Y = build_bench_model(device)
    # 4.1: f32 through the kernels against f64 through the per-dim route, on
    # the card, each factoring Kuu at its dtype's default jitter (1e-5 and
    # 1e-6 relative to the mean diagonal)
    loss32, g32 = _grad_at_start(model, X, Y)
    if og.LAUNCHES == 0 or og.BWD_LAUNCHES == 0:
        raise RuntimeError("the training gradient did not launch both kernels")
    launches = (og.LAUNCHES, og.BWD_LAUNCHES)
    loss64, g64 = _grad_at_start(copy.deepcopy(model).to(dtype=torch.float64),
                                 X.double(), Y.double())
    if (og.LAUNCHES, og.BWD_LAUNCHES) != launches:
        raise RuntimeError("the float64 model reached the float32 kernels")
    loss_err = abs(loss32 - loss64) / abs(loss64)
    grad_err = float((g32 - g64).abs().max() / g64.abs().max())
    if not (np.isfinite(loss32) and loss_err < LOSS_TOL and grad_err < TRAIN_GRAD_TOL):
        raise RuntimeError(f"training gradient f32 vs f64: loss {loss_err:.3e} (tol "
                           f"{LOSS_TOL}), gradient {grad_err:.3e} (tol {TRAIN_GRAD_TOL})")
    print(f"phase 4.1 training gradient at the start point, f32 kernels vs f64 per-dim "
          f"route on the card: loss {loss32:.8g} vs {loss64:.8g}, rel err {loss_err:.2e} "
          f"(tol {LOSS_TOL}); gradient ({g32.numel()} entries) max err / max |g| "
          f"{grad_err:.2e} (tol {TRAIN_GRAD_TOL})")

    # 4.2: fit_adam, with the host clock read at every loss call (fit_adam
    # does not synchronise between steps, so an interval is one step's issue
    # time once the host is the bound)
    stamps = []

    def loss_fn(m):
        stamps.append(time.perf_counter())
        return m.training_loss(X, Y)

    first = (og.LAUNCHES, og.BWD_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_adam(model, loss_fn, steps=ADAM_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps_ms = 1e3 * np.diff(stamps[:ADAM_STEPS + 1])  # the last stamp is the final eval
    adam_line = _check_losses(f"fit_adam {ADAM_STEPS} steps", res.losses, *first)
    if not res.fun <= float(res.losses.min()):
        raise RuntimeError(f"fit_adam returned {res.fun}, above its best step loss")
    print(f"phase 4.2 {adam_line}, returned {res.fun:.6g}, loss at step {NATGRAD_STEPS} "
          f"{float(res.losses[NATGRAD_STEPS - 1]):.6g}; host ms per step (between "
          f"loss calls, no sync): median {np.median(steps_ms):.3f}, mean "
          f"{steps_ms.mean():.3f}, first {steps_ms[0]:.3f}, max {steps_ms.max():.3f}; "
          f"whole call {wall:.3f} s incl. the final evaluation and sync")

    # 4.3: the Bernoulli variant with Adam; natural gradients on a full q
    bmodel, bX, bY = build_bench_model(device, likelihood="bernoulli")
    first = (og.LAUNCHES, og.BWD_LAUNCHES)
    t0 = time.perf_counter()
    bres = fit_adam(bmodel, lambda m: m.training_loss(bX, bY), steps=BERNOULLI_STEPS)
    b_ms = 1e3 * (time.perf_counter() - t0) / BERNOULLI_STEPS
    b_line = _check_losses(f"Bernoulli fit_adam {BERNOULLI_STEPS} steps", bres.losses, *first)
    del bmodel
    nmodel, nX, nY = build_bench_model(device, q_diag=False)
    first = (og.LAUNCHES, og.BWD_LAUNCHES)
    t0 = time.perf_counter()
    nres = fit_natgrad_adam(nmodel, lambda m: m.training_loss(nX, nY),
                            steps=NATGRAD_STEPS, gamma=0.1)
    n_ms = 1e3 * (time.perf_counter() - t0) / NATGRAD_STEPS
    n_line = _check_losses(f"fit_natgrad_adam (gamma 0.1, full q) {NATGRAD_STEPS} steps",
                           nres.losses, *first)
    launches = {"fwd": og.LAUNCHES, "bwd": og.BWD_LAUNCHES}
    print(f"phase 4.3 {b_line} ({b_ms:.3f} ms per step incl. sync); {n_line} "
          f"({n_ms:.3f} ms per step incl. sync); training path launches: forward "
          f"{launches['fwd']}, backward {launches['bwd']}")
    return launches


def _host_ms(fn, repeats):
    """Median host-clock ms of fn() with the card synchronized on both ends."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def profile(model, X, device, rows=(1, 8192), repeats=7):
    """Where a warm predict_y request's time goes, rows already on the card:
    the host clock (median of ``repeats``) over the request and its parts,
    then torch.profiler over one request for its kernel launches and the
    device time. The profiler's tables go to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.ops.psd import safe_cholesky, solve_lower

    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    kern = model.kernel
    with torch.no_grad():
        Z = model.Z.value
        Kuu = kern.K(Z)
        Luu, jitter = safe_cholesky(Kuu)
        print(f"profile: safe_cholesky(Kuu) settles at jitter {jitter:g}; linalg "
              f"library {torch.backends.cuda.preferred_linalg_library()}")
        for b in rows:
            Xb = torch.from_numpy(X[:b]).to(device)
            Kus = kern.K(Z, Xb)
            parts = {"predict_y": lambda: model.predict_y(Xb),
                     "K(Z) (Kuu, fused)": lambda: kern.K(Z),
                     "K(Z, X) (Kus, fused)": lambda: kern.K(Z, Xb),
                     "_prep(Z, X)": lambda: og._prep(kern, Z, Xb),
                     "K_diag(X) (per-dim)": lambda: kern.K_diag(Xb),
                     "safe_cholesky(Kuu)": lambda: safe_cholesky(Kuu),
                     "solve_lower(Luu, Kus)": lambda: solve_lower(Luu, Kus)}
            for fn in parts.values():  # warm-up
                fn()
            ms = {name: _host_ms(fn, repeats) for name, fn in parts.items()}
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                model.predict_y(Xb)
                torch.cuda.synchronize()
            events = prof.key_averages()
            launches = sum(e.count for e in events
                           if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
            device_ms = sum(e.self_device_time_total for e in events
                            if e.device_type == DeviceType.CUDA) / 1e3
            table = events.table(sort_by="count", row_limit=60)
            (out_dir / f"profile_predict_{b}.txt").write_text(table)
            print(f"profile {b} rows (host ms, median of {repeats}): "
                  + ", ".join(f"{name} {t:.3f}" for name, t in ms.items())
                  + f"; profiled request: {launches} kernel launches, device time "
                  f"{device_ms:.3f} ms; table in chiprun_out/profile_predict_{b}.txt")


def profile_training(device, repeats=7):
    """Where a warm fit_adam step's time goes, on the bench model as
    bench.py builds it: the host clock (median of ``repeats``, synchronised)
    over the step and its parts, then torch.profiler over one step. The
    profiler's table goes to chiprun_out/profile_train_step.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from oak_tpu_torch import params as tp
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.optim import fit

    model, X, Y = build_bench_model(device)
    vec = fit._leaf(model)
    opt = fit.adam(vec)

    def loss_fn(m):
        return m.training_loss(X, Y)

    Z = model.Z.value.detach()
    kern = model.kernel
    kuf_leaves = [t.detach().requires_grad_(True) for t in og._prep(kern, Z, X)]
    g_kuf = torch.ones((M, N), device=device)
    parts = {
        "fit_adam step": lambda: fit._adam_step(model, loss_fn, vec, opt),
        "loss forward (graph built)": lambda: tp.call_with(
            model, tp.unflatten_trainable(model, vec.detach().requires_grad_(True)), loss_fn),
        "loss + gradient": lambda: fit.value_and_grad(model, loss_fn, vec),
        "_prep(Z, X) forward": lambda: og._prep(kern, Z, X),
        "Kuf gram forward+backward (kernels)": lambda: torch.autograd.grad(
            og.oak_gram_fused(*kuf_leaves, DEPTH), kuf_leaves, g_kuf, allow_unused=True),
        "K_diag(X) forward": lambda: kern.K_diag(X),
    }
    for fn in parts.values():  # warm-up
        fn()
    ms = {name: _host_ms(fn, repeats) for name, fn in parts.items()}
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fit._adam_step(model, loss_fn, vec, opt)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    ours = {e.key: e.self_device_time_total / 1e3 for e in events
            if e.device_type == DeviceType.CUDA and "oak_gram" in e.key}
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_train_step.txt").write_text(events.table(sort_by="count",
                                                                 row_limit=80))
    print(f"profile training step (host ms, median of {repeats}): "
          + ", ".join(f"{name} {t:.3f}" for name, t in ms.items())
          + f"; profiled step: {launches} kernel launches, device time {device_ms:.3f} ms, "
          + "of which " + ", ".join(f"{k.split('<')[0]} {v:.3f} ms" for k, v in ours.items())
          + "; table in chiprun_out/profile_train_step.txt")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="instead of phases 2-4, print where a warm predict_y "
                             "request's and a warm training step's time goes (host "
                             "clock and torch.profiler)")
    args = parser.parse_args()
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    model, X = build_model(device)
    if args.profile:
        profile(model, X, device)
        profile_training(device)
        return
    kernel = phase_kernel(model, X, device)
    kernel_bwd = phase_kernel_bwd(model, X, device)
    predict_launches = phase_main_path(model, X, device)
    train_launches = phase_training(device)
    print(json.dumps({"kernels": [
        {"name": "oak_gram_fwd_f32", "route": "cuda",
         "source": "oak_tpu_torch/csrc/oak_gram_fwd.cu",
         "replaces": "oak_tpu/ops/oak_gram_pallas.py:63",
         "launches": predict_launches + train_launches["fwd"],
         "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
         "plain_ms": kernel["plain_ms"]},
        {"name": "oak_gram_bwd_f32", "route": "cuda",
         "source": "oak_tpu_torch/csrc/oak_gram_bwd.cu",
         "replaces": "oak_tpu/ops/oak_gram_pallas.py:158",
         "launches": train_launches["bwd"],
         "max_abs_err": kernel_bwd["max_abs_err"], "ms": kernel_bwd["ms"],
         "plain_ms": kernel_bwd["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
