#!/usr/bin/env python3
"""Smoke run of the PyTorch port (oak_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of findings; any failure raises and exits
non-zero before the result line:

0. device: a CUDA card, its name and power limit from nvidia-smi, float32
   matmuls in full precision (no TF32);
1. build: compiles csrc/*.cu with nvcc into .kernel_build/ (ptxas registers
   and spills);
2. kernel: the fused OAK gram kernel against its plain torch version on the
   card, at the predict path's Kus and Kuu (from the model below), a ragged
   shape, every depth 1..8 and a mixed case with 2 extra grams; max error
   relative to max |plain| under 1e-4; both timed with CUDA events at Kus;
3. main path: the bench's SVGP (N = 8192, D = 32, M = 512, depth 3, q_diag,
   whitened, float32) on the card answers predict_y requests of 1, 100, 2048
   and 8192 rows; the outputs are finite, the kernel was launched, and the
   8192 request agrees with the same model in float64 on the CPU (the plain
   per-dim route) within 1e-3 relative to max magnitude.

Then one JSON line about the kernels, and as the last line
{"ok": true, "device": {...}}. Imports no JAX.

    python3 chip_smoke.py --profile

runs phases 0-1 and then, in place of the checks, the breakdown of a warm
predict_y request (PERF.md "Where the time goes"); it prints no result line.
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
E2E_TOL = 1e-3  # f32 on the card against f64 on the CPU, relative to max magnitude
BATCHES = (1, 100, 2048, 8192)
TIMING_ITERS = 20


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
            depth = re.search(r"ILi(\d+)E", m.group(1))
            entry = f"P={depth.group(1)}" if depth else m.group(1)
        elif "registers" in line or "spill" in line:
            ptxas.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    print(f"phase 1 build: {b.seconds:.2f} s -> {b.path.relative_to(REPO)}; "
          f"ptxas: {' | '.join(ptxas)}")


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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="instead of phases 2-3, print where a warm predict_y "
                             "request's time goes (host clock and torch.profiler)")
    args = parser.parse_args()
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    model, X = build_model(device)
    if args.profile:
        profile(model, X, device)
        return
    kernel = phase_kernel(model, X, device)
    launches = phase_main_path(model, X, device)
    print(json.dumps({"kernels": [{
        "name": "oak_gram_fwd_f32", "route": "cuda",
        "source": "oak_tpu_torch/csrc/oak_gram_fwd.cu",
        "replaces": "oak_tpu/ops/oak_gram_pallas.py:63",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
