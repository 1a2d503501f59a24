#!/usr/bin/env python3
"""Smoke run of the PyTorch port (oak_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of findings; any failure raises and exits
non-zero before the result line:

0. device: a CUDA card, its name and power limit from nvidia-smi, float32
   matmuls in full precision (no TF32);
1. build: compiles csrc/*.cu with nvcc into .kernel_build/ (ptxas registers
   of every kernel variant, and any spills);
2. K1: the fused OAK gram forward kernel against its plain torch version on
   the card at the predict path's Kus and Kuu (from the model below), the
   GPR's square gram K(X) (8192 x 8192, D = 8, depth 2, X2 = None; exactly
   symmetric), a ragged shape, a mixed case with 2 extra grams, every depth
   1..8, the deep variants (depths 9, 12, 16, 32 at D = 32; 60 at D = 60)
   and a depth clamped to its number of grams; max error relative to max
   |plain| under 1e-4, or, where the f32 plain version drifts, within twice
   its error against f64 (oak_tpu_torch.testing.kernel_error); at Kus, Kuu
   and the square: device time from torch.profiler, CUDA-event times of
   kernel and plain in turns, the bound and the share (with --old, the
   earlier tree's kernel in turns old, new, new, old);
2b. K2: every cotangent against autograd of the plain gram and against the
   written-out plain backward, for a seeded gbar, at the training path's
   Kuf and Kuu, the square gram and the same cases, under 1e-3 or the same
   drift rule; a repeat launch bitwise equal; then timed as in phase 2, and
   forward plus backward against plain autograd in turns;
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
   below its first, and both kernels were launched;
5. Sobol: the full decomposition (5,488 components) of phase 4's trained
   SVGP in float32 against the same parameters in float64 on the card
   (normalised values within 1e-3), and its time; the
   per-order totals against the components' sums (1e-3 relative); the
   per-component predictions of 1024 rows plus the constant against
   predict_f's mean (1e-3 of max |mean|);
6. SGPR at the bench's width (N = 8192, D = 32, M = 512, depth 3, noise
   0.01): loss and gradient against float64 on the card under phase 4's
   gates, 20 fit_adam steps, predict_y of 8192 rows against float64 (1e-3),
   Sobol and the sum-to-mean identity as in phase 5; both kernels launched;
7. GPR as bench.py's --gpr-scale rows build it (N = 8192, D = 8, depth 2,
   noise 0.1): loss and gradient against float64 under phase 4's gates, 10
   fit_adam steps, predict_y of 1024 rows against float64 (1e-3), Sobol as
   in phase 5, 16 posterior draws at 256 rows; K1 launched at the square
   gram K(X) and K2 in training;
8. defaults and depth: a kernel and an SVGP built with no dtype or device
   are float32 on the card and launch K1 and K2; depth 9 over 10 dims and
   32 over 32 run through both kernels and agree with the per-dim route;
9. the oak_model user path at the UCI pumadyn configuration's full width
   (examples/uci/outputs/pumadyn/config.json: depth 8, M = 500, flows, the
   sparsity prior, L-BFGS; float32, built with no dtype or device) on fold
   0 of the synthetic stand-in (6553 training rows, 1639 test rows): fit
   (flows and k-means timed), optimise(max_iters=40, restarts=2) (each lane
   300 Adam steps, then L-BFGS; a lane finite and the loss below the
   start's), predict with clipping, NLL and RMSE (below std(y)); a save
   loaded in float64 on the card, factoring at float32's jitter, agrees at
   matched parameters (the B1 gate: NLL and the 255 normalised Sobol values
   within 1e-3; predictions within 1e-3 or, where the same float32 model on
   the per-dim route is further off, within twice its error); the
   per-component predictions plus the
   constant against the mean, within the UCI regression script's float32
   budget 1e-2 + 2e-2 |mean| per point; a float32 save loads back to
   bitwise-equal predictions; K1
   and K2 launched on the path, then both held against their plain versions
   and timed at its Kuf shape (500 x 6553, D 8, depth 8).

Each phase prints its seconds. Then one JSON line about the kernels, and as
the last line {"ok": true, "device": {...}}. Imports no JAX.

    python3 chip_smoke.py --old DIR

also builds the kernels of an earlier tree from DIR and times them in turns
with these in phases 2 and 2b.

    python3 chip_smoke.py --profile

runs phases 0-1 and then, in place of the checks, the breakdown of a warm
predict_y request, of a warm training step and of a full Sobol decomposition
(PERF.md "Where the time goes"); it prints no result line.
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
GPR_N, GPR_D, GPR_DEPTH = 8192, 8, 2  # bench.py --gpr-scale (its second row)
SOBOL_TOL = 1e-3  # the B1 gate: normalised Sobol values, f32 against f64
SGPR_STEPS, GPR_STEPS = 20, 10
COMPONENT_ROWS, SAMPLE_ROWS, SAMPLE_DRAWS = 1024, 256, 16
# examples/uci/outputs/pumadyn/config.json at full width, on the stand-in
# data's 8192 rows; 40 L-BFGS iterations after each lane's 300 Adam steps
PUMA_N, PUMA_D, PUMA_DEPTH, PUMA_M = 8192, 8, 8, 500
PUMA_ITERS, PUMA_RESTARTS = 40, 2


def synth_pumadyn(n=8192, d=32, seed=0):
    """The bench's synthetic pumadyn-shaped data (bench.py)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d) / np.sqrt(d)
    y = np.tanh(X @ w) + 0.5 * X[:, 0] * X[:, 1] + 0.1 * rng.normal(size=n)
    return X.astype(np.float32), y.reshape(-1, 1).astype(np.float32)


def bench_kernel(device, dtype, d, depth):
    """The bench's OAK kernel: create defaults, sparsity prior, lengthscale
    bounds [1e-3, 1e3]."""
    from oak_tpu_torch.kernels import OAKKernel

    return OAKKernel.create(num_dims=d, max_interaction_depth=depth,
                            use_sparsity_prior=True, lengthscale_bounds=[1e-3, 1e3],
                            dtype=dtype, device=device)


def build_model(device, dtype=torch.float32):
    """The bench's SVGP with parameters drawn from a seed (an untrained model
    predicts 0): lengthscales U(1, 3), order variances (1, 0.5, 0.2, 0.05),
    q_mu N(0, 1), q_sqrt U(0.1, 0.5)."""
    from oak_tpu_torch.models import SVGP, Gaussian

    X, _ = synth_pumadyn(N, D)
    Z = X[np.random.default_rng(1).choice(N, M, replace=False)]
    kernel = bench_kernel(device, dtype, D, DEPTH)
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
    kernel = bench_kernel(device, dtype, D, DEPTH)
    model = SVGP.create(kernel, lik, Z, num_data=N, q_diag=q_diag, dtype=dtype,
                        device=device)
    return (model, torch.as_tensor(X, dtype=dtype, device=device),
            torch.as_tensor(Y, dtype=dtype, device=device))


def build_sgpr_model(device, dtype=torch.float32):
    """The bench's data and inducing points (seeds 0 and 1) in an SGPR:
    create defaults, sparsity prior, lengthscale bounds [1e-3, 1e3], noise
    0.01."""
    from oak_tpu_torch.models import SGPR

    X, Y = synth_pumadyn(N, D)
    Z = X[np.random.default_rng(1).choice(N, M, replace=False)]
    kernel = bench_kernel(device, dtype, D, DEPTH)
    return SGPR.create(X, Y, kernel, Z, noise_variance=0.01, dtype=dtype, device=device)


def build_gpr_model(device, n=None, dtype=torch.float32):
    """The exact GP of bench.py::run_gpr_scale: synth_pumadyn(n, 8) (n
    defaults to GPR_N), create defaults, sparsity prior, lengthscale bounds
    [1e-3, 1e3], noise 0.1."""
    from oak_tpu_torch.models import GPR

    X, Y = synth_pumadyn(GPR_N if n is None else n, GPR_D)
    kernel = bench_kernel(device, dtype, GPR_D, GPR_DEPTH)
    return GPR.create(X, Y, kernel, noise_variance=0.1, dtype=dtype, device=device)


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
    regs, spills, entry = [], [], "?"
    for line in b.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"oak_gram_(fwd|bwd)_kernelILi(\d+)ELi(\d+)ELi(\d+)E", m.group(1))
            entry = (f"{k.group(1)} P={k.group(2)} {k.group(3)}x{k.group(4)}" if k
                     else re.sub(r".*(oak_gram_\w+?)[A-Z]?\d*P.*", r"\1", m.group(1)))
        elif "registers" in line:
            regs.append(f"{entry} {re.search(r'Used (\d+) registers', line).group(1)}")
        elif "spill" in line and " 0 bytes spill stores" not in line:
            spills.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    print(f"phase 1 build: {b.seconds:.2f} s -> {b.path.relative_to(REPO)}; ptxas registers: "
          f"{', '.join(regs)}; spills: {' | '.join(spills) or 'none'}")
    return b.seconds


# Peak rates of one H100 SXM at its 1.98 GHz boost clock (NVIDIA's data
# sheet; compute capability 9.0 runs 128 FP32 lanes and 16 ex2 per SM a
# clock): FP32 lanes (an FFMA counts once), MUFU ex2, HBM bytes.
PEAK_FP32, PEAK_EX2, PEAK_BYTES = 132 * 128 * 1.98e9, 132 * 16 * 1.98e9, 3.35e12


def gram_bound(kind, D, N, M, E, depth):
    """(ms, bound_by, detail): the least time the card could take for the
    work of kernel ``kind`` ("K1" or "K2") on these shapes, the larger of its bytes (each input read
    once, each output written once) over HBM's rate and its operations over
    their type's peak. Counts per (element, dim), at the clamped depth P:
    the forward one ex2 and 3 + P FP32 (du, the exponent, g, P orders), plus
    P per output for the sum over orders; the backward two ex2 and (3 + P) +
    (8 + P) FP32 (csrc/oak_gram_bwd.cu), plus P (P + 1) / 2 + P + 1 per
    element for dsig2 and T's coefficients. Extra grams count P FP32 each
    (and P - 1 more in the backward)."""
    from oak_tpu_torch.ops import oak_gram as og

    P, nm = og.clamped_depth(depth, D, E), N * M
    if kind == "K1":
        fp32, ex2 = nm * (D * (3 + P) + E * P + P), nm * D
        nbytes = 4 * (2 * D * (N + M) + D + P + 1 + E * nm + nm)
    else:
        fp32 = nm * (D * (11 + 2 * P) + E * (2 * P - 1) + P * (P + 1) // 2 + P + 1)
        ex2 = 2 * nm * D
        nbytes = 4 * (4 * D * (N + M) + 2 * D + 2 * (P + 1) + 2 * E * nm + nm)
    t = {"bytes": nbytes / PEAK_BYTES, "FP32": fp32 / PEAK_FP32, "ex2": ex2 / PEAK_EX2}
    top = max(t, key=t.get)
    detail = (f"{fp32 / 1e6:.0f} M FP32 {1e6 * t['FP32']:.1f} us, {ex2 / 1e6:.0f} M ex2 "
              f"{1e6 * t['ex2']:.1f} us, {nbytes / 1e6:.1f} MB {1e6 * t['bytes']:.1f} us")
    return 1e3 * t[top], "bytes" if top == "bytes" else "operations", f"{top}: {detail}"


def _device_ms(fn, iters=10, rounds=3):
    """Device time per call of the CUDA kernels fn launches, from
    torch.profiler's kernel durations (no host time in it): per profiled
    round, each kernel's mean duration times its launches per call, summed;
    the median over ``rounds`` rounds that recorded kernels. A round can
    miss every event and read 0, so such rounds are run again, up to
    3·``rounds`` rounds in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    fn()
    torch.cuda.synchronize()
    per_round = []
    for _ in range(3 * rounds):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total / e.count * max(1, round(e.count / iters))
                    for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.count)
        if total > 0:
            per_round.append(total)
        if len(per_round) == rounds:
            break
    if not per_round:
        raise RuntimeError(f"torch.profiler recorded no kernel in {3 * rounds} rounds")
    return float(np.median(per_round)) / 1e3


def _old_kernels(old_dir):
    """The fused gram kernels of an earlier tree (their C interface before
    the redesign: K1 without a tile variant, K2 writing 32 x 64 tile
    partials that torch sums), built from ``old_dir`` with the same flags,
    as (forward, backward) callables on prescaled inputs."""
    import ctypes

    from oak_tpu_torch import _build

    out = REPO / ".kernel_build" / "old" / "liboak_kernels_old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(out),
                    *map(str, sorted(Path(old_dir).glob("*.cu")))],
                   check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.oak_gram_fwd_f32.argtypes = [ptr] * 8 + [num] * 5 + [ptr]
    lib.oak_gram_bwd_f32.argtypes = [ptr] * 15 + [num] * 5 + [ptr]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def fwd(u1, u2, c1, c2, extra, logb, sig2, depth):
        out = torch.empty((u1.shape[1], u2.shape[1]), device=u1.device)
        rc = lib.oak_gram_fwd_f32(*(t.data_ptr() for t in (u1, u2, c1, c2, extra, logb,
                                                             sig2, out)),
                                  u1.shape[0], u1.shape[1], u2.shape[1], extra.shape[0],
                                  depth, stream())
        if rc != 0:
            raise RuntimeError(f"the earlier oak_gram_fwd_f32 failed with cudaError {rc}")
        return out

    def bwd(u1, u2, c1, c2, extra, logb, sig2, gbar, depth):
        (D, N), M = u1.shape, u2.shape[1]
        bn, bm = -(-N // 32), -(-M // 64)
        kw = dict(device=u1.device)
        parts = [torch.empty((bm, D, N), **kw), torch.empty((bm, D, N), **kw),
                 torch.empty((bn, D, M), **kw), torch.empty((bn, D, M), **kw),
                 torch.empty((bn * bm, D), **kw), torch.empty((bn * bm, depth + 1), **kw)]
        rc = lib.oak_gram_bwd_f32(*(t.data_ptr() for t in (u1, u2, c1, c2, extra, logb,
                                                             sig2, gbar, *parts)),
                                  None, D, N, M, extra.shape[0], depth, stream())
        if rc != 0:
            raise RuntimeError(f"the earlier oak_gram_bwd_f32 failed with cudaError {rc}")
        du1, dc1, du2, dc2, dlogb, dsig2 = (t.sum(0) for t in parts)
        return du1, du2, dc1, dc2, None, dlogb, dsig2

    return fwd, bwd


def _timing_cases(model, X, gpr, device):
    """The main path's three gram shapes, prescaled: the SVGP's Kus / Kuf
    (M x N), Kuu (M x M) and the GPR's square K(X) (X2 = None)."""
    from oak_tpu_torch.ops import oak_gram as og

    Z = model.Z.value
    Xd = torch.from_numpy(X).to(device)
    return {"Kus/Kuf 512x8192": og._prep(model.kernel, Z, Xd) + (DEPTH,),
            "Kuu 512x512": og._prep(model.kernel, Z, Z) + (DEPTH,),
            "GPR K(X) 8192x8192": og._prep(gpr.kernel, gpr.X, gpr.X) + (GPR_DEPTH,)}


def _check_cases(model, X, gpr, device):
    """Every shape the kernels are held to: the main path's three, then the
    shared cases of oak_tpu_torch.testing (ragged, mixed, depths 1..8, the
    deep variants 9..32), D = 60 at depth 60 (sonar at full depth) and a
    depth clamped to its number of grams."""
    from oak_tpu_torch.testing import KERNEL_CASES, prescaled_inputs

    cases = list(_timing_cases(model, X, gpr, device).items())
    extra = KERNEL_CASES + [("D=60 P=60", 60, 300, 200, 0, 60),
                            ("D=6 E=1 P=9 clamped", 6, 100, 70, 1, 9)]
    return cases + [(name, tuple(prescaled_inputs(seed, d, n, m, e, p, device)) + (p,))
                    for seed, (name, d, n, m, e, p) in enumerate(extra, start=3)]


def _shape(args):
    u1, u2, extra = args[0], args[1], args[4]
    return u1.shape[0], u1.shape[1], u2.shape[1], extra.shape[0], args[-1]


def _turns(fns, measure):
    """measure(fn) of each fn in turns a, b, b, a (a, b the first two keys of
    fns), after one warm-up call each."""
    a, b = list(fns)[:2]
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    turns = {a: [], b: []}
    for which in (a, b, b, a):
        turns[which].append(measure(fns[which]))
    return turns


def _table_row(name, kind, args, new_dev, old_dev, ev, plain_ev):
    D, N, M, E, depth = _shape(args)
    bound, by, detail = gram_bound(kind, D, N, M, E, depth)
    share = bound / float(np.mean(new_dev))
    old = "not measured" if old_dev is None else f"{old_dev} ms"
    return (f"  {kind} {name}: device {new_dev} ms (before redesign {old}); CUDA events "
            f"{ev:.4f} ms, plain {plain_ev:.4f} ms; bound {bound:.4f} ms ({detail}); share "
            f"{share:.2f}"), dict(device_ms=float(np.mean(new_dev)), bound_ms=bound,
                                  bound_by=by, share=share, event_ms=ev, plain_ms=plain_ev,
                                  old_device_ms=None if old_dev is None
                                  else float(np.mean(old_dev)))


def phase_kernel(model, X, gpr, device, old):
    """K1 against the plain version (f32 and f64) at every case; the square
    gram exactly symmetric; then, at the main path's three shapes, device
    time (profiler) in turns with the earlier tree's kernel (old, new, new,
    old) when ``old`` is given, CUDA-event times of kernel and plain, the
    bound and the share."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import kernel_error

    with torch.no_grad():
        findings, abs_err = [], {}
        for name, args in _check_cases(model, X, gpr, device):
            out = og.oak_gram_fused(*args)
            torch.cuda.synchronize()
            ref = og.oak_gram_plain(*args)
            ref64 = og.oak_gram_plain(*[a.double() for a in args[:-1]], args[-1])
            if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                raise RuntimeError(f"kernel {name}: shape {tuple(out.shape)} or non-finite")
            if name.startswith("GPR") and not torch.equal(out, out.T):
                raise RuntimeError("kernel GPR K(X): the square gram is not symmetric")
            ok, _, text = kernel_error(out, ref, ref64, KERNEL_TOL)
            findings.append(f"{name} {text}")
            abs_err[name] = float((out - ref).abs().max())
            if not ok:
                raise RuntimeError(f"kernel {name}: error {text} over tol {KERNEL_TOL}")
            del out, ref, ref64

        rows, numbers = [], {}
        for name, args in _timing_cases(model, X, gpr, device).items():
            iters = TIMING_ITERS if name.startswith("K") else TIMING_ITERS // 4
            new = lambda a=args: og.oak_gram_fused(*a)  # noqa: E731
            if old:
                both = _turns({"old": lambda a=args: old[0](*a), "new": new}, _device_ms)
                dev, old_dev = both["new"], both["old"]
            else:
                dev, old_dev = [_device_ms(new) for _ in range(2)], None
            ev = _turns({"plain": lambda a=args: og.oak_gram_plain(*a), "kernel": new},
                        lambda fn: _cuda_ms(fn, iters))
            text, nums = _table_row(name, "K1", args, dev, old_dev,
                                    float(np.mean(ev["kernel"])), float(np.mean(ev["plain"])))
            rows.append(text)
            numbers[name] = nums | dict(max_abs_err=abs_err[name])
    print(f"phase 2 K1 vs plain (max err / max |plain|, tol {KERNEL_TOL}; past it, the "
          f"drift rule of oak_tpu_torch.testing.kernel_error against f64): "
          f"{', '.join(findings)}; GPR K(X) exactly symmetric; device ms from "
          f"torch.profiler (turns old, new, new, old where the earlier kernel is given), "
          f"CUDA events over {TIMING_ITERS} launches (5 at the square) in turns plain, "
          f"kernel, kernel, plain:\n" + "\n".join(rows))
    return numbers


def phase_kernel_bwd(model, X, gpr, device, old):
    """K2 against autograd of the plain gram and against the written-out
    plain backward (f32, and f64 for the drift rule), every cotangent, at
    every case; a repeat launch bitwise equal; then device time, events,
    bound and share at the main path's three shapes as in phase 2, and
    forward plus backward against plain autograd."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import kernel_error

    findings, abs_err = [], {}
    for k, (name, args) in enumerate(_check_cases(model, X, gpr, device)):
        *inputs, depth = args
        inputs = [t.detach().contiguous() for t in inputs]
        N_, M_ = inputs[0].shape[1], inputs[1].shape[1]
        gbar = torch.as_tensor(np.random.default_rng(100 + k).normal(size=(N_, M_)),
                               dtype=torch.float32, device=device)
        ours = og.oak_gram_bwd(*inputs, gbar, depth)
        again = og.oak_gram_bwd(*inputs, gbar, depth)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(ours, again)):
            raise RuntimeError(f"backward kernel {name}: a repeat launch differs")
        del again
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        auto = torch.autograd.grad(og.oak_gram_plain(*leaves, depth), leaves, gbar,
                                   allow_unused=True, materialize_grads=True)
        plain = og.oak_gram_bwd_plain(*inputs, gbar, depth)
        plain64 = og.oak_gram_bwd_plain(*[t.double() for t in inputs], gbar.double(), depth)
        errs = []
        for gname, o, a, p, p64 in zip(GRAD_NAMES, ours, auto, plain, plain64):
            if o.shape != a.shape or not bool(torch.isfinite(o).all()):
                raise RuntimeError(f"backward kernel {name} {gname}: shape "
                                   f"{tuple(o.shape)} or non-finite")
            if a.numel() == 0:
                continue
            results = [kernel_error(o, ref, p64, GRAD_TOL) for ref in (a, p)]
            errs.append(f"{gname} {max(results, key=lambda r: r[1])[2]}")
            if not all(ok for ok, _, _ in results):
                raise RuntimeError(f"backward kernel {name} {gname}: {errs[-1]} over tol "
                                   f"{GRAD_TOL}")
            abs_err[name] = max(abs_err.get(name, 0.0), float((o - a).abs().max()))
        findings.append(f"{name} [{', '.join(errs)}]")
        del ours, auto, plain, plain64

    rows, numbers, both_text = [], {}, []
    for name, args in _timing_cases(model, X, gpr, device).items():
        *inputs, depth = [a.detach() if isinstance(a, torch.Tensor) else a for a in args]
        gbar = torch.as_tensor(np.random.default_rng(99).normal(
            size=(inputs[0].shape[1], inputs[1].shape[1])), dtype=torch.float32,
            device=device)
        iters = TIMING_ITERS if name.startswith("K") else TIMING_ITERS // 4
        new = lambda i=inputs, g=gbar, d=depth: og.oak_gram_bwd(*i, g, d)  # noqa: E731
        if old:
            both = _turns({"old": lambda i=inputs, g=gbar, d=depth: old[1](*i, g, d),
                           "new": new}, _device_ms)
            dev, old_dev = both["new"], both["old"]
        else:
            dev, old_dev = [_device_ms(new) for _ in range(2)], None
        ev = _turns({"plain": lambda i=inputs, g=gbar, d=depth: og.oak_gram_bwd_plain(
            *i, g, d), "kernel": new}, lambda fn: _cuda_ms(fn, iters))
        text, nums = _table_row(name, "K2", args, dev, old_dev,
                                float(np.mean(ev["kernel"])), float(np.mean(ev["plain"])))
        rows.append(text)
        numbers[name] = nums | dict(max_abs_err=abs_err[name])
        if not name.startswith("Kuu"):
            leaves = [t.clone().requires_grad_(True) for t in inputs]

            def fwd_bwd(fn, leaves=leaves, gbar=gbar, depth=depth):
                return lambda: torch.autograd.grad(fn(*leaves, depth), leaves, gbar,
                                                   allow_unused=True)

            fb = _turns({"plain": fwd_bwd(og.oak_gram_plain),
                         "kernel": fwd_bwd(og.oak_gram_fused)},
                        lambda fn: _cuda_ms(fn, TIMING_ITERS // 4))
            both_text.append(f"{name} forward+backward: kernels {fb['kernel']} ms, plain "
                             f"autograd {fb['plain']} ms")
    print(f"phase 2b K2 vs plain (max err / max |ref| against autograd and the written-out "
          f"backward, tol {GRAD_TOL}; past it the drift rule against f64; a repeat launch "
          f"bitwise equal at every case): {'; '.join(findings)}; {'; '.join(both_text)} "
          f"(CUDA events, turns plain, kernel, kernel, plain); device ms, events and bounds "
          f"as in phase 2:\n" + "\n".join(rows))
    return numbers


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


def _grad_at_start(model, loss_fn):
    from oak_tpu_torch.optim import fit

    vec = fit._leaf(model)
    loss, g = fit.value_and_grad(model, loss_fn, vec)
    return float(loss), g.double().cpu()


def _check_grad_against_f64(name, model, loss_fn, to64=None):
    """The loss and its gradient at the start point, f32 through the kernels
    against the same model in f64 on the card (the per-dim route, which must
    launch neither kernel), each factoring at its dtype's default jitter.
    ``to64`` maps the loss function's arguments to f64."""
    from oak_tpu_torch.ops import oak_gram as og

    before = (og.LAUNCHES, og.BWD_LAUNCHES)
    loss32, g32 = _grad_at_start(model, loss_fn)
    if og.LAUNCHES == before[0] or og.BWD_LAUNCHES == before[1]:
        raise RuntimeError(f"{name}: the training gradient did not launch both kernels")
    launches = (og.LAUNCHES, og.BWD_LAUNCHES)
    loss64, g64 = _grad_at_start(copy.deepcopy(model).to(dtype=torch.float64),
                                 to64 or loss_fn)
    if (og.LAUNCHES, og.BWD_LAUNCHES) != launches:
        raise RuntimeError(f"{name}: the float64 model reached the float32 kernels")
    loss_err = abs(loss32 - loss64) / abs(loss64)
    grad_err = float((g32 - g64).abs().max() / g64.abs().max())
    if not (np.isfinite(loss32) and loss_err < LOSS_TOL and grad_err < TRAIN_GRAD_TOL):
        raise RuntimeError(f"{name} gradient f32 vs f64: loss {loss_err:.3e} (tol "
                           f"{LOSS_TOL}), gradient {grad_err:.3e} (tol {TRAIN_GRAD_TOL})")
    return (f"loss {loss32:.8g} vs {loss64:.8g}, rel err {loss_err:.2e} (tol {LOSS_TOL}); "
            f"gradient ({g32.numel()} entries) max err / max |g| {grad_err:.2e} "
            f"(tol {TRAIN_GRAD_TOL})")


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
    line = _check_grad_against_f64("SVGP", model, lambda m: m.training_loss(X, Y),
                                   lambda m: m.training_loss(X.double(), Y.double()))
    print(f"phase 4.1 training gradient at the start point, f32 kernels vs f64 per-dim "
          f"route on the card: {line}")

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
          f"whole call {wall:.3f} s incl. the final evaluation and sync; launches over "
          f"the steps and the final evaluation: K1 {og.LAUNCHES - first[0]}, K2 "
          f"{og.BWD_LAUNCHES - first[1]}")

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
    return launches, model, X


def _check_sobol(name, model, model64, X=None, by_order=False):
    """Full Sobol of ``model`` (f32) against ``model64`` (the same parameters
    in f64); with ``by_order``, the per-order totals (Newton–Girard over the
    L matrices, the Hadamard form's conditioning) against the components'
    sums; with ``X``, the per-component predictions of its rows plus the
    constant against predict_f's mean. Returns a findings line."""
    from oak_tpu_torch import sobol as sb

    tuples, v32 = sb.compute_sobol_oak(model)
    tuples64, v64 = sb.compute_sobol_oak(model64)
    if tuples != tuples64 or not np.isfinite(v32).all():
        raise RuntimeError(f"{name} Sobol: components differ or values non-finite")
    err = float(np.abs(sb.normalize_sobol(v32) - sb.normalize_sobol(v64)).max())
    if not err < SOBOL_TOL:
        raise RuntimeError(f"{name} Sobol f32 vs f64: normalised error {err:.3e} "
                           f">= {SOBOL_TOL}")
    line = (f"{len(tuples)} components, max |normalised f32 - f64| {err:.2e} (tol "
            f"{SOBOL_TOL})")
    if by_order:
        totals = sb.compute_sobol_by_order(model)
        sums = np.zeros(len(totals))
        for t, v in zip(tuples, v32):
            sums[len(t) - 1] += v
        order_err = float(np.abs(totals - sums).max() / np.abs(sums).max())
        if not order_err < SOBOL_TOL:
            raise RuntimeError(f"{name} Sobol by order vs component sums: {order_err:.3e}")
        line += f"; by order vs sums {order_err:.2e}"
    if X is not None:
        comps = sb.get_prediction_component(model, X=X)
        with torch.no_grad():
            const = float(model.posterior_alpha()[:, 0].sum()
                          * model.kernel.variances[0].value)
            mean = model.predict_f(X)[0][:, 0].cpu().numpy().astype(np.float64)
        ident = float(np.abs(comps.sum(0) + const - mean).max() / np.abs(mean).max())
        if not (comps.shape == (len(tuples), X.shape[0]) and ident < SOBOL_TOL):
            raise RuntimeError(f"{name} per-component predictions: shape "
                               f"{comps.shape}, sum-to-mean error {ident:.3e}")
        line += f"; {X.shape[0]} rows' components + constant vs mean {ident:.2e}"
    return line


def phase_sobol(model, X):
    """Phase 4's trained SVGP: the full decomposition against f64, and
    timed."""
    from oak_tpu_torch import sobol as sb
    from oak_tpu_torch.ops import oak_gram as og

    og.LAUNCHES = 0
    model64 = copy.deepcopy(model).to(dtype=torch.float64)
    line = _check_sobol("SVGP", model, model64, X[:COMPONENT_ROWS], by_order=True)
    sobol_ms = _host_ms(lambda: sb.compute_sobol_oak(model), 3)
    launches = og.LAUNCHES
    if launches == 0:
        raise RuntimeError("Sobol did not launch the forward kernel")
    print(f"phase 5 Sobol of the trained bench SVGP: {line}; full Sobol host ms "
          f"(sync, median of 3) {sobol_ms:.3f}; forward launches {launches}")
    return launches


def _fit_and_compare(name, model, steps, rows, Xnew):
    """fit_adam for ``steps`` steps (best below first, both kernels
    launched), then predict_y on ``rows`` rows and Sobol against the trained
    parameters in f64."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.optim import fit_adam

    first = (og.LAUNCHES, og.BWD_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fit_adam(model, lambda m: m.training_loss(), steps=steps)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps
    fit_line = _check_losses(f"{name} fit_adam {steps} steps", res.losses, *first)
    model64 = copy.deepcopy(model).to(dtype=torch.float64)
    with torch.no_grad():
        mean, var = (t.cpu().numpy() for t in model.predict_y(Xnew[:rows]))
        mean64, var64 = (t.cpu().numpy() for t in model64.predict_y(Xnew[:rows].double()))
    mean_err, var_err = rel_err(mean, mean64), rel_err(var, var64)
    if not (np.isfinite(mean).all() and mean_err < E2E_TOL and var_err < E2E_TOL):
        raise RuntimeError(f"{name} predict_y f32 vs f64: mean {mean_err:.3e}, var "
                           f"{var_err:.3e} (tol {E2E_TOL})")
    return (model64, f"{fit_line} ({step_ms:.3f} ms per step incl. sync); predict_y "
            f"{rows} rows vs f64: mean {mean_err:.2e}, var {var_err:.2e} (tol {E2E_TOL})")


def phase_sgpr(device):
    from oak_tpu_torch.ops import oak_gram as og

    og.LAUNCHES = og.BWD_LAUNCHES = 0
    model = build_sgpr_model(device)
    grad_line = _check_grad_against_f64("SGPR", model, lambda m: m.training_loss())
    model64, fit_line = _fit_and_compare("SGPR", model, SGPR_STEPS, N, model.X)
    sobol_line = _check_sobol("SGPR", model, model64, model.X[:COMPONENT_ROWS])
    launches = {"fwd": og.LAUNCHES, "bwd": og.BWD_LAUNCHES}
    print(f"phase 6 SGPR (N {N}, D {D}, M {M}, depth {DEPTH}, f32): gradient at the "
          f"start vs f64 on the card: {grad_line}; {fit_line}; Sobol: {sobol_line}; "
          f"launches: forward {launches['fwd']}, backward {launches['bwd']}")
    return launches


def phase_gpr(device):
    from oak_tpu_torch.ops import oak_gram as og

    og.LAUNCHES = og.BWD_LAUNCHES = 0
    model = build_gpr_model(device)
    with torch.no_grad():
        model.kernel.K(model.X)  # K(X), X2 = None
    torch.cuda.synchronize()
    if og.LAUNCHES != 1:
        raise RuntimeError("GPR: the square gram K(X) did not launch the kernel once")
    grad_line = _check_grad_against_f64("GPR", model, lambda m: m.training_loss())
    Xnew = torch.as_tensor(synth_pumadyn(GPR_N, GPR_D, seed=3)[0], device=device)
    model64, fit_line = _fit_and_compare("GPR", model, GPR_STEPS, COMPONENT_ROWS, Xnew)
    sobol_line = _check_sobol("GPR", model, model64)
    with torch.no_grad():
        draws = model.predict_f_samples(Xnew[:SAMPLE_ROWS], SAMPLE_DRAWS, 0)
    if draws.shape != (SAMPLE_DRAWS, SAMPLE_ROWS, 1) or not bool(torch.isfinite(draws).all()):
        raise RuntimeError(f"GPR samples: shape {tuple(draws.shape)} or non-finite")
    launches = {"fwd": og.LAUNCHES, "bwd": og.BWD_LAUNCHES}
    print(f"phase 7 GPR (N {GPR_N}, D {GPR_D}, depth {GPR_DEPTH}, noise 0.1, f32): "
          f"gradient at the start vs f64 on the card: {grad_line}; {fit_line}; Sobol: "
          f"{sobol_line}; {SAMPLE_DRAWS} draws at {SAMPLE_ROWS} rows finite; launches: "
          f"forward {launches['fwd']} (the square K(X) among them), backward "
          f"{launches['bwd']}")
    return launches


def _per_dim_K(k, X, X2=None):
    """OAKKernel.K's per-dim route, whatever the dtype and device."""
    from oak_tpu_torch.ops.newton_girard import newton_girard

    return k._combine(newton_girard(k.dim_grams(X, X2), k.max_interaction_depth))


def phase_defaults(device):
    """The entry points' defaults: a kernel and an SVGP built with no dtype
    or device are float32 on the card, and K and the training gradient
    launch K1 and K2. Then models deeper than 8 (depth 9 over 10 dims, 32
    over 32, create defaults: every order's variance 1) through the kernels:
    K and its gradient against the per-dim route in f32 and f64 on the card
    under kernel_error's rule (tol 1e-4 and 1e-3)."""
    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.models import SVGP, Gaussian
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import kernel_error

    og.LAUNCHES = og.BWD_LAUNCHES = 0
    kernel = OAKKernel.create(num_dims=D, max_interaction_depth=DEPTH)
    Xn, Yn = synth_pumadyn(1024, D)
    model = SVGP.create(kernel, Gaussian.create(0.01), Xn[:128], num_data=1024)
    kinds = {(t.dtype, t.device.type) for t in model.parameters()}
    if kinds != {(torch.float32, "cuda")}:
        raise RuntimeError(f"a model built with defaults holds {kinds}, not float32 CUDA")
    X, Y = torch.as_tensor(Xn, device=device), torch.as_tensor(Yn, device=device)
    with torch.no_grad():
        kernel.K(X[:128], X)
    torch.cuda.synchronize()
    k_launches = og.LAUNCHES
    model.training_loss(X, Y).backward()
    torch.cuda.synchronize()
    if k_launches != 1 or og.BWD_LAUNCHES == 0:
        raise RuntimeError(f"defaults: K launched K1 {k_launches} times, the gradient K2 "
                           f"{og.BWD_LAUNCHES} times")
    lines = [f"OAKKernel.create / SVGP.create / Gaussian.create with no dtype or device: "
             f"{kinds}; K launched K1 once; the training gradient launched K1 "
             f"{og.LAUNCHES - k_launches} and K2 {og.BWD_LAUNCHES} times"]
    rng = np.random.default_rng(8)
    for d, depth in ((10, 9), (D, 32)):
        k = OAKKernel.create(num_dims=d, max_interaction_depth=depth)
        for kk in k.kernels:
            kk.lengthscale.assign(rng.uniform(1.0, 3.0))
        Xd = torch.as_tensor(rng.normal(size=(300, d)), dtype=torch.float32, device=device)
        G = torch.as_tensor(rng.normal(size=(100, 300)), dtype=torch.float32, device=device)

        def value_and_grads(kern, gram, X):
            X = X.clone().requires_grad_(True)
            K = gram(kern, X[:100], X)
            raws = [p for p in kern.parameters() if p.requires_grad]
            return [K.detach()] + list(torch.autograd.grad((K * G.to(K.dtype)).sum(),
                                                           [X] + raws))

        before = (og.LAUNCHES, og.BWD_LAUNCHES)
        ours = value_and_grads(k, lambda kern, A, B: kern.K(A, B), Xd)
        torch.cuda.synchronize()
        if (og.LAUNCHES, og.BWD_LAUNCHES) != (before[0] + 1, before[1] + 1):
            raise RuntimeError(f"depth {depth} over {d} dims did not run through K1 and K2")
        plain = value_and_grads(k, _per_dim_K, Xd)
        plain64 = value_and_grads(copy.deepcopy(k).double(), _per_dim_K, Xd.double())
        errs = []
        for what, o, p32, p64 in zip(["K", "dX"] + [f"d{n}" for n in
                                                   range(len(ours) - 2)], ours, plain, plain64):
            ok, _, text = kernel_error(o, p32, p64, KERNEL_TOL if what == "K" else GRAD_TOL)
            errs.append(f"{what} {text}")
            if not ok:
                raise RuntimeError(f"depth {depth} over {d} dims: {what} {text}")
        lines.append(f"depth {depth} over {d} dims (create defaults) through K1 and K2 vs "
                     f"the per-dim route f32 / f64: " + ", ".join(errs[:3])
                     + f", {len(errs) - 3} more gradients: worst "
                     + max(errs[3:], key=lambda t: float(t.split()[1])))
    print("phase 8 defaults and depth: " + "; ".join(lines))


def synthetic_regression(n, d, seed=0):
    """The UCI scripts' synthetic regression stand-in
    (examples/uci/datasets.py::_synthetic_regression)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    w = rng.normal(size=d) / np.sqrt(d)
    y = X @ w + 0.5 * np.sin(2 * X[:, 0]) + 0.3 * X[:, 1 % d] * X[:, 2 % d]
    y = y + 0.1 * rng.normal(size=n)
    return X, y.reshape(-1, 1)


def pumadyn_fold0():
    """The UCI regression script's pumadyn stand-in (8192 x 8), its rows
    permuted by numpy's seed-0 stream, and fold 0 of an unshuffled 5-way
    split (scikit-learn's KFold: the first n % 5 folds take one row more):
    (X_train 6553 x 8, y_train, X_test 1639 x 8, y_test)."""
    X, y = synthetic_regression(PUMA_N, PUMA_D)
    perm = np.random.RandomState(0).permutation(PUMA_N)
    X, y = X[perm], y[perm]
    n_test = PUMA_N // 5 + (PUMA_N % 5 > 0)
    return X[n_test:], y[n_test:], X[:n_test], y[:n_test]


def _kernels_at(name, args, device):
    """K1 and K2 at one prescaled shape: each against its plain version
    under phase 2's and 2b's rules (a repeat K2 launch bitwise equal), then
    device ms (two profiled series), CUDA events of kernel and plain in
    turns, bound and share. Returns ({"K1": numbers, "K2": numbers},
    findings)."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import kernel_error

    *inputs, depth = args
    numbers, text = {}, []
    with torch.no_grad():
        out = og.oak_gram_fused(*inputs, depth)
        ref = og.oak_gram_plain(*inputs, depth)
        ref64 = og.oak_gram_plain(*[t.double() for t in inputs], depth)
        ok, _, line = kernel_error(out, ref, ref64, KERNEL_TOL)
        if not (ok and bool(torch.isfinite(out).all())):
            raise RuntimeError(f"K1 {name}: {line} over tol {KERNEL_TOL} or non-finite")
        text.append(f"K1 {line}")
        k1_err = float((out - ref).abs().max())
        del out, ref, ref64
    gbar = torch.as_tensor(np.random.default_rng(98).normal(
        size=(inputs[0].shape[1], inputs[1].shape[1])), dtype=torch.float32, device=device)
    ours = og.oak_gram_bwd(*inputs, gbar, depth)
    if not all(torch.equal(a, b) for a, b in zip(ours, og.oak_gram_bwd(*inputs, gbar, depth))):
        raise RuntimeError(f"K2 {name}: a repeat launch differs")
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    auto = torch.autograd.grad(og.oak_gram_plain(*leaves, depth), leaves, gbar,
                               allow_unused=True, materialize_grads=True)
    plain = og.oak_gram_bwd_plain(*inputs, gbar, depth)
    plain64 = og.oak_gram_bwd_plain(*[t.double() for t in inputs], gbar.double(), depth)
    k2_err, errs = 0.0, []
    for gname, o, a, p, p64 in zip(GRAD_NAMES, ours, auto, plain, plain64):
        if a.numel() == 0:
            continue
        results = [kernel_error(o, r, p64, GRAD_TOL) for r in (a, p)]
        errs.append(f"{gname} {max(results, key=lambda r: r[1])[2]}")
        if not (all(ok for ok, _, _ in results) and bool(torch.isfinite(o).all())):
            raise RuntimeError(f"K2 {name} {gname}: {errs[-1]} over tol {GRAD_TOL}")
        k2_err = max(k2_err, float((o - a).abs().max()))
    text.append(f"K2 [{', '.join(errs)}]")
    del ours, auto, plain, plain64, leaves

    fns = {"K1": (lambda: og.oak_gram_fused(*inputs, depth),
                  lambda: og.oak_gram_plain(*inputs, depth)),
           "K2": (lambda: og.oak_gram_bwd(*inputs, gbar, depth),
                  lambda: og.oak_gram_bwd_plain(*inputs, gbar, depth))}
    for kind, (kernel, plain_fn) in fns.items():
        with torch.no_grad():
            dev = [_device_ms(kernel) for _ in range(2)]
            ev = _turns({"plain": plain_fn, "kernel": kernel},
                        lambda fn: _cuda_ms(fn, TIMING_ITERS))
        row, nums = _table_row(name, kind, args, dev, None, float(np.mean(ev["kernel"])),
                               float(np.mean(ev["plain"])))
        numbers[kind] = nums | dict(max_abs_err=k1_err if kind == "K1" else k2_err)
        text.append(row)
    return numbers, text


def phase_oak_model(device):
    """The oak_model user path at the UCI pumadyn configuration's full width
    (examples/uci/outputs/pumadyn/config.json: depth 8, 500 inducing points,
    flows, the sparsity prior, L-BFGS), float32 on the card, on fold 0 of
    the synthetic stand-in: fit (flows, k-means, SGPR), optimise with two
    restarts, predict, NLL and RMSE, a save loaded back in float64 on the
    card (the B1 gate at matched parameters and jitter: predictions, NLL
    and the 255 normalised Sobol values, predictions also against float32's
    own error on the per-dim route), the per-component predictions against the
    mean (the UCI regression script's float32 budget), and a float32 save
    loaded back to bitwise-equal predictions. Each part prints its line. The
    launch counts cover exactly that path; then K1 and K2 at its Kuf
    shape against their plain versions."""
    from oak_tpu_torch import config, load_oak_model, oak_model, save_oak_model
    from oak_tpu_torch.models import SGPR
    from oak_tpu_torch.ops import oak_gram as og

    Xtr, ytr, Xte, yte = pumadyn_fold0()
    out_dir = REPO / "chiprun_out" / "phase9"
    out_dir.mkdir(parents=True, exist_ok=True)
    secs = {}

    def part(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        return result

    print(f"phase 9 oak_model, UCI pumadyn configuration (N {len(Xtr)} + {len(Xte)}, D "
          f"{PUMA_D}, depth {PUMA_DEPTH}, M {PUMA_M}, float32)")
    og.LAUNCHES = og.BWD_LAUNCHES = 0
    oak = oak_model(max_interaction_depth=PUMA_DEPTH, num_inducing=PUMA_M,
                    lengthscale_bounds=[1e-3, 1e3], use_sparsity_prior=True,
                    use_normalising_flow=True, optimizer="lbfgs")
    part("fit", lambda: oak.fit(Xtr, ytr, optimise=False))
    kinds = {(t.dtype, t.device.type) for t in oak.m.parameters()}
    if not (isinstance(oak.m, SGPR) and tuple(oak.m.Z.value.shape) == (PUMA_M, PUMA_D)
            and kinds == {(torch.float32, "cuda")}):
        raise RuntimeError(f"pumadyn fit built {type(oak.m).__name__} with Z "
                           f"{tuple(oak.m.Z.value.shape)} holding {kinds}")
    with torch.no_grad():
        start = float(oak.m.training_loss())
    print(f"phase 9.1 fit {secs['fit']:.3f} s (flows {oak.timings['flows']:.3f} s, k-means "
          f"{oak.timings['kmeans']:.3f} s); training loss at the start {start:.6g}")
    res = part("optimise", lambda: oak.optimise(max_iters=PUMA_ITERS, restarts=PUMA_RESTARTS))
    lanes = res.losses.numpy()
    print(f"phase 9.2 optimise(max_iters={PUMA_ITERS}, restarts={PUMA_RESTARTS}) "
          f"{secs['optimise']:.3f} s: lane losses {', '.join(f'{v:.6g}' for v in lanes)}, "
          f"returned {res.fun:.6g} after {res.num_iters} L-BFGS iterations")
    if not (np.isfinite(lanes).any() and res.fun < start):
        raise RuntimeError(f"pumadyn optimise: lanes {lanes}, returned {res.fun} against "
                           f"the start's {start}")

    pred = part("predict", lambda: oak.predict(Xte, clip=True))
    nll = part("get_loglik", lambda: -oak.get_loglik(Xte, yte, clip=True))
    rmse, std = float(np.sqrt(np.mean((pred - yte[:, 0]) ** 2))), float(yte.std())
    sobol = part("get_sobol", oak.get_sobol)
    print(f"phase 9.3 predict {len(Xte)} rows {secs['predict']:.3f} s, get_loglik "
          f"{secs['get_loglik']:.3f} s, get_sobol {secs['get_sobol']:.3f} s: test rmse "
          f"{rmse:.6g} (std {std:.6g}), nll {nll:.6g}, {len(sobol)} Sobol values")
    if not (np.isfinite(pred).all() and np.isfinite(nll) and rmse < std
            and len(sobol) == 2 ** PUMA_D - 1):
        raise RuntimeError(f"pumadyn test: rmse {rmse} (std {std}), nll {nll}, "
                           f"{len(sobol)} Sobol values")

    path = out_dir / "pumadyn_f32.npz"
    part("save", lambda: save_oak_model(oak, path))
    oak64 = part("load_f64", lambda: load_oak_model(path, dtype=torch.float64))

    def outputs(model):
        return (model.predict(Xte, clip=True), model.get_loglik(Xte, yte, clip=True),
                model.get_sobol())

    def b1_errors(ours, ref):
        """Predictions (relative to max |ref|), |NLL difference| and max
        |normalised Sobol difference|."""
        return (rel_err(ours[0], ref[0]), abs(ours[1] - ref[1]),
                float(np.abs(ours[2] - ref[2]).max()))

    # Matched parameters include the jitter, a constant of the model that
    # differs by dtype (1e-5 of Kuu's mean diagonal in float32, 1e-6 in
    # float64): Kuu's smallest eigenvalues lie below both, so the jitter
    # alone moves the float64 model by more than the gate. The float64
    # reference therefore factors at float32's jitter; its own jitter's
    # numbers are printed beside. Predictions pass within 1e-3, or within
    # twice the error of the same float32 model on the per-dim route (no
    # kernel), the drift rule of oak_tpu_torch.testing.kernel_error; NLL and
    # the Sobol values, bench.py's B1 quantities, within 1e-3.
    kernels, own = outputs(oak), outputs(oak64)
    f64_jitter = config.DEFAULT_JITTER_F64
    config.DEFAULT_JITTER_F64 = config.DEFAULT_JITTER_F32
    try:
        ref = outputs(oak64)
    finally:
        config.DEFAULT_JITTER_F64 = f64_jitter
    errs = b1_errors(kernels, ref)
    supports_fused = og.supports_fused
    og.supports_fused = lambda kernel: False
    try:
        plain = b1_errors(outputs(oak), ref)
    finally:
        og.supports_fused = supports_fused
    print(f"phase 9.4 save {secs['save']:.3f} s, load in float64 on the card "
          f"{secs['load_f64']:.3f} s; B1 at matched parameters (f64 at f32's jitter), f32 "
          f"through the kernels vs f64: predictions {errs[0]:.2e} of max |f64| (tol "
          f"{E2E_TOL}, or twice the f32 per-dim route's), nll |diff| {errs[1]:.2e} (tol "
          f"{E2E_TOL}), {len(sobol)} normalised Sobol values max |diff| {errs[2]:.2e} (tol "
          f"{SOBOL_TOL}); the f32 per-dim route vs f64: "
          + ", ".join(f"{e:.2e}" for e in plain)
          + "; the kernels vs f64 at its own jitter: "
          + ", ".join(f"{e:.2e}" for e in b1_errors(kernels, own))
          + "; f64 at f32's jitter vs f64 at its own (the jitter alone): "
          + ", ".join(f"{e:.2e}" for e in b1_errors(ref, own)))
    if not ((errs[0] < E2E_TOL or errs[0] <= 2.0 * plain[0]) and errs[1] < E2E_TOL
            and errs[2] < SOBOL_TOL):
        raise RuntimeError(f"pumadyn B1 gate: predictions {errs[0]:.3e}, nll {errs[1]:.3e}, "
                           f"Sobol {errs[2]:.3e}")

    comps = part("components", lambda: oak.get_prediction_components(Xte, clip=True))
    with torch.no_grad():
        const = float(oak.m.posterior_alpha()[:, 0].sum() * oak.m.kernel.variances[0].value)
        mean = oak.m.predict_f(oak._tensor(oak._scaled_input(Xte, True)))[0][:, 0]
    mean = mean.cpu().numpy().astype(np.float64)
    # the components run through alpha = L⁻ᵀ LB⁻ᵀ c, the mean through
    # (LB⁻¹ L⁻¹ Kus)ᵀ c; at this configuration's conditioning float32 holds
    # the identity to the UCI regression script's own budget for it
    # (examples/uci/uci_regression_train.py:140-153: 1e-2 + 2e-2 |mean| per
    # point), not to 1e-3, which is printed beside it
    diff = np.abs(comps.sum(0) + const - mean)
    ident = float(diff.max() / np.abs(mean).max())
    print(f"phase 9.5 components {secs['components']:.3f} s: {comps.shape[0]} x "
          f"{comps.shape[1]}, + constant vs the mean {ident:.2e} of max |mean| (1e-3), "
          f"max |diff| {diff.max():.2e} against the budget 1e-2 + 2e-2 |mean|")
    if not (comps.shape == (len(sobol), len(Xte)) and (diff <= 1e-2 + 2e-2 * np.abs(mean)).all()):
        raise RuntimeError(f"pumadyn components: shape {comps.shape}, sum-to-mean {ident:.3e}")
    again = part("load_f32", lambda: load_oak_model(path))
    if not np.array_equal(again.predict(Xte, clip=True), pred):
        raise RuntimeError("pumadyn: a float32 save loaded back predicts differently")
    launches = {"fwd": og.LAUNCHES, "bwd": og.BWD_LAUNCHES}
    print(f"phase 9.6 float32 save loaded back in {secs['load_f32']:.3f} s predicts bitwise "
          f"equal; launches over the path: K1 {launches['fwd']}, K2 {launches['bwd']}")
    if launches["fwd"] == 0 or launches["bwd"] == 0:
        raise RuntimeError(f"the oak_model path launched K1 {launches['fwd']} and K2 "
                           f"{launches['bwd']} times")
    path.unlink()

    # why f32 misses 1e-3 here: Kuu's conditioning against its rounding
    with torch.no_grad():
        Kuu64 = oak64.m.kernel.K(oak64.m.Z.value)
        Kuu_rounding = float((oak.m.kernel.K(oak.m.Z.value).double() - Kuu64).abs().max())
        eig_min = float(torch.linalg.eigvalsh(Kuu64)[0])
        mean_diag = float(Kuu64.diagonal().mean())
        args = tuple(t.detach().contiguous() for t in og._prep(
            oak.m.kernel, oak.m.Z.value, oak.m.X)) + (PUMA_DEPTH,)
    name = f"Kuf {PUMA_M}x{len(Xtr)}"
    numbers, text = _kernels_at(name, args, device)
    print(f"phase 9.7 Kuu in f64: smallest eigenvalue {eig_min:.3g}, mean diagonal "
          f"{mean_diag:.4g}; max |Kuu through K1 - f64| {Kuu_rounding:.2e}; kernels at {name}, "
          f"depth {PUMA_DEPTH}, vs plain: " + "; ".join(text[:2])
          + "\n" + "\n".join(text[2:]))
    return launches, numbers


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


def profile_sobol(model, device, repeats=5):
    """Where a full Sobol decomposition's time goes, on the predict phase's
    model (all dims on the factor route, so orders 1-2 take the factor forms
    and order 3 the ladder): the host clock (median of ``repeats``,
    synchronised) over the whole and its parts, then torch.profiler over one
    decomposition. The profiler's table goes to chiprun_out/profile_sobol.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from oak_tpu_torch import sobol as sb
    from oak_tpu_torch.kernels import component_index_tuples

    oak = model.kernel
    with torch.no_grad():
        Z = model.Z.value
        a = model.posterior_alpha()[:, 0]
        tuples = component_index_tuples(D, DEPTH)[1:]
        pairs = [t for t in tuples if len(t) == 2]
        Fs, Ws = sb._factor_stack(oak, Z)
        Lstack = sb._dim_L_stack(oak, Z)
        parts = sb._factor_quadforms(Fs, Ws, a, pairs)
        parts["RH"] = sb._ladder_quadforms(Lstack, a, D, DEPTH)[3]
        steps = {"compute_sobol_oak": lambda: sb.compute_sobol_oak(model),
                 "posterior_alpha": lambda: model.posterior_alpha(),
                 "routing (one host read)": lambda: sb._factor_routing(oak),
                 "factor forms build (_factor_stack)": lambda: sb._factor_stack(oak, Z),
                 "orders 1-2 factor quadratic forms": lambda: sb._factor_quadforms(
                     Fs, Ws, a, pairs),
                 "L stack build (_dim_L_stack)": lambda: sb._dim_L_stack(oak, Z),
                 "order 3, prefix ladder": lambda: sb._ladder_quadforms(
                     Lstack, a, D, DEPTH),
                 "assembly (_assemble)": lambda: sb._assemble(parts, tuples, True, oak,
                                                              device)}
        for fn in steps.values():  # warm-up
            fn()
        ms = {name: _host_ms(fn, repeats) for name, fn in steps.items()}
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sb.compute_sobol_oak(model)
            torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events
                   if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "profile_sobol.txt").write_text(events.table(sort_by="self_cuda_time_total",
                                                            row_limit=60))
    print(f"profile Sobol, {len(tuples)} components (host ms, median of {repeats}): "
          + ", ".join(f"{name} {t:.3f}" for name, t in ms.items())
          + f"; profiled decomposition: {launches} kernel launches, device time "
          f"{device_ms:.3f} ms; table in chiprun_out/profile_sobol.txt")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="instead of phases 2-9, print where a warm predict_y "
                             "request's, a warm training step's and a full Sobol "
                             "decomposition's time goes (host clock and torch.profiler)")
    parser.add_argument("--old", metavar="DIR",
                        help="a directory holding an earlier tree's csrc/*.cu with the C "
                             "interface before the redesign (git show "
                             "ef6e3b3:oak_tpu_torch/csrc/oak_gram_fwd.cu, and _bwd.cu): "
                             "phases 2 and 2b time those kernels in turns with these")
    args = parser.parse_args()
    t0 = time.perf_counter()
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    model, X = build_model(device)
    if args.profile:
        profile(model, X, device)
        profile_training(device)
        profile_sobol(model, device)
        return
    seconds = {"0-1": time.perf_counter() - t0}

    def timed(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name} took {seconds[name]:.1f} s")
        return out

    gpr = build_gpr_model(device)
    old = _old_kernels(args.old) if args.old else None
    kernel = timed("2", phase_kernel, model, X, gpr, device, old)
    kernel_bwd = timed("2b", phase_kernel_bwd, model, X, gpr, device, old)
    del gpr
    predict_launches = timed("3", phase_main_path, model, X, device)
    train_launches, trained, X_train = timed("4", phase_training, device)
    sobol_launches = timed("5", phase_sobol, trained, X_train)
    del trained, X_train
    sgpr_launches = timed("6", phase_sgpr, device)
    gpr_launches = timed("7", phase_gpr, device)
    timed("8", phase_defaults, device)
    oak_launches, oak_kernels = timed("9", phase_oak_model, device)
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
          f"total {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, launches, numbers, depth8):
        # at Kus / Kuf: ms is the CUDA-event time over 20 launches, device_ms
        # torch.profiler's kernel time per launch, plain_ms the plain version's
        # CUDA-event time; no PyTorch call computes the fused gram. The same
        # numbers at phase 9's depth-8 Kuf under "kuf_depth8"
        n = numbers["Kus/Kuf 512x8192"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": n["max_abs_err"], "ms": n["event_ms"],
                "device_ms": n["device_ms"], "plain_ms": n["plain_ms"],
                "bound_ms": n["bound_ms"], "bound_by": n["bound_by"], "share": n["share"],
                "library_ms": None, "old_device_ms": n["old_device_ms"],
                "kuf_depth8": {k: depth8[k] for k in ("max_abs_err", "event_ms", "device_ms",
                                                      "plain_ms", "bound_ms", "bound_by",
                                                      "share")}}

    print(json.dumps({"kernels": [
        entry("oak_gram_fwd_f32", "oak_tpu_torch/csrc/oak_gram_fwd.cu",
              "oak_tpu/ops/oak_gram_pallas.py:63",
              predict_launches + train_launches["fwd"] + sobol_launches
              + sgpr_launches["fwd"] + gpr_launches["fwd"] + oak_launches["fwd"], kernel,
              oak_kernels["K1"]),
        entry("oak_gram_bwd_f32", "oak_tpu_torch/csrc/oak_gram_bwd.cu",
              "oak_tpu/ops/oak_gram_pallas.py:158",
              train_launches["bwd"] + sgpr_launches["bwd"] + gpr_launches["bwd"]
              + oak_launches["bwd"], kernel_bwd, oak_kernels["K2"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
