#!/usr/bin/env python3
"""Smoke run of the PyTorch port (oak_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line of findings; any failure raises and exits
non-zero before the result line:

0. device: a CUDA card, its name and power limit from nvidia-smi, float32
   matmuls in full precision (no TF32);
1. build: compiles csrc/*.cu with nvcc into .kernel_build/ (ptxas registers
   of every kernel variant, one-lane and lane-batched, and any spills);
2. K1: the fused OAK gram forward kernel against its plain torch version on
   the card at the predict path's Kus and Kuu (from the model below), the
   GPR's square gram K(X) (8192 x 8192, D = 8, depth 2, X2 = None; exactly
   symmetric), a ragged shape, a mixed case with 2 extra grams, every depth
   1..8, the deep variants (depths 9, 12, 16, 32 at D = 32; 60 at D = 60)
   and a depth clamped to its number of grams; max error relative to max
   |plain| under 1e-4, or, where the f32 plain version drifts, within twice
   its error against f64 (oak_tpu_torch.testing.kernel_error); at Kus, Kuu
   and the square: the device time of kernel and plain in turns, the bound
   and the share; the Triton K1
   (ops/oak_gram_triton.py, the gram of the compiled serving artifact)
   at every case and at its own (TRITON_CASES: depths 16, 32 and 64, 8
   extra grams, a 1-row request, 9000 rows) against the plain version
   and against K1 under the same rule (bitwise equality to K1 counted),
   timed at Kus at depths 3, 16 and 32 in turns with K1 and plain;
2b. K2: every cotangent against autograd of the plain gram and against the
   written-out plain backward, for a seeded gbar, at the training path's
   Kuf and Kuu, the square gram and the same cases, under 1e-3 or the same
   drift rule; a repeat launch bitwise equal; then timed as in phase 2, and
   forward plus backward against plain autograd in turns;
2c. the training bounds' triangular solve (csrc/tri_solve.cu), forward and
   transposed, at SVGP's 512 x 8192, SGPR's 4 lanes x 500 x 6553 and the
   narrow widths of minibatch and data-sharded fits against float64, then
   timed beside its bound (M^2 N / 2 FFMAs a lane, a count the benchmark
   does not have) and torch.linalg.solve_triangular; the Cholesky's
   reverse pass (ops/psd.py CholeskyVjp: two transposed solves, one launch
   each for all lanes) at the cells' 4 x 500^2, 4 x 200^2 and 1 x 512^2
   against float64 autograd of the library's Cholesky, then timed alone
   beside its bound and autograd's own backward (cuBLAS's trsm); the
   lower-triangle product (csrc/gemmt.cu: the SGPR bound's A A^T and the
   wide solve's dL = -tril(dB X^T)) at the three cells' shapes against
   float64, a repeat bitwise equal, the symmetric form exactly symmetric,
   then timed beside its bound (M (M + 1) / 2 K FFMAs a lane), torch's
   full product P Q^T and the port's plain route before the kernel;
3. predict path: the bench's SVGP (N = 8192, D = 32, M = 512, depth 3,
   q_diag, whitened, float32) on the card answers predict_y requests of 1,
   100, 2048 and 8192 rows; the outputs are finite, the kernel was launched,
   and the 8192 request agrees with the same model in float64 on the CPU
   (the plain route) within 1e-3 relative to max magnitude;
4. training path: the bench's SVGP as bench.py builds it (create defaults):
   the training-loss gradient at the start point against the same model in
   float64 on the card (the plain route; loss within 1e-3 relative,
   gradient within 1e-2 of max |g|); 50 fit_adam steps;
   20 Adam steps of the bench's Bernoulli variant; 20 fit_natgrad_adam steps
   (γ 0.1) on a q_diag=False copy. Every loss is finite, each best loss is
   below its first, and both kernels were launched; the solve kernel
   launched once forward and once transposed for each gradient evaluation,
   twice more for the Cholesky of Kuu it differentiates, and once for each
   value-only one (4 at the gradient check, whose float64 model takes the
   library's solves; 4 x steps + 1 in each fit_adam; some in the
   natural-gradient fit), counted from 0 at the phase's start;
5. Sobol: the full decomposition (5,488 components) of phase 4's trained
   SVGP in float32 against the same parameters in float64 on the card
   (normalised values within 1e-3), and its peak memory; the
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
   32 over 32 run through both kernels and agree with the plain route;
9. the oak_model user path at the UCI pumadyn configuration's full width
   (examples/uci/outputs/pumadyn/config.json: depth 8, M = 500, flows, the
   sparsity prior, L-BFGS; float32, built with no dtype or device) on fold
   0 of the synthetic stand-in (6553 training rows, 1639 test rows, the
   committed run's seed-4 split): fit
   (flows and k-means timed), optimise(max_iters=40, restarts=2) (the lanes
   batched: 300 Adam steps, then L-BFGS; a lane finite and the loss below
   the start's), predict with clipping, NLL and RMSE (below std(y)); a save
   loaded in float64 on the card, factoring at float32's jitter, agrees at
   matched parameters (the B1 gate: NLL and the 255 normalised Sobol values
   within 1e-3; predictions within 1e-3 or, where the same float32 model on
   the plain route is further off, within twice its error); the
   per-component predictions plus the
   constant against the mean, within the UCI regression script's float32
   budget 1e-2 + 2e-2 |mean| per point; a float32 save loads back to
   bitwise-equal predictions; K1
   and K2 launched on the path, then both held against their plain versions
   and timed at its Kuf shape (500 x 6553, D 8, depth 8);
10. committed models and serving (phase_committed): oak_tpu's committed
   pumadyn fold 0 (examples/uci/outputs/pumadyn/model_oak_0.npz) loaded in
   float32 on the card, its test RMSE beside out_0.npz's and the B1 gate
   against float64 as in phase 9; that model and heart fold 0 (a Bernoulli
   SVGP with binary and categorical dims) serialized on the card: pumadyn's
   (mean, std) and heart's mean-only artifacts compiled into AOTInductor
   packages whose gram is the Triton K1 (by a process the script starts
   after phase 1, so that the compiles run beside phases 2-9), served at
   1, 100 and 1639 rows
   against the live predict (1e-4), one Triton K1 launch and no CUDA K1 per
   request, and served again, bitwise equal, in a python -I process that
   cannot import oak_tpu_torch and has no nvcc; the other two artifacts as
   the torch.export programs an earlier tree wrote, one K1 launch per
   request; compile and export seconds, bytes, and a warm request's device
   operations and device time; the
   torch UCI scripts (examples/uci_torch/) run end to end with --k 2
   --max_iters 30 --restarts 0; then K1 and K2 held against their plain
   versions at the shapes the phase adds (heart's Kus and Kuf with 8 extra
   grams at depth 4, autoMPG's square K(X) at depth 7), and the Triton K1
   at the served Kus (pumadyn's at 1, 100 and 1639 rows, heart's), timed
   at pumadyn's 1639 rows and heart's as in phase 2;
11. the rest of the user surface (phase_surface): the effect-plot data
   (plotting's posterior math on plot_model's grids) of the committed
   pumadyn fold 0's top 5 components and summed order-1 profile, in float32
   on the card against float64 (mean within 1e-3 of max |mean|, variance
   within 1e-3 of the largest prior variance), K1 launched, and the same for
   heart fold 0 with its binary and categorical effects (no figure is
   drawn: the card's machine has no matplotlib); Timer, trace_annotation
   and profile around a warm predict_f; cholesky_health of Kuu, checked()
   over the loss and gradient (K1 and K2 inside; a NaN raw raises and
   assert_finite names it); compat's sufficient statistics, Sobol values
   and compute_L bitwise equal to the canonical calls.
12. the multi-device layer (phase_parallel): oak_tpu_torch.parallel on
   torch.distributed, one process per rank on this one card: world 1 on
   NCCL, worlds 2 and 4 on gloo (NCCL refuses two ranks on one card; the
   sharded functions' code is the same under both). The bench SVGP's
   (config 5) sharded loss and gradient, data-parallel Adam steps, sharded
   predict_f and Sobol; at worlds 2 and 4 its fit_lbfgs_multistart_sharded
   with 4 starts on a 1 x 2 and a 2 x 2 (restart x data) mesh (4 and 2
   lanes a rank in one batched evaluation, two all-reduces each; checked
   after the main path against the same lanes in turn, also for phase 6's
   SGPR and, at world 2, phase 7's GPR: values, launches, all-reduces, the
   fit's wall time); phase 6's SGPR through
   fit_lbfgs_sharded; phase 7's GPR through the sharded Sobol (its peak
   memory per rank); oak_tpu's
   committed heart fold 0 through oak_model.get_sobol(mesh=) and
   optimise_minibatch(mesh=) at worlds 1 and 2. All against the same
   models in one process on the card (gates in phase_parallel). The
   world-2 job's ranks build the kernels at once into an empty directory.
   Then K1 and K2 against plain at the 2-rank shard's Kus.
13. the grouped evaluation of the per-dim forms (phase_grouped): at the
   bench SVGP's full width (one group of 32 dims), _prep(Z, X), K_diag(X),
   the training loss and its gradient and the full Sobol on the grouped
   route against the same through a per-dim loop written here
   (_per_dim_route), within 1e-4 (forward) or 1e-3 (gradient) of max
   |per-dim| or the drift rule; one _prep and one K_diag launch as many
   kernels at D 8 as at D 32; then the launches and device ms of a warm
   predict_y of 1 and 8192 rows and a full Sobol.
14. a multistart's lanes as one batched program (phase_lanes): K1 and K2
   launched once for 4 lanes at phase 9's pumadyn Kuf and the bench's Kuf,
   each lane against a one-lane launch (bitwise where the tile is the same)
   and the plain version, timed against four one-lane launches and plain,
   with the bound and the share; the vmapped loss and gradient of the bench
   SVGP and the pumadyn SGPR at 4 starts against the lanes one by one (1e-4
   / 1e-3), one K1 and K2 launch per gram for all lanes and no vmap
   fallback; oak_model.optimise(max_iters=40, restarts=4) at phase 9's
   configuration batched against the same starts in turn through a loop
   written here (first 5 warm Adam steps within 1e-4, the best loss within
   1e-3 or the same lane, test RMSE below std(y)), both wall times.

Each phase prints its seconds. Then one JSON line about the kernels (K1,
K2, the solve and the Triton K1), and as the last line {"ok": true,
"device": {...}}. Imports no JAX.

The launches a phase checks are the counters of utils.profiling
(k1.launches, k2.launches, solve.launches), read inside a recording session
each counting phase opens (_recorded). Kernel timings are on one clock, the
benchmark's: the device's busy time of benchmark/devtrace.py, beside the
frozen bounds of benchmark/roofline.py. Where the time of a fit, a step or
an evaluation goes is the benchmark's to say: python3 benchmark/run.py
--workload <cell> --seed N --trace 1.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import data as bench_data
from benchmark import devtrace, roofline
from oak_tpu_torch.testing import counted
from oak_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent
N, D, M, DEPTH = 8192, 32, 512, 3
KERNEL_TOL = 1e-4  # the Pallas gate's forward bound, relative to max |plain|
GRAD_TOL = 1e-3  # the Pallas gate's gradient bound (bench.py:1326-1327)
E2E_TOL = 1e-3  # f32 on the card against f64 on the CPU, relative to max magnitude
LOSS_TOL, TRAIN_GRAD_TOL = 1e-3, 1e-2  # the training gradient against f64
BATCHES = (1, 100, 2048, 8192)
# (name, D, N, M, E, depth): the Triton K1's cases beside phase 2's: the bench's
# Kus at depths 16 and 32 (timed, as every "Kus" case), depth 64 with 8 extra
# grams, a 1-row request, extra grams at a ragged batch, and a non-batch axis
# of 9000 rows
TRITON_CASES = [("Kus 512x8192 P=16", 32, 512, 8192, 0, 16),
                ("Kus 512x8192 P=32", 32, 512, 8192, 0, 32),
                ("D=60 E=8 P=64", 60, 300, 200, 8, 64),
                ("1 row 500x1 P=8", 8, 500, 1, 0, 8),
                ("E=8 200x37 P=4", 5, 200, 37, 8, 4),
                ("9000x37 P=3", 32, 9000, 37, 0, 3)]
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


def pumadyn(n, d, seed=0):
    """benchmark/data.py's pumadyn-shaped rows drawn from numpy's seed
    ``seed`` (bench.py's data at seed 0): (X [n, d], y [n, 1]), float32."""
    X, y = bench_data.synth_pumadyn(n, d, np.random.default_rng(seed))
    return X, y[:, None]


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

    X, _ = pumadyn(N, D)
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

    X, Y = pumadyn(N, D)
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

    X, Y = pumadyn(N, D)
    Z = X[np.random.default_rng(1).choice(N, M, replace=False)]
    kernel = bench_kernel(device, dtype, D, DEPTH)
    return SGPR.create(X, Y, kernel, Z, noise_variance=0.01, dtype=dtype, device=device)


def build_gpr_model(device, n=None, dtype=torch.float32):
    """The exact GP of bench.py::run_gpr_scale: pumadyn(n, 8) (n
    defaults to GPR_N), create defaults, sparsity prior, lengthscale bounds
    [1e-3, 1e3], noise 0.1."""
    from oak_tpu_torch.models import GPR

    X, Y = pumadyn(GPR_N if n is None else n, GPR_D)
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


def _recorded(phase):
    """Runs ``phase`` in a recording session of its own (utils.profiling),
    so that the launch counters it reads (``counted``) start at 0."""
    @functools.wraps(phase)
    def run(*args):
        with profiling.recording():
            return phase(*args)

    return run


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
    import triton

    print(f"phase 0 device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton "
          f"{triton.__version__}, TF32 off")


def phase_build():
    from oak_tpu_torch import _build

    b = _build.build()
    # ptxas -v: per entry function, a stack/spill line then a registers line
    regs, spills, entry = [], [], "?"
    for line in b.log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"oak_gram_(fwd|bwd)_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E",
                          m.group(1))
            t = re.search(r"tri_solve_kernelILi(\d+)ELb(\d)E", m.group(1))
            entry = (f"{k.group(1)} P={k.group(2)} {k.group(3)}x{k.group(4)}"
                     + (" lanes" if k.group(5) == "1" else "") if k
                     else f"solve NB={t.group(1)}" + (" transposed" if t.group(2) == "1" else "")
                     if t
                     else "diag_inv" if "diag_inv" in m.group(1)
                     else re.sub(r".*(oak_gram_\w+?)[A-Z]?\d*P.*", r"\1", m.group(1)))
        elif "registers" in line:
            regs.append(f"{entry} {re.search(r'Used (\d+) registers', line).group(1)}")
        elif "spill" in line and " 0 bytes spill stores" not in line:
            spills.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    print(f"phase 1 build: {b.seconds:.2f} s -> {b.path.relative_to(REPO)}; ptxas registers: "
          f"{', '.join(regs)}; spills: {' | '.join(spills) or 'none'}")
    return b.seconds


def _busy_ms(fn):
    """Device ms a call of fn: benchmark/devtrace.py's busy time (the union
    of the device operations' intervals) of a window of calls, over their
    number; the median of 3 windows. The warm-up call sizes the window: as
    many calls as its host time fits in 5 ms, 1 to 10 (a plain version's
    call takes milliseconds, a kernel's tens of microseconds). A window can
    lose every event and read nothing, so such windows are run again, up to
    9 windows in all."""
    rounds = 3

    def calls():
        for _ in range(iters):
            fn()

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    iters = min(10, max(1, int(0.005 / (time.perf_counter() - t0))))
    per_window = []
    for _ in range(3 * rounds):
        _, busy = devtrace.busy(calls)
        if busy:
            per_window.append(1e3 * busy / iters)
        if len(per_window) == rounds:
            return float(np.median(per_window))
    raise RuntimeError(f"torch.profiler recorded no device operation in {3 * rounds} windows")


def _traced(fn):
    """benchmark/devtrace.py's trace of one call of fn after a warm-up call:
    its device operations, kernel launches and busy time."""
    fn()
    torch.cuda.synchronize()
    return devtrace.traced(fn)


def _gram_work(kind, D, N, M, E, depth, lanes=1):
    """benchmark/roofline.py's frozen count of the work of kernel ``kind``
    ("K1" or "K2") on a gram [N, M] of D dims and E extra grams (a lane's,
    times ``lanes``)."""
    return (roofline.k1 if kind == "K1" else roofline.k2)(N, M, D, depth, E, lanes)


def _bound_text(work):
    """The bound of ``work`` in ms, its limiter and its counts."""
    return (f"bound {1e3 * work.bound_s():.4f} ms ({work.limiter()}: {work.ops / 1e6:.0f} M "
            f"FP32, {work.ex2 / 1e6:.0f} M ex2, {work.bytes / 1e6:.1f} MB)")


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
    """measure(fn) of each fn in turns that run the keys of fns forward, then
    back (a, b, b, a; a, b, c, c, b, a), after one warm-up call each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    turns = {k: [] for k in fns}
    for which in list(fns) + list(fns)[::-1]:
        turns[which].append(measure(fns[which]))
    return turns


def _table_row(name, kind, args, dev):
    """A kernel table's row from device ms in turns, ``dev`` ({"kernel":
    [...], "plain": [...]}): the bound of benchmark/roofline.py and the
    kernel's share of it."""
    work = _gram_work(kind, *_shape(args))
    bound, ms = 1e3 * work.bound_s(), float(np.mean(dev["kernel"]))
    return (f"  {kind} {name}: device {dev['kernel']} ms, plain {dev['plain']} ms; "
            f"{_bound_text(work)}; share {bound / ms:.2f}"), dict(
                device_ms=ms, plain_ms=float(np.mean(dev["plain"])), bound_ms=bound,
                bound_by=work.limiter(), share=bound / ms)


def _triton_checked(name, args, k1, ref, ref64):
    """The Triton K1 (ops.oak_gram_triton) at one case against the plain
    version (``ref``, ``ref64`` in float64) under phase 2's rule, and
    against K1's result ``k1`` under the same rule. Returns (bitwise equal
    to K1, the finding, max |Triton - plain|)."""
    from oak_tpu_torch.ops import oak_gram_triton as ogt
    from oak_tpu_torch.testing import kernel_error

    tri = ogt.oak_gram_triton_op(*args)
    torch.cuda.synchronize()
    ok, _, text = kernel_error(tri, ref, ref64, KERNEL_TOL)
    ok_k1, _, text_k1 = kernel_error(tri, k1, ref64, KERNEL_TOL)
    if not (ok and ok_k1 and tri.shape == ref.shape and bool(torch.isfinite(tri).all())):
        raise RuntimeError(f"Triton K1 {name}: vs plain {text}, vs K1 {text_k1}, over tol "
                           f"{KERNEL_TOL} or non-finite")
    return bool(torch.equal(tri, k1)), text, float((tri - ref).abs().max())


def _triton_row(name, args):
    """The Triton K1 timed at one shape: device ms in turns with the CUDA K1
    and the plain version (plain, K1, Triton, Triton, K1, plain), the bound
    and the share."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.ops import oak_gram_triton as ogt

    with torch.no_grad():
        dev = _turns({"plain": lambda: og.oak_gram_plain(*args),
                      "K1": lambda: og.oak_gram_fused(*args),
                      "Triton": lambda: ogt.oak_gram_triton_op(*args)}, _busy_ms)
    work = _gram_work("K1", *_shape(args))
    bound, ms = 1e3 * work.bound_s(), float(np.mean(dev["Triton"]))
    text = (f"  K1 Triton {name}, depth {args[-1]}: device {dev['Triton']} ms (the CUDA K1 in "
            f"the same turns {dev['K1']} ms), plain {dev['plain']} ms; {_bound_text(work)}; "
            f"share {bound / ms:.2f}")
    return text, dict(device_ms=ms, k1_ms=float(np.mean(dev["K1"])),
                      plain_ms=float(np.mean(dev["plain"])), bound_ms=bound,
                      bound_by=work.limiter(), share=bound / ms)


def phase_kernel(model, X, gpr, device):
    """K1 against the plain version (f32 and f64) at every case; the square
    gram exactly symmetric; the Triton K1 at every case against the plain
    version and K1 (_triton_checked); then, at the main path's three
    shapes, the device time of kernel and plain in turns, the bound and the
    share; the Triton K1 timed at Kus (_triton_row)."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import kernel_error, prescaled_inputs

    with torch.no_grad():
        findings, abs_err, triton, bitwise = [], {}, [], 0
        cases = _check_cases(model, X, gpr, device)
        for name, args in cases:
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
            same, text, abs_err[f"Triton {name}"] = _triton_checked(name, args, out, ref, ref64)
            triton.append(f"{name} {text}")
            bitwise += same
            del out, ref, ref64
        # the Triton K1's own cases (deeper, a row, 9000 rows), held as above
        triton_only = {name: tuple(prescaled_inputs(seed, d, n, m, e, p, device)) + (p,)
                       for seed, (name, d, n, m, e, p) in enumerate(TRITON_CASES, start=40)}
        for name, args in triton_only.items():
            out = og.oak_gram_fused(*args)
            ref = og.oak_gram_plain(*args)
            ref64 = og.oak_gram_plain(*[a.double() for a in args[:-1]], args[-1])
            same, text, abs_err[f"Triton {name}"] = _triton_checked(name, args, out, ref, ref64)
            triton.append(f"{name} {text}")
            bitwise += same
            del out, ref, ref64

        rows, numbers = [], {}
        for name, args in _timing_cases(model, X, gpr, device).items():
            dev = _turns({"plain": lambda a=args: og.oak_gram_plain(*a),
                          "kernel": lambda a=args: og.oak_gram_fused(*a)}, _busy_ms)
            text, nums = _table_row(name, "K1", args, dev)
            rows.append(text)
            numbers[name] = nums | dict(max_abs_err=abs_err[name])
        name = "Kus/Kuf 512x8192"
        text, nums = _triton_row(name, _timing_cases(model, X, gpr, device)[name])
        rows.append(text)
        numbers["Triton"] = nums | dict(max_abs_err=abs_err[f"Triton {name}"])
        for name, args in triton_only.items():
            if name.startswith("Kus"):
                text, nums = _triton_row(name, args)
                rows.append(text)
                numbers[f"Triton {name}"] = nums | dict(max_abs_err=abs_err[f"Triton {name}"])
    print(f"phase 2 K1 vs plain (max err / max |plain|, tol {KERNEL_TOL}; past it, the "
          f"drift rule of oak_tpu_torch.testing.kernel_error against f64): "
          f"{', '.join(findings)}; the Triton K1 (ops.oak_gram_triton) vs plain, and vs K1 "
          f"under the same rule: {', '.join(triton)}; bitwise equal to K1 at {bitwise} of "
          f"{len(cases) + len(triton_only)}; GPR K(X) exactly symmetric; device ms "
          f"(benchmark/devtrace.py) in turns plain, kernel, kernel, plain:\n" + "\n".join(rows))
    return numbers


def phase_kernel_bwd(model, X, gpr, device):
    """K2 against autograd of the plain gram and against the written-out
    plain backward (f32, and f64 for the drift rule), every cotangent, at
    every case; a repeat launch bitwise equal; then the device time of
    kernel and plain, bound and share at the main path's three shapes as in
    phase 2, and forward plus backward against plain autograd."""
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
        dev = _turns({"plain": lambda i=inputs, g=gbar, d=depth: og.oak_gram_bwd_plain(*i, g, d),
                      "kernel": lambda i=inputs, g=gbar, d=depth: og.oak_gram_bwd(*i, g, d)},
                     _busy_ms)
        text, nums = _table_row(name, "K2", args, dev)
        rows.append(text)
        numbers[name] = nums | dict(max_abs_err=abs_err[name])
        if not name.startswith("Kuu"):
            leaves = [t.clone().requires_grad_(True) for t in inputs]

            def fwd_bwd(fn, leaves=leaves, gbar=gbar, depth=depth):
                return lambda: torch.autograd.grad(fn(*leaves, depth), leaves, gbar,
                                                   allow_unused=True)

            fb = _turns({"plain": fwd_bwd(og.oak_gram_plain),
                         "kernel": fwd_bwd(og.oak_gram_fused)}, _busy_ms)
            both_text.append(f"{name} forward+backward: kernels {fb['kernel']} ms, plain "
                             f"autograd {fb['plain']} ms")
    print(f"phase 2b K2 vs plain (max err / max |ref| against autograd and the written-out "
          f"backward, tol {GRAD_TOL}; past it the drift rule against f64; a repeat launch "
          f"bitwise equal at every case): {'; '.join(findings)}; {'; '.join(both_text)} "
          f"(device ms, turns plain, kernel, kernel, plain); device ms and bounds as in "
          f"phase 2:\n" + "\n".join(rows))
    return numbers


# The training bounds' wide solves, L⁻¹Kuf forward and L⁻ᵀdA transposed:
# SVGP's at the bench width and SGPR's 4 lanes at the pumadyn setting; then
# the narrow ones that take the same route: a minibatch of 256 rows
# (optimise_minibatch's default, at its 200 inducing points and at 512), a
# 4-rank mesh's 64 rows a rank of it, and one rank's 1,638 rows of the
# pumadyn fit sharded 4 ways, 4 lanes.
SOLVE_SHAPES = (("svgp32 512x8192", 512, 8192, 1), ("sgpr8 4 lanes 500x6553", 500, 6553, 4),
                ("minibatch 200x256", 200, 256, 1), ("minibatch 512x256", 512, 256, 1),
                ("mesh rank minibatch 200x64", 200, 64, 1),
                ("mesh rank 4 lanes 500x1638", 500, 1638, 4))
# The Cholesky's reverse pass, (name, M, lanes): sgpr8-fit4's Kuu and
# I + AAᵀ over 4 lanes, heart-fit4's Kuu over 4 lanes, svgp32-train's Kuu.
VJP_SHAPES = (("sgpr8 4 lanes 500^2", 500, 4), ("heart 4 lanes 200^2", 200, 4),
              ("svgp32 512^2", 512, 1))
# The lower-triangle product, (name, lanes, M, K, symmetric): sgpr8-fit4's
# A A^T and its wide solve's dL, svgp32-train's dL, heart-fit4's dL.
GEMMT_SHAPES = (("sgpr8 4x500x6553 symmetric", 4, 500, 6553, True),
                ("sgpr8 4x500x6553 tril", 4, 500, 6553, False),
                ("svgp32 512x8192 tril", 1, 512, 8192, False),
                ("heart 4x200x237 tril", 4, 200, 237, False))


@_recorded
def phase_solve(device):
    """The triangular-solve kernel (csrc/tri_solve.cu) at the cells' shapes,
    both forms: against the float64 solve of the same float32 inputs, within
    4x the library's own float32 error and 1e-5 of max |X|
    (tests/test_torch_gpu.py::_solve_ok); then device ms (both of its
    launches) in turns with torch.linalg.solve_triangular's (library_ms,
    cuBLAS's trsm; it is also the plain version), library, kernel, kernel,
    library, and the bound: M^2 N / 2 FFMAs a lane at
    benchmark/roofline.py's FP32 peak (the benchmark counts no solve)."""
    from oak_tpu_torch.ops import tri_solve as ts

    rows, numbers = [], {}
    for name, M, N, lanes in SOLVE_SHAPES:
        g = torch.Generator().manual_seed(M + N)
        A = torch.randn(lanes, M, M, generator=g, dtype=torch.float64)
        L = torch.linalg.cholesky(A @ A.mT / M + 0.05 * torch.eye(M, dtype=torch.float64))
        L = L.float().contiguous().to(device)
        B = torch.randn(lanes, M, N, generator=g).to(device)
        if lanes == 1:
            L, B = L[0], B[0]
        for transpose in (False, True):
            form = "transposed" if transpose else "forward"
            kernel = (lambda L=L, B=B, t=transpose: ts._launch(L, B, t)) if lanes == 1 else \
                (lambda L=L, B=B, t=transpose: ts._launch(L, B, t, lanes, (True, True)))
            library = lambda L=L, B=B, t=transpose: ts.tri_solve_plain(L, B, t)  # noqa: E731
            X, lib = kernel(), library()
            ref = ts.tri_solve_plain(L.double(), B.double(), transpose)
            err = float((X.double() - ref).abs().max() / ref.abs().max())
            lib_err = float((lib.double() - ref).abs().max() / ref.abs().max())
            if not err <= min(4 * lib_err + 1e-7, 1e-5):
                raise RuntimeError(f"solve {name} {form}: error {err:.2e} against float64, "
                                   f"the library's {lib_err:.2e}")
            del X, lib, ref
            dev = _turns({"library": library, "kernel": kernel}, _busy_ms)
            bound = 1e3 * lanes * M * M * N / 2 / roofline.PEAK_FP32_OPS
            ms, lib_ms = float(np.mean(dev["kernel"])), float(np.mean(dev["library"]))
            numbers[f"{name} {form}"] = dict(
                device_ms=ms, library_ms=lib_ms, plain_ms=lib_ms, bound_ms=bound,
                bound_by="FP32", share=bound / ms, err=err, library_err=lib_err,
                panel=ts._panel(M, N, lanes, device))
            rows.append(f"  solve {name} {form}: device {dev['kernel']} ms, library "
                        f"{dev['library']} ms; bound {bound:.4f} ms (FP32: "
                        f"{lanes * M * M * N / 2e9:.2f} GFMA), share "
                        f"{bound / ms:.3f}; error {err:.2e} (library {lib_err:.2e}); panel "
                        f"{numbers[f'{name} {form}']['panel']}")
    rows += _chol_vjp_rows(device, numbers)
    rows += _gemmt_rows(device, numbers)
    print("phase 2c triangular solve vs torch.linalg.solve_triangular, the Cholesky's "
          "reverse pass vs autograd's, and the lower-triangle product vs torch's full product "
          "(device ms, benchmark/devtrace.py, in turns library, kernel, kernel, library; the "
          "product's plain route between them):\n"
          + "\n".join(rows))
    return numbers


def _chol_vjp_rows(device, numbers):
    """The Cholesky's reverse pass alone (ops/psd.py CholeskyVjp) at
    VJP_SHAPES: its gradient of a seeded cotangent against float64 autograd
    of the library's Cholesky, within 4x the library's own float32 error and
    1e-5 (tests/test_torch_gpu.py::_solve_ok), two solve launches for all
    lanes; then device ms of the backward alone (the factor held) and the
    share of its bound, M^3 FFMAs a lane (two solves) at the FP32 peak,
    beside autograd's backward (library_ms: cuBLAS's trsm, a call a lane)."""
    from oak_tpu_torch.ops import psd
    from oak_tpu_torch.ops import tri_solve as ts

    rows = []
    for name, M, lanes in VJP_SHAPES:
        g = torch.Generator().manual_seed(M + lanes)
        X = torch.randn(lanes, M, M, generator=g, dtype=torch.float64)
        A64 = X @ X.mT / M + 0.05 * torch.eye(M, dtype=torch.float64)
        A = A64.float().to(device)
        G = torch.randn(lanes, M, M, generator=g).tril().to(device)

        def factor(fn, a):
            a = a.clone().requires_grad_(True)
            return a, fn(a)[0]

        mine, lib, ref = (factor(psd.CholeskyLower.apply, A),
                          factor(torch.linalg.cholesky_ex, A),
                          factor(torch.linalg.cholesky_ex, A.double()))
        kernel = lambda f=mine: torch.autograd.grad(f[1], f[0], G, retain_graph=True)[0]  # noqa: E731
        library = lambda f=lib: torch.autograd.grad(f[1], f[0], G, retain_graph=True)[0]  # noqa: E731
        before = counted("solve.launches")
        gA = kernel()
        torch.cuda.synchronize()
        if counted("solve.launches") != before + 2:
            raise RuntimeError(f"Cholesky VJP {name}: {counted('solve.launches') - before} "
                               "solve launches, expected 2")
        gref = torch.autograd.grad(ref[1], ref[0], G.double())[0]
        err = float((gA.double() - gref).abs().max() / gref.abs().max())
        lib_err = float((library().double() - gref).abs().max() / gref.abs().max())
        if not err <= min(4 * lib_err + 1e-7, 1e-5):
            raise RuntimeError(f"Cholesky VJP {name}: error {err:.2e} against float64, the "
                               f"library's {lib_err:.2e}")
        del gA, gref, ref
        dev = _turns({"library": library, "kernel": kernel}, _busy_ms)
        bound = 1e3 * lanes * M ** 3 / roofline.PEAK_FP32_OPS
        ms, lib_ms = float(np.mean(dev["kernel"])), float(np.mean(dev["library"]))
        numbers[f"chol vjp {name}"] = dict(
            device_ms=ms, library_ms=lib_ms, plain_ms=lib_ms, bound_ms=bound,
            bound_by="FP32", share=bound / ms, err=err, library_err=lib_err,
            panel=ts._panel(M, M, lanes, device))
        rows.append(f"  chol vjp {name}: device {dev['kernel']} ms, library {dev['library']} ms; "
                    f"bound {bound:.4f} ms (FP32: {lanes * M ** 3 / 1e9:.2f} GFMA), share "
                    f"{bound / ms:.3f}; error "
                    f"{err:.2e} (library {lib_err:.2e}); panel {numbers[f'chol vjp {name}']['panel']}")
    return rows


def _gemmt_rows(device, numbers):
    """The lower-triangle product (ops/gemmt.py, csrc/gemmt.cu) at
    GEMMT_SHAPES: one launch for all lanes, a repeat bitwise equal, the
    symmetric form exactly symmetric, and against the float64 product of the
    same float32 inputs within 4x the library's own float32 error
    (tests/test_torch_gpu.py::_gemmt_ok); then device ms in turns with
    torch's full product P Q^T (library_ms, cuBLAS) and the route the port
    took before the kernel (plain_ms: A A^T as that product,
    -tril(dB X^T) as the product, a negation and a tril), library, plain,
    kernel, kernel, plain, library, beside the bound: M (M + 1) / 2 K FFMAs a lane at
    benchmark/roofline.py's FP32 peak, or the bytes, 4 (2 M K + M^2) a lane
    (M K + M^2 symmetric), at its HBM peak, whichever is longer (the
    benchmark counts no such product)."""
    from oak_tpu_torch.ops import gemmt as gm

    rows = []
    for name, lanes, M, K, sym in GEMMT_SHAPES:
        g = torch.Generator().manual_seed(M + K)
        P = torch.randn(lanes, M, K, generator=g).squeeze(0).to(device)
        Q = P if sym else torch.randn(lanes, M, K, generator=g).squeeze(0).to(device)
        alpha = 1.0 if sym else -1.0
        kernel = lambda P=P, Q=Q, a=alpha, s=sym: gm.gemmt_op(P, Q, a, s)  # noqa: E731
        library = lambda P=P, Q=Q: P @ Q.mT  # noqa: E731
        plain = library if sym else lambda P=P, Q=Q, a=alpha: a * torch.tril(P @ Q.mT)  # noqa: E731
        before = counted("gemmt.launches")
        C, again = kernel(), kernel()
        torch.cuda.synchronize()
        if counted("gemmt.launches") != before + 2:
            raise RuntimeError(f"gemmt {name}: {counted('gemmt.launches') - before} launches "
                               "for two calls, expected 2")
        if not torch.equal(C, again) or (sym and not torch.equal(C, C.mT)):
            raise RuntimeError(f"gemmt {name}: a repeat differs, or the symmetric form is not "
                               "symmetric")
        ref = gm.gemmt_plain(P.double(), Q.double(), alpha, sym)
        err = float((C.double() - ref).abs().max() / ref.abs().max())
        lib_err = float((gm.gemmt_plain(P, Q, alpha, sym).double() - ref).abs().max()
                        / ref.abs().max())
        if not err <= 4 * lib_err + 1e-7:
            raise RuntimeError(f"gemmt {name}: error {err:.2e} against float64, the library's "
                               f"{lib_err:.2e}")
        del C, again, ref
        dev = _turns({"library": library, "plain": plain, "kernel": kernel}, _busy_ms)
        fma = lanes * M * (M + 1) / 2 * K
        nbytes = 4 * lanes * ((1 if sym else 2) * M * K + M * M)
        bound = 1e3 * max(fma / roofline.PEAK_FP32_OPS, nbytes / roofline.PEAK_HBM_BYTES)
        limiter = "FP32" if fma / roofline.PEAK_FP32_OPS >= nbytes / roofline.PEAK_HBM_BYTES \
            else "bytes"
        ms, lib_ms, plain_ms = (float(np.mean(dev[k])) for k in ("kernel", "library", "plain"))
        split = gm._split(M, K, lanes, device)
        numbers[f"gemmt {name}"] = dict(
            device_ms=ms, library_ms=lib_ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=limiter, share=bound / ms, err=err, library_err=lib_err, split=split)
        rows.append(f"  gemmt {name}: device {dev['kernel']} ms, torch's full product "
                    f"{dev['library']} ms (ratio {ms / lib_ms:.3f}), plain route "
                    f"{dev['plain']} ms; bound {bound:.4f} ms "
                    f"({limiter}: {fma / 1e9:.2f} GFMA, {nbytes / 1e6:.1f} MB), share "
                    f"{bound / ms:.3f}; error {err:.2e} (library {lib_err:.2e}); split {split}")
    return rows


@_recorded
def phase_main_path(model, X, device):
    cold = serve(model, X, device)
    warm = serve(model, X, device)
    launches = counted("k1.launches")
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
    against the same model in f64 on the card (the plain route, which must
    launch neither kernel), each factoring at its dtype's default jitter.
    ``to64`` maps the loss function's arguments to f64."""
    before = _launches()
    loss32, g32 = _grad_at_start(model, loss_fn)
    launches = _launches()
    if launches[0] == before[0] or launches[1] == before[1]:
        raise RuntimeError(f"{name}: the training gradient did not launch both kernels")
    loss64, g64 = _grad_at_start(copy.deepcopy(model).to(dtype=torch.float64),
                                 to64 or loss_fn)
    if _launches() != launches:
        raise RuntimeError(f"{name}: the float64 model reached the float32 kernels")
    loss_err = abs(loss32 - loss64) / abs(loss64)
    grad_err = float((g32 - g64).abs().max() / g64.abs().max())
    if not (np.isfinite(loss32) and loss_err < LOSS_TOL and grad_err < TRAIN_GRAD_TOL):
        raise RuntimeError(f"{name} gradient f32 vs f64: loss {loss_err:.3e} (tol "
                           f"{LOSS_TOL}), gradient {grad_err:.3e} (tol {TRAIN_GRAD_TOL})")
    return (f"loss {loss32:.8g} vs {loss64:.8g}, rel err {loss_err:.2e} (tol {LOSS_TOL}); "
            f"gradient ({g32.numel()} entries) max err / max |g| {grad_err:.2e} "
            f"(tol {TRAIN_GRAD_TOL})")


def _launches():
    """(K1, K2) launches counted so far in the session that records."""
    return counted("k1.launches"), counted("k2.launches")


def _check_losses(name, losses, first_launch, first_bwd):
    losses = losses.double().cpu().numpy()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"{name}: non-finite loss in {losses}")
    if not losses.min() < losses[0]:
        raise RuntimeError(f"{name}: best loss {losses.min()} not below the first {losses[0]}")
    k1, k2 = _launches()
    if k1 == first_launch or k2 == first_bwd:
        raise RuntimeError(f"{name}: the forward or backward kernel was not launched")
    rises = int(np.sum(np.diff(losses) > 0))
    return (f"{name}: first loss {losses[0]:.6g}, best {losses.min():.6g}, last "
            f"{losses[-1]:.6g}, {rises} of {len(losses) - 1} steps raised it")


@_recorded
def phase_training(device):
    """The training path at full width: the gradient against float64, then
    fit_adam, the Bernoulli variant and natural gradients."""
    from oak_tpu_torch.optim import fit_adam, fit_natgrad_adam

    def solves(name, before, expected=None):
        # the bound's L⁻¹Kuf and its backward L⁻ᵀdA launch the solve kernel,
        # and so does the reverse pass of Kuu's Cholesky (two transposed
        # launches): four a gradient evaluation, one a value-only evaluation
        n = counted("solve.launches") - before
        if n == 0 or (expected is not None and n != expected):
            raise RuntimeError(f"{name}: {n} solve launches, expected "
                               f"{expected if expected is not None else 'some'}")
        return n

    model, X, Y = build_bench_model(device)
    # 4.1: f32 through the kernels against f64 through the plain route, on
    # the card, each factoring Kuu at its dtype's default jitter (1e-5 and
    # 1e-6 relative to the mean diagonal)
    line = _check_grad_against_f64("SVGP", model, lambda m: m.training_loss(X, Y),
                                   lambda m: m.training_loss(X.double(), Y.double()))
    solves("the gradient at the start point (f32, then f64 on the library's solves)", 0, 4)
    print(f"phase 4.1 training gradient at the start point, f32 kernels vs f64 per-dim "
          f"route on the card: {line}; solve launches 4")

    # 4.2: fit_adam (the cell svgp32-train times its steps)
    first, first_solve = _launches(), counted("solve.launches")
    res = fit_adam(model, lambda m: m.training_loss(X, Y), steps=ADAM_STEPS)
    adam_line = _check_losses(f"fit_adam {ADAM_STEPS} steps", res.losses, *first)
    adam_solves = solves("fit_adam", first_solve, 4 * ADAM_STEPS + 1)
    if not res.fun <= float(res.losses.min()):
        raise RuntimeError(f"fit_adam returned {res.fun}, above its best step loss")
    k1, k2 = _launches()
    print(f"phase 4.2 {adam_line}, returned {res.fun:.6g}, loss at step {NATGRAD_STEPS} "
          f"{float(res.losses[NATGRAD_STEPS - 1]):.6g}; launches over the steps and the final "
          f"evaluation: K1 {k1 - first[0]}, K2 {k2 - first[1]}, solve {adam_solves}")

    # 4.3: the Bernoulli variant with Adam; natural gradients on a full q
    bmodel, bX, bY = build_bench_model(device, likelihood="bernoulli")
    first, first_solve = _launches(), counted("solve.launches")
    t0 = time.perf_counter()
    bres = fit_adam(bmodel, lambda m: m.training_loss(bX, bY), steps=BERNOULLI_STEPS)
    b_ms = 1e3 * (time.perf_counter() - t0) / BERNOULLI_STEPS
    b_line = _check_losses(f"Bernoulli fit_adam {BERNOULLI_STEPS} steps", bres.losses, *first)
    b_solves = solves("Bernoulli fit_adam", first_solve, 4 * BERNOULLI_STEPS + 1)
    del bmodel
    nmodel, nX, nY = build_bench_model(device, q_diag=False)
    first, first_solve = _launches(), counted("solve.launches")
    t0 = time.perf_counter()
    nres = fit_natgrad_adam(nmodel, lambda m: m.training_loss(nX, nY),
                            steps=NATGRAD_STEPS, gamma=0.1)
    n_ms = 1e3 * (time.perf_counter() - t0) / NATGRAD_STEPS
    n_line = _check_losses(f"fit_natgrad_adam (gamma 0.1, full q) {NATGRAD_STEPS} steps",
                           nres.losses, *first)
    n_solves = solves("fit_natgrad_adam", first_solve)
    launches = dict(zip(("fwd", "bwd", "solve", "gemmt"),
                        (*_launches(), counted("solve.launches"), counted("gemmt.launches"))))
    print(f"phase 4.3 {b_line} ({b_ms:.3f} ms per step incl. sync, {b_solves} solve "
          f"launches); {n_line} ({n_ms:.3f} ms per step incl. sync, {n_solves} solve "
          f"launches); training path launches: forward {launches['fwd']}, backward "
          f"{launches['bwd']}, solve {launches['solve']}")
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


@_recorded
def phase_sobol(model, X):
    """Phase 4's trained SVGP: the full decomposition against f64, and its
    peak memory."""
    from oak_tpu_torch import sobol as sb

    model64 = copy.deepcopy(model).to(dtype=torch.float64)
    line = _check_sobol("SVGP", model, model64, X[:COMPONENT_ROWS], by_order=True)
    launches = counted("k1.launches")
    if launches == 0:
        raise RuntimeError("Sobol did not launch the forward kernel")
    peak = _peak_gb(lambda: (sb.compute_sobol_oak(model), sb.compute_sobol_by_order(model),
                             sb.get_prediction_component(model, X=X[:COMPONENT_ROWS])))
    print(f"phase 5 Sobol of the trained bench SVGP: {line}; forward launches {launches}; "
          f"peak memory of its Sobol calls {peak:.3f} GB")
    return launches


def _fit_and_compare(name, model, steps, rows, Xnew):
    """fit_adam for ``steps`` steps (best below first, both kernels
    launched), then predict_y on ``rows`` rows and Sobol against the trained
    parameters in f64."""
    from oak_tpu_torch.optim import fit_adam

    first = _launches()
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


@_recorded
def phase_sgpr(device):
    model = build_sgpr_model(device)
    grad_line = _check_grad_against_f64("SGPR", model, lambda m: m.training_loss())
    model64, fit_line = _fit_and_compare("SGPR", model, SGPR_STEPS, N, model.X)
    sobol_line = _check_sobol("SGPR", model, model64, model.X[:COMPONENT_ROWS])
    launches = dict(zip(("fwd", "bwd"), _launches()))
    print(f"phase 6 SGPR (N {N}, D {D}, M {M}, depth {DEPTH}, f32): gradient at the "
          f"start vs f64 on the card: {grad_line}; {fit_line}; Sobol: {sobol_line}; "
          f"launches: forward {launches['fwd']}, backward {launches['bwd']}")
    return launches


@_recorded
def phase_gpr(device):
    model = build_gpr_model(device)
    with torch.no_grad():
        model.kernel.K(model.X)  # K(X), X2 = None
    torch.cuda.synchronize()
    if counted("k1.launches") != 1:
        raise RuntimeError("GPR: the square gram K(X) did not launch the kernel once")
    grad_line = _check_grad_against_f64("GPR", model, lambda m: m.training_loss())
    Xnew = torch.as_tensor(pumadyn(GPR_N, GPR_D, seed=3)[0], device=device)
    model64, fit_line = _fit_and_compare("GPR", model, GPR_STEPS, COMPONENT_ROWS, Xnew)
    sobol_line = _check_sobol("GPR", model, model64)
    with torch.no_grad():
        draws = model.predict_f_samples(Xnew[:SAMPLE_ROWS], SAMPLE_DRAWS, 0)
    if draws.shape != (SAMPLE_DRAWS, SAMPLE_ROWS, 1) or not bool(torch.isfinite(draws).all()):
        raise RuntimeError(f"GPR samples: shape {tuple(draws.shape)} or non-finite")
    launches = dict(zip(("fwd", "bwd"), _launches()))
    print(f"phase 7 GPR (N {GPR_N}, D {GPR_D}, depth {GPR_DEPTH}, noise 0.1, f32): "
          f"gradient at the start vs f64 on the card: {grad_line}; {fit_line}; Sobol: "
          f"{sobol_line}; {SAMPLE_DRAWS} draws at {SAMPLE_ROWS} rows finite; launches: "
          f"forward {launches['fwd']} (the square K(X) among them), backward "
          f"{launches['bwd']}")
    return launches


def _plain_K(k, X, X2=None):
    """OAKKernel.K's plain route, whatever the dtype and device."""
    from oak_tpu_torch.ops.newton_girard import newton_girard

    return k._combine(newton_girard(k.dim_grams(X, X2), k.max_interaction_depth))


@_recorded
def phase_defaults(device):
    """The entry points' defaults: a kernel and an SVGP built with no dtype
    or device are float32 on the card, and K and the training gradient
    launch K1 and K2. Then models deeper than 8 (depth 9 over 10 dims, 32
    over 32, create defaults: every order's variance 1) through the kernels:
    K and its gradient against the plain route in f32 and f64 on the card
    under kernel_error's rule (tol 1e-4 and 1e-3)."""
    from oak_tpu_torch.kernels import OAKKernel
    from oak_tpu_torch.models import SVGP, Gaussian
    from oak_tpu_torch.testing import kernel_error

    kernel = OAKKernel.create(num_dims=D, max_interaction_depth=DEPTH)
    Xn, Yn = pumadyn(1024, D)
    model = SVGP.create(kernel, Gaussian.create(0.01), Xn[:128], num_data=1024)
    kinds = {(t.dtype, t.device.type) for t in model.parameters()}
    if kinds != {(torch.float32, "cuda")}:
        raise RuntimeError(f"a model built with defaults holds {kinds}, not float32 CUDA")
    X, Y = torch.as_tensor(Xn, device=device), torch.as_tensor(Yn, device=device)
    with torch.no_grad():
        kernel.K(X[:128], X)
    torch.cuda.synchronize()
    k_launches = counted("k1.launches")
    model.training_loss(X, Y).backward()
    torch.cuda.synchronize()
    k1, k2 = _launches()
    if k_launches != 1 or k2 == 0:
        raise RuntimeError(f"defaults: K launched K1 {k_launches} times, the gradient K2 "
                           f"{k2} times")
    lines = [f"OAKKernel.create / SVGP.create / Gaussian.create with no dtype or device: "
             f"{kinds}; K launched K1 once; the training gradient launched K1 "
             f"{k1 - k_launches} and K2 {k2} times"]
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

        before = _launches()
        ours = value_and_grads(k, lambda kern, A, B: kern.K(A, B), Xd)
        torch.cuda.synchronize()
        if _launches() != (before[0] + 1, before[1] + 1):
            raise RuntimeError(f"depth {depth} over {d} dims did not run through K1 and K2")
        plain = value_and_grads(k, _plain_K, Xd)
        plain64 = value_and_grads(copy.deepcopy(k).double(), _plain_K, Xd.double())
        errs = []
        for what, o, p32, p64 in zip(["K", "dX"] + [f"d{n}" for n in
                                                   range(len(ours) - 2)], ours, plain, plain64):
            ok, _, text = kernel_error(o, p32, p64, KERNEL_TOL if what == "K" else GRAD_TOL)
            errs.append(f"{what} {text}")
            if not ok:
                raise RuntimeError(f"depth {depth} over {d} dims: {what} {text}")
        lines.append(f"depth {depth} over {d} dims (create defaults) through K1 and K2 vs "
                     f"the plain route f32 / f64: " + ", ".join(errs[:3])
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
    permuted as the script permutes them (np.random.seed(4), then
    np.random.permutation: the stream of RandomState(4); seed 4 is every
    committed config.json's), and fold 0 of an unshuffled 5-way split
    (scikit-learn's KFold: the first n % 5 folds take one row more), the
    split of the committed examples/uci/outputs/pumadyn/model_oak_0.npz:
    (X_train 6553 x 8, y_train, X_test 1639 x 8, y_test)."""
    X, y = synthetic_regression(PUMA_N, PUMA_D)
    perm = np.random.RandomState(4).permutation(PUMA_N)
    X, y = X[perm], y[perm]
    n_test = PUMA_N // 5 + (PUMA_N % 5 > 0)
    return X[n_test:], y[n_test:], X[:n_test], y[:n_test]


def _kernels_at(name, args, device):
    """K1 and K2 at one prescaled shape: each against its plain version
    under phase 2's and 2b's rules (a repeat K2 launch bitwise equal), then
    device ms of kernel and plain in turns, bound and share. Returns ({"K1":
    numbers, "K2": numbers}, findings)."""
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
            dev = _turns({"plain": plain_fn, "kernel": kernel}, _busy_ms)
        row, nums = _table_row(name, kind, args, dev)
        numbers[kind] = nums | dict(max_abs_err=k1_err if kind == "K1" else k2_err)
        text.append(row)
    return numbers, text


def _outputs(model, X, y):
    return (model.predict(X, clip=True), model.get_loglik(X, y, clip=True),
            model.get_sobol())


def _b1_errors(ours, ref):
    """Predictions (relative to max |ref|), |NLL difference| and max
    |normalised Sobol difference|."""
    return (rel_err(ours[0], ref[0]), abs(ours[1] - ref[1]),
            float(np.abs(ours[2] - ref[2]).max()))


def b1_gate(name, oak, oak64, X, y):
    """The B1 gate at matched parameters between a float32 oak_model on the
    card (the kernels' route) and the same file loaded in float64 on the
    card, on the rows X, y; raises past it. Returns (the float32 model's
    predictions, a findings line).

    Matched parameters include the jitter, a constant of the model that
    differs by dtype (1e-5 of Kuu's mean diagonal in float32, 1e-6 in
    float64): Kuu's smallest eigenvalues lie below both, so the jitter
    alone moves the float64 model by more than the gate. The float64
    reference therefore factors at float32's jitter; its own jitter's
    numbers are printed beside. Predictions pass within 1e-3, or within
    twice the error of the same float32 model on the plain route (no
    kernel), the drift rule of oak_tpu_torch.testing.kernel_error; NLL and
    the Sobol values, bench.py's B1 quantities, within 1e-3."""
    from oak_tpu_torch import config
    from oak_tpu_torch.ops import oak_gram as og

    kernels, own = _outputs(oak, X, y), _outputs(oak64, X, y)
    f64_jitter = config.DEFAULT_JITTER_F64
    config.DEFAULT_JITTER_F64 = config.DEFAULT_JITTER_F32
    try:
        ref = _outputs(oak64, X, y)
    finally:
        config.DEFAULT_JITTER_F64 = f64_jitter
    errs = _b1_errors(kernels, ref)
    supports_fused = og.supports_fused
    og.supports_fused = lambda kernel: False
    try:
        plain = _b1_errors(_outputs(oak, X, y), ref)
    finally:
        og.supports_fused = supports_fused
    text = (f"B1 at matched parameters (f64 at f32's jitter), f32 through the kernels vs "
            f"f64: predictions {errs[0]:.2e} of max |f64| (tol {E2E_TOL}, or twice the f32 "
            f"plain route's), nll |diff| {errs[1]:.2e} (tol {E2E_TOL}), "
            f"{len(kernels[2])} normalised Sobol values max |diff| {errs[2]:.2e} (tol "
            f"{SOBOL_TOL}); the f32 plain route vs f64: "
            + ", ".join(f"{e:.2e}" for e in plain)
            + "; the kernels vs f64 at its own jitter: "
            + ", ".join(f"{e:.2e}" for e in _b1_errors(kernels, own))
            + "; f64 at f32's jitter vs f64 at its own (the jitter alone): "
            + ", ".join(f"{e:.2e}" for e in _b1_errors(ref, own)))
    if not ((errs[0] < E2E_TOL or errs[0] <= 2.0 * plain[0]) and errs[1] < E2E_TOL
            and errs[2] < SOBOL_TOL):
        raise RuntimeError(f"{name} B1 gate: predictions {errs[0]:.3e}, nll {errs[1]:.3e}, "
                           f"Sobol {errs[2]:.3e}")
    return kernels[0], text


@_recorded
def phase_oak_model(device):
    """The oak_model user path at the UCI pumadyn configuration's full width
    (examples/uci/outputs/pumadyn/config.json: depth 8, 500 inducing points,
    flows, the sparsity prior, L-BFGS), float32 on the card, on fold 0 of
    the synthetic stand-in: fit (flows, k-means, SGPR), optimise with two
    restarts, predict, NLL and RMSE, a save loaded back in float64 on the
    card (the B1 gate at matched parameters and jitter: predictions, NLL
    and the 255 normalised Sobol values, predictions also against float32's
    own error on the plain route), the per-component predictions against the
    mean (the UCI regression script's float32 budget), and a float32 save
    loaded back to bitwise-equal predictions. Each part prints its line. The
    launch counts cover exactly that path; then K1 and K2 at its Kuf
    shape against their plain versions."""
    from oak_tpu_torch import load_oak_model, oak_model, save_oak_model
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
    _, b1_text = b1_gate("pumadyn", oak, oak64, Xte, yte)
    print(f"phase 9.4 save {secs['save']:.3f} s, load in float64 on the card "
          f"{secs['load_f64']:.3f} s; {b1_text}")

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
    launches = dict(zip(("fwd", "bwd"), _launches()))
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


COMMITTED = REPO / "examples" / "uci" / "outputs"
SERVE_ROWS = (1, 100, 1639)
SERVE_TOL = 1e-4  # served vs live, both float32 through K1, as KERNEL_TOL


def _uci_modules():
    """examples/uci/datasets, examples/uci/artifact_io and
    examples/uci_torch/uci_common (numpy and scipy only)."""
    for sub in ("uci", "uci_torch"):
        if str(REPO / "examples" / sub) not in sys.path:
            sys.path.insert(0, str(REPO / "examples" / sub))
    import artifact_io
    import datasets
    import uci_common

    return datasets, artifact_io, uci_common


def heart_fold0():
    """The committed heart run's fold-0 test rows (seed-4 split, 60 x 13):
    the classification script's stand-in data, through the torch scripts'
    split."""
    datasets, _, uci_common = _uci_modules()
    X, y, _ = datasets.load_classification("heart")
    perm, folds = uci_common.kfold_splits(len(X), 5, 4)
    test = folds[0][1]
    return X[perm][test], y[perm][test]


def _check_served(name, served, live, tol=SERVE_TOL):
    served = served.cpu().numpy() if isinstance(served, torch.Tensor) else served
    err = rel_err(served, live)
    if not (served.shape == live.shape and np.isfinite(served).all() and err < tol):
        raise RuntimeError(f"{name}: served {served.shape} vs live {live.shape}, error "
                           f"{err:.3e} (tol {tol})")
    return err


def _one_launch_per_request(name, f, X):
    before = counted("k1.launches")
    f(X)
    torch.cuda.synchronize()
    if counted("k1.launches") != before + 1:
        raise RuntimeError(f"{name}: a served request launched K1 "
                           f"{counted('k1.launches') - before} times, not once")


def _kernel_names(fn, holds=None):
    """fn() under torch.profiler: (its output, {device operation name:
    launches}). A profiled window can lose kernels' events, all of them (the
    copies' may remain) or those at its start, so a window that records no
    kernel, or whose names fail ``holds``, runs fn again, up to five times;
    then the last window with a kernel is returned for the caller's check."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    seen, found = {}, None
    for _ in range(5):
        with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count}
        if any(not k.startswith(("Memcpy", "Memset")) for k in seen):
            found = out, seen
            if holds is None or holds(seen):
                return found
    if found is None:
        raise RuntimeError(f"torch.profiler recorded no kernel in 5 windows (only {seen})")
    return found


def _package_request(name, f, X, counts):
    """One request of a compiled artifact, under torch.profiler: the package
    launches the Triton K1 once (its kernel name) and the CUDA K1 not at all
    (neither by name nor in the counter ``k1.launches``), in a window that
    recorded a gram kernel (_kernel_names). Adds its Triton K1 launches to
    ``counts["triton"]`` and returns the output."""
    from oak_tpu_torch.ops import oak_gram_triton as ogt

    before = counted("k1.launches")
    # a window that lost the gram's event among the request's first kernels
    # is run again
    out, names = _kernel_names(lambda: f(X), lambda seen: any(
        ogt.KERNEL_NAME in k or "oak_gram_fwd_kernel" in k for k in seen))
    triton = sum(c for k, c in names.items() if ogt.KERNEL_NAME in k)
    cuda_k1 = sum(c for k, c in names.items() if "oak_gram_fwd_kernel" in k)
    if triton != 1 or cuda_k1 or counted("k1.launches") != before:
        raise RuntimeError(f"{name}: a package request launched the Triton K1 {triton} "
                           f"times and the CUDA K1 {cuda_k1} times by name, "
                           f"{counted('k1.launches') - before} by count; device operations: "
                           f"{names}")
    counts["triton"] += triton
    return out


def _program_blob(oak, include_var):
    """The artifact an earlier tree wrote for the card: the torch.export
    program as traced (its gram the registered CUDA-K1 op), not compiled."""
    from oak_tpu_torch import serving

    predict = oak.export_predict(include_var=include_var)
    sample = torch.stack([predict.xmin, predict.xmax])
    return serving._saved(serving._export(predict, sample, {"X": {0: torch.export.Dim("batch")}}))


def _serve_model(name, oak, X, bernoulli, counts, compiled):
    """Serialize on the card, load, serve SERVE_ROWS requests against the
    live API (the rows of X repeated where it has fewer). The compiled
    package: (mean, std) of a Gaussian model, the mean-only artifact of a
    Bernoulli one, each request launching the Triton K1 once and the CUDA
    K1 never (_package_request). The other artifact as an earlier tree
    wrote it (_program_blob), each request launching the CUDA K1 once; for
    a Gaussian model also its (mean, std) program, the package's like.
    ``compiled``: the package's blob and its compile seconds
    (_compile_served). Returns a findings line and {"package": the
    package's callable, its blob, "program": the (mean, std) program's
    callable, "rows": the served rows}."""
    from oak_tpu_torch import deserialize_predict

    X = np.resize(X, (max(SERVE_ROWS), X.shape[1]))
    live = oak.predict(X, clip=True)
    blob, compile_s = compiled
    package = deserialize_predict(blob)
    t0 = time.perf_counter()
    program_blob = _program_blob(oak, include_var=bernoulli)
    export_s = time.perf_counter() - t0
    program = deserialize_predict(program_blob)
    out = {"package": package, "blob": blob, "rows": X}
    if bernoulli:
        errs = [_check_served(f"{name} package {r} rows",
                              _package_request(name, package, X[:r], counts), live[:r])
                for r in SERVE_ROWS]
        # (p, std) mirrors predict_proba: the posterior-predictive
        # probability and the outcome's std
        _one_launch_per_request(f"{name} (p, std) program", program, X[:100])
        mean, std = (t.cpu().numpy() for t in program(X))
        v_err = _check_served(f"{name} (p, std) p", mean, oak.predict_proba(X, clip=True))
        s_err = _check_served(f"{name} (p, std) std", std, np.sqrt(mean * (1.0 - mean)))
        text = (f"mean-only package vs predict at "
                + ", ".join(f"{r} rows {e:.2e}" for r, e in zip(SERVE_ROWS, errs))
                + f"; (p, std) program vs predict_proba {v_err:.2e} / {s_err:.2e}")
    else:
        with torch.no_grad():
            var = oak.m.predict_f(oak._tensor(oak._scaled_input(X, True)))[1]
        latent_std = np.sqrt(np.maximum(var.cpu().numpy()[:, 0], 0.0)) * oak.scaler_y.scale_[0]
        errs, s_errs = [], []
        for r in SERVE_ROWS:
            mean, std = _package_request(name, package, X[:r], counts)
            errs.append(_check_served(f"{name} package {r} rows mean", mean, live[:r]))
            s_errs.append(_check_served(f"{name} package {r} rows std", std, latent_std[:r]))
        p_errs = [_check_served(f"{name} program {r} rows", program(X[:r]), live[:r])
                  for r in SERVE_ROWS]
        _one_launch_per_request(f"{name} program", program, X[:100])
        t0 = time.perf_counter()
        out["program"] = deserialize_predict(_program_blob(oak, include_var=True))
        export_s += time.perf_counter() - t0
        _check_served(f"{name} (mean, std) program", out["program"](X)[0], live)
        # no Inductor kernel holds the per-dim grams: a request's peak above
        # what was allocated stays under one [n, M, D] float32 buffer
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        package(X)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        grams = 4 * len(X) * oak.m.Z.value.shape[0] * X.shape[1]
        if peak >= grams:
            raise RuntimeError(f"{name}: a {len(X)}-row package request peaks {peak} bytes "
                               f"above its inputs, past one [n, M, D] buffer ({grams})")
        text = ("(mean, std) package vs the live mean and latent std at "
                + ", ".join(f"{r} rows {e:.2e} / {s:.2e}"
                            for r, e, s in zip(SERVE_ROWS, errs, s_errs))
                + f"; a {len(X)}-row request's peak {peak / 1e6:.2f} MB above its inputs "
                f"(one [n, M, D] buffer {grams / 1e6:.2f} MB); mean-only program vs the live "
                "mean at " + ", ".join(f"{r} rows {e:.2e}" for r, e in zip(SERVE_ROWS, p_errs)))
    line = (f"{name}: package compiled in {compile_s:.1f} s (in the compile process, beside "
            f"phases 2-9), {len(blob)} bytes; programs "
            f"exported in {export_s:.1f} s, {len(program_blob)} bytes; {text} (tol "
            f"{SERVE_TOL} of max |live|); one Triton K1 launch and no CUDA K1 per package "
            f"request, one CUDA K1 launch per program request")
    return line, out


STANDALONE = """
import json, shutil, sys
try:
    import oak_tpu_torch
except ImportError:
    pass
else:
    raise SystemExit("oak_tpu_torch is importable")
if shutil.which("nvcc") is not None:
    raise SystemExit("nvcc is on PATH")
import numpy, torch
for name in json.loads(sys.argv[1]):
    f = torch._inductor.aoti_load_package(f"../{name}.pt2")
    out = f(torch.as_tensor(numpy.load(f"../{name}.npy"), device="cuda"))
    outs = out if isinstance(out, (tuple, list)) else [out]
    numpy.savez(f"../{name}_out.npz", *[t.cpu().numpy() for t in outs])
"""


def _standalone_start(served, tmp):
    """Each package of ``served`` ({name: _serve_model's dict}) written to
    ``tmp`` with its rows, and loaded and served there by a ``python -I``
    process started from an empty directory, with PATH stripped of the CUDA
    toolkit: it cannot import oak_tpu_torch, finds no nvcc, and loads the
    blob with torch._inductor.aoti_load_package alone. Started in the
    background (phase 10.3 runs meanwhile); returns what _standalone_finish
    needs: the process, this process's outputs, the start time."""
    import os

    ours = {}
    for name, s in served.items():
        Path(tmp, f"{name}.pt2").write_bytes(s["blob"])
        X = np.asarray(s["rows"], np.float32)
        np.save(Path(tmp, f"{name}.npy"), X)
        out = s["package"](X)
        ours[name] = [t.cpu().numpy() for t in (out if isinstance(out, tuple) else [out])]
    empty = Path(tmp, "empty")
    empty.mkdir()
    path = os.pathsep.join(p for p in os.environ.get("PATH", "").split(os.pathsep)
                           if "cuda" not in p.lower())
    proc = subprocess.Popen([sys.executable, "-I", "-c", STANDALONE, json.dumps(list(served))],
                            cwd=empty, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=dict(os.environ, PATH=path))
    return proc, ours, time.perf_counter()


def _standalone_finish(started, tmp):
    """Waits for _standalone_start's process; its results must equal this
    process's, bitwise. Returns its seconds."""
    proc, ours, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"the standalone load failed ({proc.returncode}):\n"
                           f"{stdout[-2000:]}{stderr[-3000:]}")
    for name, arrays in ours.items():
        with np.load(Path(tmp, f"{name}_out.npz")) as f:
            theirs = [f[k] for k in sorted(f.files, key=lambda k: int(k.split("_")[1]))]
        if len(theirs) != len(arrays) or not all(np.array_equal(a, b)
                                                 for a, b in zip(arrays, theirs)):
            raise RuntimeError(f"{name}: the standalone process served other values")
    return seconds


# the artifacts phase 10.2 compiles: (model, include_var)
COMPILED = (("pumadyn", False), ("heart", True))


def compile_served(folder):
    """The compile process of phase 10.2 (``--compile-served DIR``): the
    committed pumadyn (mean, std) and heart mean-only artifacts serialized
    on the card with serialize_predict, each blob written to DIR/<name>.pt2
    and the seconds of each to DIR/compile.json."""
    from oak_tpu_torch import load_oak_model, serialize_predict

    seconds = {}
    for name, bernoulli in COMPILED:
        oak = load_oak_model(COMMITTED / name / "model_oak_0.npz")
        t0 = time.perf_counter()
        blob = serialize_predict(oak, include_var=not bernoulli)
        seconds[name] = time.perf_counter() - t0
        Path(folder, f"{name}.pt2").write_bytes(blob)
    Path(folder, "compile.json").write_text(json.dumps(seconds))


class _CompileServed:
    """Phase 10.2's compiles, in a process of their own (compile_served)
    started right after the build, so that they run while phases 2-9 do:
    ~165 s of Inductor that would otherwise stand in line. ``result()``
    waits for it and returns {name: (blob, compile seconds)}; ``close()``
    stops it if it still runs."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.log = open(Path(self.tmp.name, "log.txt"), "w")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--compile-served", self.tmp.name],
            stdout=self.log, stderr=subprocess.STDOUT)

    def result(self):
        self.proc.wait(timeout=900)
        self.log.close()
        if self.proc.returncode != 0:
            log = Path(self.tmp.name, "log.txt").read_text()
            raise RuntimeError(f"phase 10.2's compile process failed "
                               f"({self.proc.returncode}):\n{log[-5000:]}")
        seconds = json.loads(Path(self.tmp.name, "compile.json").read_text())
        return {name: (Path(self.tmp.name, f"{name}.pt2").read_bytes(), seconds[name])
                for name, _ in COMPILED}

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()
        self.tmp.cleanup()


def _run_script(name, args):
    """One of examples/uci_torch/'s scripts in this process (so that its
    launches count), as ``python <script> <args>``; a non-zero exit
    raises."""
    import runpy

    path = REPO / "examples" / "uci_torch" / name
    argv, sys.argv = sys.argv, [str(path)] + args
    try:
        runpy.run_path(str(path), run_name="__main__")
    except SystemExit as exit_:
        if exit_.code not in (None, 0):
            raise RuntimeError(f"{name} {' '.join(args)} exited with {exit_.code}") from exit_
    finally:
        sys.argv = argv


@_recorded
def phase_committed(device, compiles):
    """Phase 10, the committed models and serving on the card.

    10.1 examples/uci/outputs/pumadyn/model_oak_0.npz (oak_tpu's fold 0:
    SGPR, N 6553, D 8, depth 8, M 500, restarts=4, 500 iterations) loaded
    with load_oak_model's defaults, float32 on the card: on its seed-4
    fold-0 test rows (1639), the test RMSE beside out_0.npz's, the B1 gate
    against the same file in float64 on the card at float32's jitter
    (b1_gate), and the K1 launches of the path.
    10.2 that model and heart fold 0 (a Bernoulli SVGP whose binary and
    categorical dims reach K1 as extra grams) serialized on the card
    (_serve_model): pumadyn's (mean, std) and heart's mean-only artifacts
    compiled by serialize_predict into AOTInductor packages whose gram is
    the Triton K1 (in the process ``compiles`` started after phase 1,
    _CompileServed, so that the compiles run beside phases 2-9), served at
    1, 100 and 1639 rows against the live API
    (the mean against the live mean and the std against the latent std,
    or the mean against predict), each request launching the Triton K1
    once and the CUDA K1 never, a 1639-row pumadyn request's peak memory
    under one [n, M, D] buffer; both packages served again in a python -I
    process that cannot import oak_tpu_torch and has no nvcc, bitwise
    equal (_standalone_start, running beside 10.3); the two other artifacts (pumadyn's mean-only and
    heart's (p, std)) as the torch.export programs an earlier tree wrote,
    against predict or predict_proba, each request launching K1 once; the
    compile and export seconds, the blobs' bytes, and the device
    operations, kernel launches and device time of a warm request of
    pumadyn's (mean, std) package, of its program and of the live predict
    (benchmark/devtrace.py). Only two artifacts are compiled: a compile
    takes 40-45 s, the first one of a process ~120 s.
    10.3 the torch UCI scripts end to end on the card, each into a temporary
    --output_dir: uci_regression_train.py --dataset_name autoMPG and
    uci_classification_train.py --dataset_name heart, both with --k 2
    --max_iters 30 --restarts 0 (a declared cut of the committed runs' 5
    folds, 500-1000 iterations and 4 restarts); both exit 0, and every
    out_<fold>.npz passes artifact_io's invariants.
    10.4 K1 and K2 against their plain versions (_kernels_at, phase 2's
    and 2b's rules) at the shapes this phase adds: heart's Kus and Kuf
    (binary and categorical grams through extra) and autoMPG's square
    K(X) at depth 7 (_committed_shapes); the Triton K1 against the plain
    version and K1 (_triton_checked) at the served Kus (pumadyn's at 1,
    100 and 1639 rows, heart's at 1639 with 8 extra grams), timed at
    pumadyn's 1639 rows and heart's (_triton_row). These launches come
    after the phase's count is read.

    Returns the K1 and K2 launches of 10.1-10.3 and {"triton": the
    packages' Triton K1 launches in 10.2, "numbers": its timings at
    pumadyn's and heart's served Kus by name}."""
    from oak_tpu_torch import load_oak_model
    from oak_tpu_torch.models import SGPR, SVGP
    from oak_tpu_torch.ops import oak_gram as og

    _, artifact_io, _ = _uci_modules()
    t0 = time.perf_counter()
    Xtr, _, Xte, yte = pumadyn_fold0()
    oak = load_oak_model(COMMITTED / "pumadyn" / "model_oak_0.npz")
    oak64 = load_oak_model(COMMITTED / "pumadyn" / "model_oak_0.npz", dtype=torch.float64)
    kinds = {(t.dtype, t.device.type) for t in oak.m.parameters()}
    if not (isinstance(oak.m, SGPR) and tuple(oak.m.X.shape) == (len(Xtr), PUMA_D)
            and tuple(oak.m.Z.value.shape) == (PUMA_M, PUMA_D)
            and kinds == {(torch.float32, "cuda")}):
        raise RuntimeError(f"committed pumadyn: {type(oak.m).__name__}, X "
                           f"{tuple(oak.m.X.shape)}, Z {tuple(oak.m.Z.value.shape)}, {kinds}")
    pred, b1_text = b1_gate("committed pumadyn", oak, oak64, Xte, yte)
    rmse, std = float(np.sqrt(np.mean((pred - yte[:, 0]) ** 2))), float(yte.std())
    with np.load(COMMITTED / "pumadyn" / "out_0.npz") as f:
        committed_rmse, committed_nll = float(f["rmse"]), float(f["nll"])
    nll = -oak.get_loglik(Xte, yte, clip=True)
    k1 = counted("k1.launches")
    print(f"phase 10.1 committed pumadyn fold 0 (SGPR, N {len(Xtr)}, D {PUMA_D}, depth "
          f"{PUMA_DEPTH}, M {PUMA_M}; float32 on the card) on its {len(Xte)} seed-4 test rows "
          f"in {time.perf_counter() - t0:.3f} s: rmse {rmse:.6g} (out_0.npz {committed_rmse:.6g}, "
          f"std {std:.6g}), nll {nll:.6g} (out_0.npz {committed_nll:.6g}); {b1_text}; K1 "
          f"launches {k1}")
    if not (k1 > 0 and rmse < std and abs(rmse - committed_rmse) < 1e-2 * committed_rmse):
        raise RuntimeError(f"committed pumadyn: K1 launches {k1}, rmse {rmse} (out_0.npz "
                           f"{committed_rmse}, std {std})")
    del oak64

    t0 = time.perf_counter()
    counts = {"triton": 0}
    compiled = compiles.result()
    wait_s = time.perf_counter() - t0
    puma_line, served = _serve_model("pumadyn", oak, Xte, False, counts, compiled["pumadyn"])
    heart = load_oak_model(COMMITTED / "heart" / "model_oak_0.npz")
    Xh, _ = heart_fold0()
    if not (isinstance(heart.m, SVGP) and og.supports_fused(heart.m.kernel)
            and heart.binary_index and heart.categorical_index):
        raise RuntimeError("committed heart: not a fused-route SVGP with binary and "
                           "categorical dims")
    heart_line, heart_served = _serve_model("heart", heart, Xh, True, counts,
                                            compiled["heart"])
    standalone_tmp = tempfile.TemporaryDirectory()
    standalone = _standalone_start({"pumadyn": served, "heart": heart_served},
                                   standalone_tmp.name)
    latency = []
    for rows in (1, len(Xte)):
        Xr = Xte[:rows]
        calls = {"package": lambda: served["package"](Xr)[0].cpu(),
                 "program": lambda: served["program"](Xr)[0].cpu(),
                 "live predict": lambda: oak.predict(Xr, clip=True)}
        parts = []
        for what, fn in calls.items():
            trace = _traced(fn)
            parts.append(f"{what} {len(trace.ops)} device operations, {trace.launches} kernel "
                         f"launches, {1e3 * trace.busy_s:.3f} ms on the device")
        latency.append(f"{rows} rows: " + ", ".join(parts))
    print(f"phase 10.2 serving ({time.perf_counter() - t0:.3f} s, of which {wait_s:.1f} s "
          f"waiting for the compile process started after phase 1): {puma_line}; "
          f"{heart_line}; Triton K1 launches by the packages {counts['triton']}; a warm "
          f"request of pumadyn's (mean, std), numpy in and out (benchmark/devtrace.py): "
          + "; ".join(latency))

    t0 = time.perf_counter()
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for script, dataset, task in (("uci_regression_train.py", "autoMPG", "regression"),
                                      ("uci_classification_train.py", "heart",
                                       "classification")):
            out = Path(tmp) / dataset
            t = time.perf_counter()
            _run_script(script, ["--dataset_name", dataset, "--k", "2", "--max_iters", "30",
                                 "--restarts", "0", "--output_dir", str(out)])
            for fold in (0, 1):
                with np.load(out / f"out_{fold}.npz", allow_pickle=True) as f:
                    d = {k: f[k] for k in f.files}
                problems = artifact_io.fold_problems(
                    task, nll=float(d["nll"]),
                    sobol_vector=d.get("normalised_sobols", d.get("sobol")),
                    sobol_order=d["sobol_order"],
                    classification_error=(float(d["classification_accuracy"])
                                          if task == "classification" else None),
                    rmse=float(d["rmse"]) if task == "regression" else None)
                if problems:
                    raise RuntimeError(f"{script} fold {fold}: {problems}")
            runs.append(f"{script} --dataset_name {dataset} {time.perf_counter() - t:.1f} s")
    launches = dict(zip(("fwd", "bwd"), _launches()))
    print(f"phase 10.3 the torch UCI scripts (--k 2 --max_iters 30 --restarts 0) on the card "
          f"in {time.perf_counter() - t0:.1f} s: " + ", ".join(runs)
          + "; each exited 0 and its out_0.npz, out_1.npz pass artifact_io's invariants; "
          f"launches over phase 10: K1 {launches['fwd']}, K2 {launches['bwd']}")
    if launches["bwd"] == 0:
        raise RuntimeError("phase 10's training runs did not launch K2")
    try:
        standalone_s = _standalone_finish(standalone, standalone_tmp.name)
    finally:
        standalone_tmp.cleanup()
    print(f"phase 10.2 both packages loaded and served in a python -I process (no "
          f"oak_tpu_torch, no nvcc on PATH), started before 10.3: equal to this one's, "
          f"bitwise ({standalone_s:.1f} s)")

    t0 = time.perf_counter()
    text = []
    shapes = _committed_shapes(heart, Xh)
    for name, args in shapes.items():
        _, lines = _kernels_at(name, args, device)
        text += [f"{name}, depth {args[-1]}: " + "; ".join(lines[:2])] + lines[2:]
    served_kus = _served_kus(oak, Xte)
    served_kus.update({k: v for k, v in shapes.items() if k.startswith("heart Kus")})
    bitwise, findings = 0, []
    with torch.no_grad():
        for name, args in served_kus.items():
            k1 = og.oak_gram_fused(*args)
            ref = og.oak_gram_plain(*args)
            ref64 = og.oak_gram_plain(*[t.double() for t in args[:-1]], args[-1])
            same, finding, _ = _triton_checked(name, args, k1, ref, ref64)
            bitwise += same
            findings.append(f"{name} {finding}")
    timed_rows, triton_numbers = [], {}
    for name in (f"pumadyn Kus {PUMA_M}x{len(Xte)}", next(k for k in served_kus
                                                          if k.startswith("heart Kus"))):
        row, triton_numbers[name] = _triton_row(name, served_kus[name])
        timed_rows.append(row)
    print(f"phase 10.4 K1 and K2 vs plain at phase 10's shapes, the Triton K1 at the served "
          f"Kus ({time.perf_counter() - t0:.1f} s):\n" + "\n".join(text)
          + f"\n  Triton K1 vs plain (and vs K1 under the same rule): {', '.join(findings)}; "
          f"bitwise equal to K1 at {bitwise} of {len(served_kus)}\n" + "\n".join(timed_rows))
    return launches, dict(counts, numbers=triton_numbers)


def _served_kus(oak, Xte):
    """Prescaled inputs of the committed pumadyn model's served Kus (Z
    against the scaled test rows) at 1, 100 and len(Xte) rows, depth 8."""
    from oak_tpu_torch.ops import oak_gram as og

    k, Z = oak.m.kernel, oak.m.Z.value
    out = {}
    with torch.no_grad():
        for rows in SERVE_ROWS:
            Xs = oak._tensor(oak._scaled_input(Xte[:rows], True))
            args = tuple(t.detach().contiguous() for t in og._prep(k, Z, Xs))
            out[f"pumadyn Kus {Z.shape[0]}x{rows}"] = args + (k.max_interaction_depth,)
    return out


def _committed_shapes(heart, Xh):
    """Prescaled kernel inputs at the shapes phase 10 adds, with the
    committed models' parameters: heart's Kus at the largest served
    request (5 RBF dims, 8 binary and categorical grams as extra, depth
    4), heart's Kuf at the classification script's fold-0 training rows
    (--k 2; the backward with dextra), and autoMPG's square K(X) at the
    regression script's fold-0 training rows (GPR, depth 7)."""
    from oak_tpu_torch import load_oak_model
    from oak_tpu_torch.ops import oak_gram as og

    datasets, _, uci_common = _uci_modules()
    shapes = {}
    with torch.no_grad():
        def add(name, oak, A, B):
            k = oak.m.kernel
            if not og.supports_fused(k):
                raise RuntimeError(f"{name}: the kernel does not take the fused route")
            args = tuple(t.detach().contiguous() for t in og._prep(k, A, B))
            shapes[f"{name} {A.shape[0]}x{B.shape[0]}"] = args + (k.max_interaction_depth,)

        Z = heart.m.Z.value
        served = np.resize(Xh, (max(SERVE_ROWS), Xh.shape[1]))
        add("heart Kus", heart, Z, heart._tensor(heart._scaled_input(served, True)))
        X, _, _ = datasets.load_classification("heart")
        perm, folds = uci_common.kfold_splits(len(X), 2, 4)
        train = X[perm][folds[0][0]]
        add("heart Kuf", heart, Z, heart._tensor(heart._scaled_input(train, True)))
        mpg = load_oak_model(COMMITTED / "autoMPG" / "model_oak_0.npz")
        X, _, _ = datasets.load_regression("autoMPG")
        perm, folds = uci_common.kfold_splits(len(X), 2, 4)
        Xa = mpg._tensor(mpg._scaled_input(X[perm][folds[0][0]], True))
        add("autoMPG K(X)", mpg, Xa, Xa)
    return shapes


PLOT_TOP = 5  # plot_model's top_n in examples/uci_torch/uci_plotting.py
PLOT_TOL = 1e-3  # f32 plot data against f64: mean of max |mean|, variance of the prior


def _plot_grids(oak, dims):
    """The grid columns plot_model evaluates the component ``dims`` on
    (oak_tpu_torch/plotting.py): 100 points over a continuous dim's data,
    the two levels of a binary dim, every level of a categorical one, a
    50 x 50 grid between the 2 % and 98 % quantiles of two continuous dims,
    100 x 2 for a continuous and a binary dim; i == D, the summed order-1
    profile, on 100 points of [-3, 3]. None for what plot_model skips
    (orders above 2, two discrete dims)."""
    X, cont, binary = oak.X_scaled, oak.continuous_index, oak.binary_index
    if dims == (oak.num_dims,):
        return [np.linspace(-3.0, 3.0, 100)]
    if len(dims) == 1:
        i = dims[0]
        if i in cont:
            return [np.linspace(X[:, i].min(), X[:, i].max(), 100)]
        if i in binary:
            return [np.array([0.0, 1.0])]
        return [np.arange(float(oak.m.kernel.kernels[i].p.shape[0]))]
    if len(dims) != 2:
        return None
    i, j = dims
    if i in cont and j in cont:
        lo_i, hi_i = np.percentile(X[:, i], (2, 98))
        lo_j, hi_j = np.percentile(X[:, j], (2, 98))
        gx, gy = np.meshgrid(np.linspace(lo_i, hi_i, 50), np.linspace(lo_j, hi_j, 50))
        return [gx.flatten(), gy.flatten()]
    if {i, j} <= set(cont) | set(binary) and (i in cont) != (j in cont):
        c = i if i in cont else j
        lo, hi = np.percentile(X[:, c], (2, 98))
        xx, yy = np.mgrid[lo:hi:100j, 0:1:2j]
        return [xx.flatten(), yy.flatten()] if i == c else [yy.flatten(), xx.flatten()]
    return None


def _plot_data(oak, components):
    """{dims: (mean, variance, prior variance)} of each component on its
    plot grid, through the port's posterior math on the model's device
    (plotting._component_posterior, and _summed_order1_posterior for
    i == D); the prior v·K_diag is the scale at which float32's variance
    cancels."""
    from oak_tpu_torch import plotting
    from oak_tpu_torch.kernels.oak_kernel import kernel_K_diag

    out = {}
    m, D = oak.m, oak.num_dims
    Xc = plotting._conditioning_inputs(m)
    for dims in components:
        cols = _plot_grids(oak, dims)
        if cols is None:
            continue
        with torch.no_grad():
            if dims == (D,):
                mu, var = plotting._summed_order1_posterior(m, cols[0])
                s = plotting._on(cols[0], Xc)
                prior = plotting._order_variance(m, 1, Xc) * sum(
                    kernel_K_diag(m.kernel.kernels[i], s) for i in oak.continuous_index)
            else:
                mu, var = plotting._component_posterior(m, list(dims), cols)
                prior = plotting._order_variance(m, len(dims), Xc)
                for d, col in zip(dims, cols):
                    prior = prior * kernel_K_diag(m.kernel.kernels[d], plotting._on(col, Xc))
        out[dims] = (mu, var, prior.double().cpu().numpy())
    return out


def _plot_components(oak, extra=()):
    """The top PLOT_TOP components by normalised Sobol index (oak.get_sobol
    on the card), the summed order-1 profile (D,) and ``extra``."""
    oak.get_sobol()
    order = np.argsort(oak.normalised_sobols)[::-1][:PLOT_TOP]
    top = [tuple(oak.tuple_of_indices[n]) for n in order]
    return top + [(oak.num_dims,)] + [c for c in extra if c not in top]


def _plot_gate(name, data, data64):
    """Each component's f32 mean within PLOT_TOL of max |f64 mean| and its
    variance within PLOT_TOL of the largest f64 prior variance on the grid."""
    worst, parts = [0.0, 0.0], []
    for dims, (mu, var, _) in data.items():
        mu64, var64, prior64 = data64[dims]
        e_mu = float(np.abs(mu - mu64).max() / max(np.abs(mu64).max(), 1e-300))
        e_var = float(np.abs(var - var64).max() / prior64.max())
        worst = [max(worst[0], e_mu), max(worst[1], e_var)]
        parts.append(f"{dims} {len(mu)} pts mean {e_mu:.2e} var {e_var:.2e}")
        if not (np.isfinite(mu).all() and np.isfinite(var).all() and e_mu < PLOT_TOL
                and e_var < PLOT_TOL):
            raise RuntimeError(f"{name} plot data {dims}: mean {e_mu:.3e} of max |mean|, "
                               f"variance {e_var:.3e} of the prior (tol {PLOT_TOL})")
    return worst, parts


@_recorded
def phase_surface(device):
    """Phase 11, the rest of the user surface on the card.

    11.1 effect-plot data: oak_tpu's committed pumadyn fold 0 (SGPR, N 6553,
    D 8, depth 8, M 500) loaded in float32 on the card, get_sobol, then the
    posterior mean and variance of its top 5 components and of the summed
    order-1 profile on plot_model's grids (_plot_grids), against the same
    computation on the file loaded in float64 on the card (_plot_gate); the
    same for heart fold 0 (a Bernoulli SVGP) with every binary and
    categorical single effect added. No figure is drawn: the card's
    machine has no matplotlib.
    11.2 profiling: Timer around a warm predict_f of pumadyn's 1639 test
    rows reads, call by call, no less than CUDA events around the same call
    (with block_on, and with None); trace_annotation("oak.predict") shows by name
    in a torch.profiler table of that call; profile() writes a trace into
    chiprun_out/phase11_trace/.
    11.3 diagnostics: cholesky_health of pumadyn's Kuu in float32 (through
    K1) and float64; checked(loss and gradient) of the committed model
    passes with K1 and K2 launched inside it; with a lengthscale's raw set
    to NaN on a copy, it raises and assert_finite names that raw's path; an
    inf made in a backward (autograd's worker thread on the card) raises.
    11.4 compat: get_model_sufficient_statistics and compute_sobol_oak on
    the float32 model equal the canonical calls bitwise, and compute_L at
    each dim equals sobol.compute_L_gaussian bitwise.

    Returns the K1 and K2 launches of the phase."""
    import copy
    import importlib.util

    from oak_tpu_torch import compat, load_oak_model, sobol
    from oak_tpu_torch.params import trainable_params
    from oak_tpu_torch.utils import (Timer, assert_finite, checked, cholesky_health, profile,
                                     trace_annotation)

    path = COMMITTED / "pumadyn" / "model_oak_0.npz"
    oak = load_oak_model(path)
    oak64 = load_oak_model(path, dtype=torch.float64)
    t0 = time.perf_counter()
    data = _plot_data(oak, _plot_components(oak))
    torch.cuda.synchronize()
    plot_s = time.perf_counter() - t0
    k1_plot = counted("k1.launches")
    data64 = _plot_data(oak64, list(data))
    worst, parts = _plot_gate("pumadyn", data, data64)
    heart_path = COMMITTED / "heart" / "model_oak_0.npz"
    heart, heart64 = load_oak_model(heart_path), load_oak_model(heart_path, dtype=torch.float64)
    discrete = [(i,) for i in heart.binary_index + heart.categorical_index]
    hdata = _plot_data(heart, _plot_components(heart, discrete))
    hworst, hparts = _plot_gate("heart", hdata, _plot_data(heart64, list(hdata)))
    k1 = counted("k1.launches")
    drawn = ("no figure drawn: matplotlib is not installed here"
             if importlib.util.find_spec("matplotlib") is None
             else "no figure drawn (drawing runs on the CPU)")
    print(f"phase 11.1 plot data on the card, f32 vs f64 (tol {PLOT_TOL}: mean of max |mean|, "
          f"variance of the largest prior variance): pumadyn top {PLOT_TOP} and the summed "
          f"order-1 profile in {plot_s:.3f} s of host time (get_sobol included; K1 launches "
          f"{k1_plot}), worst mean {worst[0]:.2e}, variance {worst[1]:.2e} [{'; '.join(parts)}]; "
          f"heart top {PLOT_TOP}, the profile and its binary and categorical effects: worst "
          f"mean {hworst[0]:.2e}, variance {hworst[1]:.2e} [{'; '.join(hparts)}]; K1 launches "
          f"in 11.1 {k1}; {drawn}")
    if k1_plot == 0:
        raise RuntimeError("the plot data did not launch K1")
    del heart64

    t0 = time.perf_counter()
    Xte = pumadyn_fold0()[2]
    Xs = oak._tensor(oak._scaled_input(Xte, True))
    with torch.no_grad():
        def predict():
            return oak.m.predict_f(Xs)

        predict()
        calls = []  # (mode, Timer ms, CUDA-event ms) per call
        for mode in ("block_on", "every card") * 3:
            timer, outs = Timer(), []
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with timer(mode, block_on=outs if mode == "block_on" else None):
                start.record()
                outs.append(predict()[1])
                end.record()
            torch.cuda.synchronize()
            calls.append((mode, 1e3 * timer.results[mode], start.elapsed_time(end)))
        t_ms = {m: float(np.mean([t for k, t, _ in calls if k == m])) for m in ("block_on",
                                                                                "every card")}
        ev_ms = float(np.mean([e for _, _, e in calls]))
        margin = min(t - e for _, t, e in calls)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            with trace_annotation("oak.predict"):
                predict()
            torch.cuda.synchronize()
        keys = {e.key for e in prof.key_averages()}
        trace_dir = REPO / "chiprun_out" / "phase11_trace"
        with profile(trace_dir):
            with trace_annotation("oak.predict"):
                predict()
            torch.cuda.synchronize()
    traces = sorted(trace_dir.glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
    trace_bytes = traces[-1].stat().st_size if traces else 0
    print(f"phase 11.2 profiling ({time.perf_counter() - t0:.3f} s): Timer around a warm "
          f"predict_f of {len(Xte)} rows {t_ms['block_on']:.3f} ms with block_on, "
          f"{t_ms['every card']:.3f} ms waiting for every card, against CUDA events "
          f"{ev_ms:.3f} ms (means of 3 calls each; Timer - events per call at least "
          f"{margin:.3f} ms); 'oak.predict' in the torch.profiler table: "
          f"{'oak.predict' in keys}; profile() wrote {traces[-1].name if traces else 'nothing'} "
          f"({trace_bytes} bytes) into {trace_dir.relative_to(REPO)}")
    if not (margin >= 0.0 and "oak.predict" in keys and trace_bytes > 0):
        raise RuntimeError(f"profiling: Timer vs events per call {calls}, annotation "
                           f"{'oak.predict' in keys}, trace {trace_bytes} bytes")

    t0 = time.perf_counter()
    with torch.no_grad():
        health = cholesky_health(oak.m.kernel.K(oak.m.Z.value))
        health64 = cholesky_health(oak64.m.kernel.K(oak64.m.Z.value))
    del oak64

    def loss_and_grad(model):
        raws = [p.raw for p in trainable_params(model)]
        return torch.autograd.grad(model.training_loss(), raws)

    before = _launches()
    grads = checked(loss_and_grad)(oak.m)
    inside = tuple(a - b for a, b in zip(_launches(), before))
    broken = copy.deepcopy(oak.m)
    with torch.no_grad():
        broken.kernel.kernels[3].lengthscale.raw.fill_(float("nan"))
    try:
        checked(loss_and_grad)(broken)
    except FloatingPointError as e:
        raised = str(e)
    else:
        raised = None
    try:
        assert_finite(broken, "model")
    except FloatingPointError as e:
        named = str(e)
    else:
        named = ""
    # autograd runs a CUDA backward on a worker thread: the mode must reach
    # it (sqrt is finite at 0, its derivative is not)
    x = torch.tensor([4.0, 0.0], device=device, requires_grad=True)
    try:
        checked(lambda: torch.autograd.grad(torch.sqrt(x).sum(), x))()
    except FloatingPointError as e:
        in_backward = str(e)
    else:
        in_backward = None
    print(f"phase 11.3 diagnostics ({time.perf_counter() - t0:.3f} s): cholesky_health of "
          f"Kuu {PUMA_M}x{PUMA_M}, f32 through K1: eig_min {health['eig_min']:.4g}, eig_max "
          f"{health['eig_max']:.4g}, condition {health['condition']:.4g}, diag_min "
          f"{health['diag_min']:.4g}, finite {health['finite']}; f64: eig_min "
          f"{health64['eig_min']:.4g}, condition {health64['condition']:.4g}; checked(loss and "
          f"gradient) clean, {len(grads)} gradients, K1 {inside[0]} and K2 {inside[1]} launches "
          f"inside; with kernels[3].lengthscale.raw NaN it raised: {raised}; assert_finite: "
          f"{named}; an inf made in a CUDA backward raised: {in_backward}")
    if not (inside[0] > 0 and inside[1] > 0 and raised is not None and in_backward is not None
            and ".kernel.kernels[3].lengthscale.raw" in named
            and all(bool(torch.isfinite(g).all()) for g in grads)):
        raise RuntimeError(f"diagnostics: launches {inside}, raised {raised!r}, named {named!r}")
    del broken

    t0 = time.perf_counter()
    with torch.no_grad():
        alpha, L = compat.get_model_sufficient_statistics(oak.m)
        same = [torch.equal(alpha, oak.m.posterior_stats()[0])]
        tuples, values = compat.compute_sobol_oak(oak.m, 1.0, 0.0)
        ctuples, cvalues = sobol.compute_sobol_oak(oak.m)
        same.append(tuples == ctuples and np.array_equal(values, cvalues))
        Z = oak.m.Z.value
        for d, k in enumerate(oak.m.kernel.kernels):
            l, v = k.lengthscale.value, k.variance.value
            ours = compat.compute_L(Z, l, v, d, 1.0, 0.0)
            one = torch.ones((), dtype=Z.dtype, device=Z.device)
            ref = sobol.compute_L_gaussian(Z[:, d], l, v, one, 0.0 * one).cpu().numpy()
            same.append(np.array_equal(ours, ref))
    print(f"phase 11.4 compat on the card ({time.perf_counter() - t0:.3f} s): "
          f"get_model_sufficient_statistics' alpha, compute_sobol_oak's {len(values)} values "
          f"and compute_L at the {PUMA_D} dims equal the canonical calls bitwise: {same}; L "
          f"{L.shape}, finite {bool(np.isfinite(L).all())}")
    if not (all(same) and np.isfinite(L).all()):
        raise RuntimeError(f"compat on the card: bitwise equal {same}")
    return dict(zip(("fwd", "bwd"), _launches()))


# --------------------------------------------------------------------------- #
# Phase 12: the multi-device layer (oak_tpu_torch.parallel)
# --------------------------------------------------------------------------- #
# (world, backend) of the three jobs, one after another on cuda:0: NCCL at
# world 1 (it refuses two ranks on one card), gloo at 2 and 4 ranks sharing it
PAR_JOBS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
PAR_STEPS, PAR_LBFGS_ITERS, PAR_MS_ITERS = 5, 5, 3
# the data-sharded multistart at worlds 2 and 4: starts, warm Adam steps, the
# (restart, data) mesh of each world (4 and 2 lanes a rank)
PAR_MS_STARTS, PAR_MS_WARM = 4, 5
PAR_MS_MESH = {2: (1, 2), 4: (2, 2)}
PAR_MB_BATCH, PAR_MB_STEPS = 64, 10
PAR_LOSS_TOL, PAR_GRAD_TOL, PAR_PRED_TOL, PAR_SOBOL_TOL, PAR_FIT_TOL = (
    1e-5, 1e-4, 1e-5, 1e-5, 1e-3)
PAR_JOB_TIMEOUT_S = 240


def _bench_y():
    return pumadyn(N, D)[1]


def _heart(device):
    from oak_tpu_torch import load_oak_model

    return load_oak_model(COMMITTED / "heart" / "model_oak_0.npz", device=device)


def _normalised(values):
    from oak_tpu_torch.sobol import normalize_sobol

    return normalize_sobol(np.asarray(values, np.float64))


def _parallel_references(device):
    """The single-process values phase 12's ranks are held against, on the
    same card in float32, and the single-process times."""
    from oak_tpu_torch import sobol as sb
    from oak_tpu_torch.optim import fit_adam, fit_lbfgs, fit_lbfgs_multistart
    from oak_tpu_torch.optim.fit import value_and_grad
    from oak_tpu_torch.params import flatten_trainable

    ref, ms = {}, {}
    model, Xh = build_model(device)
    X, Y = (torch.as_tensor(a, device=device) for a in (Xh, _bench_y()))
    ref["loss"], ref["grad"] = value_and_grad(model, lambda m: m.training_loss(X, Y),
                                              flatten_trainable(model).detach())
    # the same Adam steps in one process (no mask, as the data-parallel step)
    step_model = copy.deepcopy(model)
    fit_adam(step_model, lambda m, a, b: m.training_loss(a, b), steps=1,
             batch_fn=lambda i: (X, Y))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit_adam(step_model, lambda m, a, b: m.training_loss(a, b), steps=PAR_STEPS,
             batch_fn=lambda i: (X, Y))
    torch.cuda.synchronize()
    ms["step"] = 1e3 * (time.perf_counter() - t0) / PAR_STEPS
    with torch.no_grad():
        model.predict_f(X)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, var = model.predict_f(X)
        ref["mean"], ref["var"] = mean.cpu(), var.cpu()
        ms["predict"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ref["svgp_sobol"] = _normalised(sb.compute_sobol_oak(model)[1])
    ms["sobol"] = 1e3 * (time.perf_counter() - t0)
    del model, step_model

    ref["lbfgs_fun"] = fit_lbfgs(build_sgpr_model(device), lambda m: m.training_loss(),
                                 max_iters=PAR_LBFGS_ITERS).fun
    t0 = time.perf_counter()
    ref["ms_fun"] = fit_lbfgs_multistart(
        build_model(device)[0], lambda m: m.training_loss(X, Y), n_starts=PAR_MS_STARTS,
        seed=0, warm_adam_steps=PAR_MS_WARM, max_iters=PAR_MS_ITERS).fun
    torch.cuda.synchronize()
    ms["multistart"] = 1e3 * (time.perf_counter() - t0)
    gpr = build_gpr_model(device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ref["gpr_sobol"] = _normalised(sb.compute_sobol_oak(gpr)[1])
    ms["gpr_sobol_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    ref["gpr_by_order"] = _normalised(sb.compute_sobol_by_order(gpr))
    ms["gpr_by_order_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    del gpr
    # the per-order totals cancel in float32 (Newton-Girard over the [N, N]
    # L matrices): their own error against float64 sets their gate
    ref["gpr_by_order_drift"] = float(np.abs(ref["gpr_by_order"] - _normalised(
        sb.compute_sobol_by_order(build_gpr_model(device, dtype=torch.float64)))).max())
    heart = _heart(device)
    ref["heart_sobol"] = heart.get_sobol()
    ref["heart_fun"] = heart.optimise_minibatch(batch_size=PAR_MB_BATCH, steps=PAR_MB_STEPS,
                                                seed=0).fun
    torch.cuda.empty_cache()
    return ref, ms


class _InTurn:
    """A data-sharded loss seen without its lanes form: ``fit.LaneLoss``
    then evaluates a rank's lanes one after another through
    ``loss_and_grads``, two all-reduces each (the reference of phase 12's
    batched evaluations and fits)."""

    def __init__(self, loss):
        self.loss = loss
        self.loss_and_grads = loss.loss_and_grads
        self.writes_checkpoints = loss.writes_checkpoints

    def __call__(self, model, *args):
        return self.loss(model, *args)


@contextlib.contextmanager
def _counted(owner, name):
    """Counts the calls of ``owner.name`` within the block (``["calls"]``)."""
    original, count = getattr(owner, name), {"calls": 0}

    def counting(*args, **kw):
        count["calls"] += 1
        return original(*args, **kw)

    setattr(owner, name, counting)
    try:
        yield count
    finally:
        setattr(owner, name, original)


def _lanes_against_in_turn(model, loss, vecs):
    """One warm evaluation of the lanes ``vecs`` of ``loss`` (a MeshLoss)
    batched (``fit.LaneLoss``, its lanes form), in turn (``_InTurn``) and
    one lane alone. Returns (their (values [R], gradients [R, n]), each
    one's K1 and K2 launches, all-reduces and lanes-form calls)."""
    from oak_tpu_torch.optim import fit
    from oak_tpu_torch.parallel.mesh import Axis

    evaluations = {"batched": lambda: fit.LaneLoss(model, loss).value_and_grad(vecs),
                   "in turn": lambda: fit.LaneLoss(model, _InTurn(loss)).value_and_grad(vecs),
                   "one lane": lambda: fit.LaneLoss(model, loss).value_and_grad(vecs[:1])}
    counts, got = {}, {}
    with _counted(Axis, "all_reduce") as reduces, \
            _counted(type(loss), "lanes_value_and_grad") as form, profiling.recording():
        for label, fn in evaluations.items():
            fn()
            torch.cuda.synchronize()
            before = (*_launches(), reduces["calls"], form["calls"])
            got[label] = fn()
            torch.cuda.synchronize()
            after = (*_launches(), reduces["calls"], form["calls"])
            counts[label] = [a - b for a, b in zip(after, before)]
    return got, counts


def _lane_errors(got, ref):
    """[the worst lane's relative value error, its gradient error of max
    |g|] of (values [R], gradients [R, n]) against ``ref``."""
    (values, grads), (tv, tg) = ((t.double() for t in pair) for pair in (got, ref))
    return [float(((values - tv).abs() / tv.abs()).max()),
            float(((grads - tg).abs().amax(dim=1) / tg.abs().amax(dim=1)).max())]


def _sharded_multistart(model, mesh2d, X, Y):
    """fit_lbfgs_multistart_sharded of the bench SVGP (a copy of
    ``model``): PAR_MS_STARTS starts over the mesh's restart axis, each
    lane's rows over its data axis, PAR_MS_WARM warm Adam steps and
    PAR_MS_ITERS L-BFGS iterations. Returns (the result, wall seconds)."""
    import torch.distributed as dist

    from oak_tpu_torch.parallel import sharding

    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    res = sharding.fit_lbfgs_multistart_sharded(
        copy.deepcopy(model), mesh2d, X, Y, n_starts=PAR_MS_STARTS, seed=0,
        warm_adam_steps=PAR_MS_WARM, max_iters=PAR_MS_ITERS)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _rank_multistart(models, mesh2d, X, Y):
    """A rank's checks of phase 12's data-sharded multistart, after the
    main path's counts were read. For each model of ``models`` (name ->
    (model, its mesh_loss's data arguments)): one warm evaluation of the
    rank's lanes (PAR_MS_STARTS starts, the rank's rows of the restart
    axis) batched against in turn and one lane (_lanes_against_in_turn),
    gated at LANE_LOSS_TOL / LANE_GRAD_TOL; the GPR's f32 loss cancels in
    its [N, N] Cholesky, so its gates follow phase 12's drift rule: at
    least twice the lanes in turn's error against the same lanes of the
    GPR in float64. Then the SVGP's _sharded_multistart warm, batched and
    with the lanes in turn, wall seconds each. Returns (values for
    rank<R>.npz, numbers for rank<R>.json)."""
    from oak_tpu_torch.optim import fit
    from oak_tpu_torch.optim import multistart as ms
    from oak_tpu_torch.parallel import sharding
    from oak_tpu_torch.parallel.mesh import Axis
    from oak_tpu_torch.params import flatten_trainable

    data, restarts = Axis.of(mesh2d, "data"), Axis.of(mesh2d, "restart")
    checks = {}
    for name, (model, ext) in models.items():
        vecs = ms._make_starts(flatten_trainable(model).detach(), PAR_MS_STARTS, 0.3, 0,
                               True)[restarts.rows(PAR_MS_STARTS)]
        got, counts = _lanes_against_in_turn(
            model, sharding.mesh_loss(model, data, *ext), vecs)
        tols, drift = [LANE_LOSS_TOL, LANE_GRAD_TOL], None
        if name == "gpr":
            gpr64 = build_gpr_model(vecs.device, dtype=torch.float64)
            drift = _lane_errors(got["in turn"], fit.LaneLoss(gpr64, _InTurn(
                sharding.mesh_loss(gpr64, data))).value_and_grad(vecs.double()))
            tols = [max(t, 2 * d) for t, d in zip(tols, drift)]
            del gpr64
        checks[name] = {"errors": _lane_errors(got["batched"], got["in turn"]), "tols": tols,
                        "drift": drift, "counts": counts}
    model = models["svgp"][0]
    _, batched_s = _sharded_multistart(model, mesh2d, X, Y)
    make = sharding.mesh_loss
    sharding.mesh_loss = lambda *a, **kw: _InTurn(make(*a, **kw))
    try:
        turn, turn_s = _sharded_multistart(model, mesh2d, X, Y)
    finally:
        sharding.mesh_loss = make
    out = {"ms_turn_fun": turn.fun, "ms_turn_lanes": turn.losses.numpy()}
    info = {"lanes": vecs.shape[0], "mesh": list(mesh2d.mesh.shape), "checks": checks,
            "fit_s": [batched_s, turn_s]}
    return out, info


def parallel_rank(rank, world, folder, backend):
    """One rank of a phase-12 job, on cuda:0: the multi-device main path
    through the user's entry points (make_mesh, data_parallel_elbo_step,
    sharded_predict_f, compute_sobol_oak(mesh=), fit_lbfgs_sharded, at
    worlds 2 and 4 the bench SVGP's fit_lbfgs_multistart_sharded on a
    (restart, data) mesh of 4 and 2 lanes a rank (_sharded_multistart), the
    GPR's sharded Sobol, oak_model.optimise_minibatch(mesh=) and
    get_sobol(mesh=) at worlds 1 and 2), its kernel launches counted in a
    recording session of its own (utils.profiling) around it; then the
    multistart's checks (_rank_multistart: the SVGP's, the SGPR's and at
    world 2 the GPR's lanes batched against in turn, the fit timed batched
    and in turn). Writes rank<R>.npz (values) and rank<R>.json (times, launches,
    memory, the build)."""
    import os

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    folder = Path(folder)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # the ranks share the host
    dist.init_process_group(backend, init_method=f"file://{folder / 'store'}", rank=rank,
                            world_size=world)
    info = {"rank": rank, "world": world, "backend": backend}
    from oak_tpu_torch import _build

    if os.environ.get("OAK_TPU_TORCH_BUILD_DIR"):
        dist.barrier()  # every rank reaches the empty build directory at once
        t0 = time.perf_counter()
        b = _build.build()
        _build.library()
        info["build"] = {"path": str(b.path), "compiled_s": b.seconds,
                         "wall_s": time.perf_counter() - t0}
    from oak_tpu_torch import sobol as sb
    from oak_tpu_torch.optim.fit import value_and_grad
    from oak_tpu_torch.parallel import (data_parallel_elbo_step, fit_lbfgs_sharded, make_mesh,
                                        shard_batch, sharded_predict_f)
    from oak_tpu_torch.parallel.mesh import Axis
    from oak_tpu_torch.parallel.sharding import mesh_loss
    from oak_tpu_torch.params import flatten_trainable

    mesh = make_mesh()
    model, Xh = build_model(device)
    X, Y = (torch.as_tensor(a, device=device) for a in (Xh, _bench_y()))
    sgpr, gpr = build_sgpr_model(device), build_gpr_model(device)
    heart = _heart(device) if world <= 2 else None
    mesh2d = (init_device_mesh("cpu", PAR_MS_MESH[world], mesh_dim_names=("restart", "data"))
              if world in PAR_MS_MESH else None)
    out, ms = {}, {}

    def sync():
        torch.cuda.synchronize()
        dist.barrier()

    sync()
    with profiling.recording():
        t_path = time.perf_counter()
        out["loss"], out["grad"] = value_and_grad(
            model, mesh_loss(model, Axis.of(mesh, "data"), X, Y),
            flatten_trainable(model).detach())
        step, (vec, opt_state, _) = data_parallel_elbo_step(model, mesh, learning_rate=1e-2)
        Xs, Ys = shard_batch(mesh, X, Y)
        vec, opt_state, _ = step(vec, opt_state, Xs, Ys)
        sync()
        t0 = time.perf_counter()
        for _ in range(PAR_STEPS):
            vec, opt_state, loss = step(vec, opt_state, Xs, Ys)
        sync()
        ms["step"] = 1e3 * (time.perf_counter() - t0) / PAR_STEPS
        predict = sharded_predict_f(model, mesh)
        predict(Xh)
        sync()
        t0 = time.perf_counter()
        out["mean"], out["var"] = (t.cpu() for t in predict(Xh))
        ms["predict"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        out["svgp_sobol"] = _normalised(sb.compute_sobol_oak(model, mesh=mesh)[1])
        ms["sobol"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        out["lbfgs_fun"] = fit_lbfgs_sharded(sgpr, mesh, max_iters=PAR_LBFGS_ITERS).fun
        ms["lbfgs"] = 1e3 * (time.perf_counter() - t0)
        if mesh2d is not None:
            res, seconds = _sharded_multistart(model, mesh2d, X, Y)
            out["ms_fun"], out["ms_lanes"] = res.fun, res.losses.numpy()
            ms["multistart"] = 1e3 * seconds
        sync()
        t0 = time.perf_counter()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out["gpr_sobol"] = _normalised(sb.compute_sobol_oak(gpr, mesh=mesh)[1])
        info["gpr_sobol_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        torch.cuda.reset_peak_memory_stats()
        out["gpr_by_order"] = _normalised(sb.compute_sobol_by_order(gpr, mesh=mesh))
        info["gpr_by_order_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
        ms["gpr_sobol"] = 1e3 * (time.perf_counter() - t0)
        if heart is not None:
            t0 = time.perf_counter()
            out["heart_sobol"] = heart.get_sobol(mesh=mesh)
            out["heart_fun"] = heart.optimise_minibatch(batch_size=PAR_MB_BATCH,
                                                        steps=PAR_MB_STEPS, seed=0, mesh=mesh).fun
            out["heart_trained_sobol"] = heart.get_sobol(mesh=mesh)
            ms["heart"] = 1e3 * (time.perf_counter() - t0)
        sync()
        info["path_s"] = time.perf_counter() - t_path
        info["launches"] = dict(zip(("fwd", "bwd"), _launches()))
    info["ms"] = ms
    if mesh2d is not None:  # checks of the main path's multistart, uncounted
        models = {"svgp": (model, (X, Y)), "sgpr": (sgpr, ())}
        if world == 2:
            models["gpr"] = (gpr, ())
        ms_out, info["multistart"] = _rank_multistart(models, mesh2d, X, Y)
        out.update(ms_out)
    np.savez(folder / f"rank{rank}.npz", **{k: np.asarray(v.detach().cpu() if isinstance(
        v, torch.Tensor) else v, np.float64) for k, v in out.items()})
    (folder / f"rank{rank}.json").write_text(json.dumps(info))
    dist.barrier()
    dist.destroy_process_group()


def _run_job(world, backend, folder, cold_build=None):
    """Start the ranks of one job, wait for all of them within the time
    limit, and kill every rank if one fails or the limit passes."""
    import os

    env = dict(os.environ, LOCAL_RANK="0", PYTHONUNBUFFERED="1")
    if cold_build is not None:
        env["OAK_TPU_TORCH_BUILD_DIR"] = str(cold_build)
    logs = [open(folder / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--parallel-rank",
                               str(r), str(world), str(folder), backend],
                              stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO)
             for r, log in enumerate(logs)]
    try:
        deadline = time.monotonic() + PAR_JOB_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = "\n".join(f"rank {r} (exit {p.returncode}):\n"
                          + (folder / f"rank{r}.log").read_text()[-2500:]
                          for r, p in enumerate(procs))
        raise RuntimeError(f"phase 12: the {world}-rank {backend} job failed or passed its "
                           f"{PAR_JOB_TIMEOUT_S} s limit:\n{tails}")
    results, infos = [], []
    for r in range(world):
        with np.load(folder / f"rank{r}.npz") as f:
            results.append({k: f[k] for k in f.files})
        infos.append(json.loads((folder / f"rank{r}.json").read_text()))
    return results, infos


def _parallel_gates(world, backend, res, infos, ref):
    """Hold rank 0 against the single-process references (and every rank
    against rank 0); returns (the gates missed, the phase line's
    findings)."""
    r0 = res[0]
    for r, other in enumerate(res[1:], 1):
        for k in ("loss", "grad", "mean", "svgp_sobol", "lbfgs_fun") + (
                ("ms_fun", "ms_lanes", "ms_turn_lanes") if "ms_fun" in r0 else ()):
            if not np.array_equal(other[k], r0[k]):
                raise RuntimeError(f"phase 12 world {world}: rank {r}'s {k} differs from rank 0's")
    g_ref = ref["grad"].double().cpu().numpy()
    errs = {
        "loss": abs(float(r0["loss"]) - float(ref["loss"])) / abs(float(ref["loss"])),
        "grad": float(np.abs(r0["grad"] - g_ref).max() / np.abs(g_ref).max()),
        "predict": max(rel_err(r0["mean"], ref["mean"].double().numpy()),
                       rel_err(r0["var"], ref["var"].double().numpy())),
        "svgp_sobol": float(np.abs(r0["svgp_sobol"] - ref["svgp_sobol"]).max()),
        "gpr_sobol": float(np.abs(r0["gpr_sobol"] - ref["gpr_sobol"]).max()),
        "gpr_by_order": float(np.abs(r0["gpr_by_order"] - ref["gpr_by_order"]).max()),
        "lbfgs": abs(float(r0["lbfgs_fun"]) - ref["lbfgs_fun"]) / abs(ref["lbfgs_fun"])}
    tols = {"loss": PAR_LOSS_TOL, "grad": PAR_GRAD_TOL, "predict": PAR_PRED_TOL,
            "svgp_sobol": PAR_SOBOL_TOL, "gpr_sobol": PAR_SOBOL_TOL,
            "gpr_by_order": max(PAR_SOBOL_TOL, 2 * ref["gpr_by_order_drift"]),
            "lbfgs": PAR_FIT_TOL}
    if "ms_fun" in r0:
        errs["multistart"] = abs(float(r0["ms_fun"]) - ref["ms_fun"]) / abs(ref["ms_fun"])
        tols["multistart"] = PAR_FIT_TOL
    if "heart_sobol" in r0:
        errs["heart_sobol"] = float(np.abs(r0["heart_sobol"] - ref["heart_sobol"]).max())
        errs["heart_minibatch"] = (abs(float(r0["heart_fun"]) - ref["heart_fun"])
                                   / abs(ref["heart_fun"]))
        tols["heart_sobol"], tols["heart_minibatch"] = PAR_SOBOL_TOL, PAR_FIT_TOL
        if not np.isfinite(r0["heart_trained_sobol"]).all():
            raise RuntimeError(f"phase 12 world {world}: heart's trained Sobol not finite")
    bad = [k for k, v in errs.items() if not v < tols[k]]
    return bad, ", ".join(f"{k} {v:.2e} (tol {tols[k]:.3g})" for k, v in errs.items())


def _multistart_line(job, world, res, infos, card):
    """Phase 12's data-sharded multistart at one world: the gates (for each
    model, every rank's batched evaluation within its gates of the lanes
    in turn (_rank_multistart), K1 and K2 once per gram as one
    lane's evaluation, 2 all-reduces batched against 2R in turn, the lanes
    form taken; the same best lane on every rank, checked in
    _parallel_gates) and the line."""
    ranks = [i["multistart"] for i in infos]
    m0, R = ranks[0], ranks[0]["lanes"]
    for r, m in enumerate(ranks):
        for name, check in m["checks"].items():
            (bf, bb, b_red, b_form), (tf, tb, t_red, _), (of, ob, o_red, _) = (
                check["counts"][k] for k in ("batched", "in turn", "one lane"))
            (v_err, g_err), (v_tol, g_tol) = check["errors"], check["tols"]
            if not (v_err < v_tol and g_err < g_tol):
                raise RuntimeError(f"phase 12 world {world} rank {r} {name}: batched vs in "
                                   f"turn, value {v_err:.2e} (tol {v_tol:.3g}), gradient "
                                   f"{g_err:.2e} (tol {g_tol:.3g}); in turn vs float64 "
                                   f"{check['drift']}")
            if ((bf, bb) != (of, ob) or 0 in (of, ob) or (tf, tb) != (R * of, R * ob)
                    or (b_red, o_red, t_red, b_form) != (2, 2, 2 * R, 1)):
                raise RuntimeError(f"phase 12 world {world} rank {r} {name}: launches K1, K2 "
                                   f"and all-reduces {check['counts']} for {R} lanes")
    lanes = res[0]["ms_lanes"]
    turn = res[0]["ms_turn_lanes"]
    fit_s = np.array([m["fit_s"] for m in ranks])

    def check_text(name):
        counts, tols, drift = (m0["checks"][name][k] for k in ("counts", "tols", "drift"))
        return (f"worst rank value "
                f"{max(m['checks'][name]['errors'][0] for m in ranks):.2e}, gradient "
                f"{max(m['checks'][name]['errors'][1] for m in ranks):.2e} of max |g|"
                + ("" if drift is None else
                   f" (tol {tols[0]:.3g}, {tols[1]:.3g}: twice the lanes in turn's error "
                   f"against float64, value {drift[0]:.2e}, gradient {drift[1]:.2e})")
                + ", K1, K2 "
                f"{counts['batched'][:2]} batched, {counts['in turn'][:2]} in turn, "
                f"{counts['one lane'][:2]} one lane, all-reduces {counts['batched'][2]} vs "
                f"{counts['in turn'][2]}")

    return (
        f"phase 12.{job}m world {world}, {R} lanes a rank on a {m0['mesh'][0]}x"
        f"{m0['mesh'][1]} (restart x data) mesh [{card}]: a warm evaluation batched vs in "
        f"turn (tol value {LANE_LOSS_TOL}, gradient {LANE_GRAD_TOL} unless stated), per "
        f"evaluation: "
        f"bench SVGP (N {N}, D {D}, M {M}) "
        + check_text("svgp") + "; phase 6's SGPR " + check_text("sgpr")
        + ("; phase 7's GPR " + check_text("gpr") if "gpr" in m0["checks"] else "")
        + "; fit_lbfgs_multistart_sharded("
        f"n_starts={PAR_MS_STARTS}, warm_adam_steps={PAR_MS_WARM}, max_iters={PAR_MS_ITERS}) "
        f"warm, batched {fit_s[0, 0]:.3f} s rank 0 / {fit_s[:, 0].max():.3f} s max over "
        f"ranks, in turn {fit_s[0, 1]:.3f} / {fit_s[:, 1].max():.3f} s "
        f"({fit_s[:, 1].max() / fit_s[:, 0].max():.2f}x); the main path's best lane "
        f"{int(np.argmin(lanes))} loss {float(res[0]['ms_fun']):.8g} on every rank (lanes "
        + ", ".join(f"{v:.8g}" for v in lanes) + f"; in turn lane "
        f"{int(np.argmin(turn))} {float(res[0]['ms_turn_fun']):.8g})")


def phase_parallel(device):
    """Phase 12, the multi-device layer on one card.

    The references come first, in this process on the same card (float32):
    the bench SVGP's (config 5: N 8192, D 32, M 512, depth 3, seeded
    parameters) loss and gradient at the start, PAR_STEPS Adam steps timed,
    predict_f over its 8192 rows, its full Sobol, a PAR_MS_STARTS-start
    multistart (PAR_MS_WARM warm Adam steps, PAR_MS_ITERS L-BFGS
    iterations); phase 6's SGPR after PAR_LBFGS_ITERS L-BFGS iterations;
    phase 7's GPR (N 8192, D 8, depth 2) Sobol values and
    per-order totals with their peak memory; oak_tpu's committed heart fold 0
    (a Bernoulli SVGP) Sobol, then PAR_MB_STEPS minibatch steps. The GPR's
    per-order totals cancel in float32, so their gate is twice their
    float32 error against float64 (at least 1e-5), phase 2's drift rule.
    Then three jobs, one after another, each rank a process on cuda:0 (parallel_rank):
    world 1 on NCCL, world 2 on gloo (whose two ranks first build the
    kernels at once into an empty directory: one compiles, the other waits
    on the file lock and loads the same library), world 4 on gloo. Worlds 2
    and 4 also run the bench SVGP's data-sharded multistart on a 1 x 2 and a
    2 x 2 (restart x data) mesh, 4 and 2 lanes a rank, and after the main
    path's counts were read its checks (_rank_multistart): a rank's lanes
    of the bench SVGP, phase 6's SGPR and, at world 2, phase 7's GPR in one
    batched evaluation against the same lanes in turn (LANE_LOSS_TOL /
    LANE_GRAD_TOL; the GPR's by the drift rule against float64), K1 and K2
    once per gram, 2 all-reduces against 2R,
    then the SVGP's fit batched and in turn, timed (_multistart_line).
    Each job's ranks are joined within PAR_JOB_TIMEOUT_S, and a rank's
    failure fails the phase. Gates, rank 0
    against the references (every rank holds rank 0's bits, the
    multistart's best lane and every lane's loss too): loss 1e-5
    relative, gradient 1e-4 of max |g|, predictions 1e-5 of max |value|,
    normalised Sobol 1e-5, the fits' final losses 1e-3 relative. Then K1
    and K2 against their plain versions at the 2-rank shard's Kus
    (512 x 4096), after the counts were read.

    Returns the K1 and K2 launches summed over every rank of every job."""
    from oak_tpu_torch.ops import oak_gram as og

    t0 = time.perf_counter()
    ref, ref_ms = _parallel_references(device)
    ref_s = time.perf_counter() - t0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]
    launches = {"fwd": 0, "bwd": 0}
    lines, failed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for job, (world, backend) in enumerate(PAR_JOBS, start=1):
            folder = Path(tmp) / f"world{world}"
            folder.mkdir()
            cold = Path(tmp) / "cold_build" if world == 2 else None
            t_job = time.perf_counter()
            res, infos = _run_job(world, backend, folder, cold)
            job_s = time.perf_counter() - t_job
            missed, gates = _parallel_gates(world, backend, res, infos, ref)
            failed += [f"world {world}: {k}" for k in missed]
            for info in infos:
                for k in launches:
                    launches[k] += info["launches"][k]
            if min(i["launches"]["fwd"] for i in infos) == 0 or min(
                    i["launches"]["bwd"] for i in infos) == 0:
                raise RuntimeError(f"phase 12 world {world}: a rank launched no K1 or no K2")
            build = ""
            if cold is not None:
                builds = [i["build"] for i in infos]
                compiled = [b["compiled_s"] > 0 for b in builds]
                if len({b["path"] for b in builds}) != 1 or sorted(compiled) != [False, True]:
                    raise RuntimeError(f"phase 12: the cold build from 2 ranks: {builds}")
                build = (f"; cold build from 2 ranks at once: one compiled in "
                         f"{max(b['compiled_s'] for b in builds):.1f} s, the other waited "
                         f"{min(b['wall_s'] for b in builds if b['compiled_s'] == 0):.1f} s "
                         f"on the lock and loaded the same library")
            m0 = infos[0]["ms"]
            lines.append(
                f"phase 12.{job} world {world} ({backend}, {job_s:.1f} s, main path "
                f"{infos[0]['path_s']:.1f} s): {gates}; data-parallel Adam step "
                f"{m0['step']:.1f} ms, sharded predict_f of {N} rows {m0['predict']:.1f} ms, "
                f"sharded Sobol {m0['sobol']:.1f} ms, fit_lbfgs_sharded {PAR_LBFGS_ITERS} "
                f"iterations {m0['lbfgs']:.0f} ms"
                + (f", data-sharded multistart {m0['multistart']:.0f} ms"
                   if "multistart" in m0 else "")
                + f", GPR Sobol and per-order totals {m0['gpr_sobol']:.0f} ms"
                + (f", heart Sobol, {PAR_MB_STEPS} minibatch steps and Sobol {m0['heart']:.0f} ms"
                   if "heart" in m0 else "")
                + f"; GPR Sobol peak per rank {max(i['gpr_sobol_peak_gb'] for i in infos):.3f} "
                f"GB, per-order totals {max(i['gpr_by_order_peak_gb'] for i in infos):.3f} GB; "
                f"launches K1 {sum(i['launches']['fwd'] for i in infos)}, K2 "
                f"{sum(i['launches']['bwd'] for i in infos)}{build}")
            if "multistart" in infos[0]:
                lines.append(_multistart_line(job, world, res, infos, card))
    print(f"phase 12.0 single-process references on the card ({ref_s:.1f} s): Adam step "
          f"{ref_ms['step']:.1f} ms, predict_f of {N} rows {ref_ms['predict']:.1f} ms, Sobol "
          f"{ref_ms['sobol']:.1f} ms, the bench SVGP's {PAR_MS_STARTS}-start multistart "
          f"{ref_ms['multistart']:.0f} ms; GPR Sobol peak {ref_ms['gpr_sobol_peak_gb']:.3f} GB, "
          f"per-order totals {ref_ms['gpr_by_order_peak_gb']:.3f} GB, their float32 error "
          f"against float64 {ref['gpr_by_order_drift']:.2e} (twice it, at least "
          f"{PAR_SOBOL_TOL}, is their gate)")
    print("\n".join(lines))
    if failed:
        raise RuntimeError(f"phase 12 over its gates: {', '.join(failed)}")

    model, Xh = build_model(device)
    with torch.no_grad():
        X = torch.as_tensor(Xh[:N // 2], device=device)
        args = tuple(t.detach().contiguous() for t in og._prep(
            model.kernel, model.Z.value, X)) + (DEPTH,)
    name = f"Kus {M}x{N // 2}"
    _, text = _kernels_at(name, args, device)
    print(f"phase 12.4 kernels at the 2-rank shard's {name}, depth {DEPTH}, vs plain: "
          + "; ".join(text[:2]) + "\n" + "\n".join(text[2:]))
    return launches


# --------------------------------------------------------------------------- #
# Phase 13: the grouped per-dim evaluation
# --------------------------------------------------------------------------- #
def _per_dim_prep(oak, X, X2):
    """ops.oak_gram._prep as a per-dim loop: each constituent kernel's
    closed forms on its own column, one call per dim (shared variances)."""
    from oak_tpu_torch.kernels import ortho_rbf
    from oak_tpu_torch.kernels.oak_kernel import UnconstrainedRBF, kernel_K
    from oak_tpu_torch.kernels.ortho_rbf import OrthogonalRBF
    from oak_tpu_torch.ops import oak_gram as og

    rbf, extras = [], []
    for k in oak.kernels:
        col1, col2 = X[:, k.active_dim], X2[:, k.active_dim]
        if not isinstance(k, (OrthogonalRBF, UnconstrainedRBF)):
            extras.append(kernel_K(k, col1, col2))
            continue
        ls2 = k.lengthscale.value * og._SQRT2
        c1, c2 = torch.zeros_like(col1), torch.zeros_like(col2)
        if isinstance(k, OrthogonalRBF):
            rs = torch.rsqrt(torch.clamp_min(ortho_rbf.var_s(k), og._RSQRT_FLOOR))
            c1, c2 = ortho_rbf.cov_x_s(k, col1) * rs, ortho_rbf.cov_x_s(k, col2) * rs
        logb = torch.log(torch.clamp_min(k.variance.value.reshape(()), og._VARIANCE_FLOOR))
        rbf.append((col1 / ls2, col2 / ls2, c1, c2, logb))
    u1, u2, c1, c2, logb = (torch.stack(t) for t in zip(*rbf))
    extra = torch.stack(extras) if extras else X.new_zeros((0, X.shape[0], X2.shape[0]))
    sig2 = torch.stack([v.value.reshape(()) for v in oak.variances])
    return u1, u2, c1, c2, extra, logb, sig2


def _per_dim_group(kernels, X, fn, X2=None, dim_elements=0):
    """kernels.per_group as a per-dim loop: fn on each kernel and its own
    column, its result given a group axis of one."""
    for i, k in enumerate(kernels):
        cols = [X[:, k.active_dim]] + ([] if X2 is None else [X2[:, k.active_dim]])
        out = fn(k, *cols)
        yield [i], (tuple(t[None] for t in out) if isinstance(out, tuple) else out[None])


@contextlib.contextmanager
def _per_dim_route():
    """Within the block every grouped evaluation of the per-dim forms (the
    gram's prescale, K's and K_diag's power sums, Sobol's L and factor
    stacks) runs the per-dim loop instead."""
    from oak_tpu_torch import sobol as sb
    from oak_tpu_torch.kernels import oak_kernel as ok
    from oak_tpu_torch.ops import oak_gram as og

    saved = og._prep, ok.per_group, sb.per_group
    og._prep, ok.per_group, sb.per_group = _per_dim_prep, _per_dim_group, _per_dim_group
    try:
        yield
    finally:
        og._prep, ok.per_group, sb.per_group = saved


def _peak_gb(fn):
    """Peak device memory fn allocates above what was allocated before, GB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def _held(name, grouped, per_dim, f64, tols):
    """The grouped route's tensors against the per-dim loop's, each within
    its ``tols`` entry of max |per-dim|, or, where float32 itself drifts,
    within twice the per-dim loop's error against ``f64()``
    (testing.kernel_error). Returns the largest error."""
    from oak_tpu_torch.testing import kernel_error

    worst, ref64 = 0.0, None
    for i, (g, p, tol) in enumerate(zip(grouped, per_dim, tols)):
        if g.shape != p.shape or not torch.isfinite(g).all():
            raise RuntimeError(f"{name}[{i}]: shape {tuple(g.shape)} vs {tuple(p.shape)}, or "
                               "non-finite")
        if not p.numel():
            continue
        err = float((g - p).abs().max()) / max(float(p.abs().max()), 1e-30)
        if not err < tol:
            ref64 = f64() if ref64 is None else ref64
            ok, err, text = kernel_error(g, p, ref64[i], tol)
            if not ok:
                raise RuntimeError(f"{name}[{i}] grouped vs per-dim: {text} (tol {tol})")
        worst = max(worst, err)
    return worst


@_recorded
def phase_grouped(device):
    """Phase 13, the grouped evaluation of the per-dim forms at the bench
    SVGP's full width (N 8192, D 32, M 512, depth 3, float32, one group of
    32 OrthogonalRBF dims; phase 3's seeded parameters).

    13.1 grouped against the per-dim loop (_per_dim_route): _prep(Z, X),
    K_diag(X), the training loss and its gradient, and the full Sobol,
    within KERNEL_TOL (forward) or GRAD_TOL (gradient) of max |per-dim|, or
    twice the per-dim loop's own error against float64; the launches of
    one _prep and one K_diag at D 8 and D 32, which must be equal.
    13.2 kernel launches and device ms (benchmark/devtrace.py) of a warm
    predict_y of 1 and 8192 rows and a full Sobol, paths no cell of the
    benchmark times. Returns the phase's K1 and K2 launches."""
    from oak_tpu_torch import sobol as sb
    from oak_tpu_torch.kernels import stackable_groups
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.optim import fit
    from oak_tpu_torch.params import flatten_trainable

    model, Xh = build_model(device)
    X, Y = (torch.as_tensor(a, device=device) for a in (Xh, _bench_y()))
    if stackable_groups(model.kernel.kernels) != [list(range(D))]:
        raise RuntimeError("the bench kernel is not one group of its dims")
    model64 = copy.deepcopy(model).to(dtype=torch.float64)

    @torch.no_grad()
    def prep(m):
        return list(og._prep(m.kernel, m.Z.value, X.to(m.Z.value.dtype)))

    @torch.no_grad()
    def k_diag(m):
        return [m.kernel.K_diag(X.to(m.Z.value.dtype))]

    def loss_grad(m):
        x, y = (t.to(m.Z.value.dtype) for t in (X, Y))
        loss, g = fit.value_and_grad(m, lambda mm: mm.training_loss(x, y),
                                     flatten_trainable(m).detach())
        return [loss.detach().reshape(1), g]

    def sobol(m):
        return [torch.as_tensor(sb.compute_sobol_oak(m)[1], device=device)]

    t0 = time.perf_counter()
    errs = {}
    for name, fn, tols in (("_prep(Z, X)", prep, [KERNEL_TOL] * 7),
                           ("K_diag(X)", k_diag, [KERNEL_TOL]),
                           ("loss, gradient", loss_grad, [KERNEL_TOL, GRAD_TOL]),
                           ("Sobol", sobol, [KERNEL_TOL])):
        grouped = [t.detach() for t in fn(model)]
        with _per_dim_route():
            per_dim = [t.detach() for t in fn(model)]
        errs[name] = _held(name, grouped, per_dim,
                           lambda: [t.detach() for t in fn(model64)], tols)
    counts = {}
    for d in (8, D):
        kern = bench_kernel(device, torch.float32, d, DEPTH)
        Xd, Zd = X[:, :d].contiguous(), model.Z.value.detach()[:, :d].contiguous()
        with torch.no_grad():
            counts[d] = (_traced(lambda: og._prep(kern, Zd, Xd)).launches,
                         _traced(lambda: kern.K_diag(Xd)).launches)
    if counts[8] != counts[D]:
        raise RuntimeError(f"launches of one _prep, K_diag: {counts[8]} at D 8, "
                           f"{counts[D]} at D {D}")
    print(f"phase 13.1 grouped vs per-dim loop at N {N}, D {D}, M {M}, depth {DEPTH} "
          f"({time.perf_counter() - t0:.1f} s): largest error "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {KERNEL_TOL}, gradient {GRAD_TOL}, of max |per-dim|); launches of one "
          f"_prep / K_diag: D 8 {counts[8][0]} / {counts[8][1]}, D {D} {counts[D][0]} / "
          f"{counts[D][1]}")

    calls = {"predict_y 1 row": lambda: model.predict_y(X[:1]),
             f"predict_y {N} rows": lambda: model.predict_y(X),
             "full Sobol": lambda: sb.compute_sobol_oak(model)}
    lines = []
    for name, fn in calls.items():
        with torch.no_grad():
            trace = _traced(fn)
        lines.append(f"phase 13.2 {name}: {trace.launches} kernel launches, device "
                     f"{1e3 * trace.busy_s:.3f} ms")
    print("\n".join(lines))
    return dict(zip(("fwd", "bwd"), _launches()))


LANES = 4  # phase 14's lanes, as every UCI configuration's restarts
# (name, D, N, M, E, depth): phase 9's pumadyn Kuf and the bench's Kuf
LANE_SHAPES = (("pumadyn Kuf 500x6553", PUMA_D, PUMA_M, 6553, 0, PUMA_DEPTH),
               ("bench Kuf 512x8192", D, M, N, 0, DEPTH))
LANE_LOSS_TOL, LANE_GRAD_TOL = 1e-4, 1e-3  # batched vs in turn: value, gradient
LANE_ADAM_TOL, LANE_BEST_TOL = 1e-4, 1e-3  # 14.3: warm Adam steps, the best lane


def _lane_kernels(name, D_, N_, M_, E_, depth, device, seed):
    """14.1 at one shape: K1 and K2 launched once for LANES lanes (through
    the ops' vmap rules) against a one-lane launch of each lane (bitwise
    where the lane-batched launch picks the same tile, else the kernel
    gates) and against the plain version; device ms of the batched launch,
    of the LANES one-lane launches and of the plain version over the lanes,
    the bound (LANES times one lane's) and the share."""
    from oak_tpu_torch.ops import oak_gram as og
    from oak_tpu_torch.testing import kernel_error, lane_inputs

    inputs = lane_inputs(seed, LANES, D_, N_, M_, E_, depth, device)
    gbar = torch.as_tensor(np.random.default_rng(seed).normal(size=(LANES, N_, M_)),
                           dtype=torch.float32, device=device)
    lane = [[t[r] for t in inputs] for r in range(LANES)]
    P = og.clamped_depth(depth, D_, E_)
    fwd = torch.vmap(og.oak_gram_fwd_op, in_dims=(0,) * 7 + (None,))
    bwd = torch.vmap(lambda *a: og.oak_gram_bwd_op(*a, depth, True), in_dims=(0,) * 8)
    before = _launches()
    with torch.no_grad():
        out = fwd(*inputs, depth)
        grads = bwd(*inputs, gbar)
    torch.cuda.synchronize()
    launched = tuple(a - b for a, b in zip(_launches(), before))
    if launched != (1, 1):
        raise RuntimeError(f"14.1 {name}: {launched[0]} K1 and {launched[1]} K2 launches for "
                           f"{LANES} lanes")
    numbers, text = {}, []
    for kind, entry in (("K1", "oak_gram_fwd_tile"), ("K2", "oak_gram_bwd_tile")):
        same = og._variant(entry, P, N_, M_, device, LANES) == og._variant(entry, P, N_, M_,
                                                                             device)
        err, bitwise = 0.0, same
        for r in range(LANES):
            with torch.no_grad():
                if kind == "K1":
                    ours, single = [out[r]], [og.oak_gram_fused(*lane[r], depth)]
                    plain = [og.oak_gram_plain(*lane[r], depth)]
                    plain64 = [og.oak_gram_plain(*[t.double() for t in lane[r]], depth)]
                    tols = [KERNEL_TOL]
                else:
                    ours = [g[r] for g in grads]
                    single = og.oak_gram_bwd(*lane[r], gbar[r], depth)
                    plain = og.oak_gram_bwd_plain(*lane[r], gbar[r], depth)
                    plain64 = og.oak_gram_bwd_plain(*[t.double() for t in lane[r]],
                                                    gbar[r].double(), depth)
                    tols = [GRAD_TOL] * 7
            for k, (o, s, p, p64, tol) in enumerate(zip(ours, single, plain, plain64, tols)):
                if p.numel() == 0:
                    continue
                if same and not torch.equal(o, s):
                    raise RuntimeError(f"14.1 {name} {kind} lane {r} [{k}]: the lane-batched "
                                       "launch differs from a one-lane launch of its tile")
                for ref in ([s, p] if not same else [p]):
                    ok, _, line = kernel_error(o, ref, p64, tol)
                    if not (ok and bool(torch.isfinite(o).all())):
                        raise RuntimeError(f"14.1 {name} {kind} lane {r} [{k}]: {line} over "
                                           f"tol {tol}")
                err = max(err, float((o - p).abs().max()))
        batched = ((lambda: fwd(*inputs, depth)) if kind == "K1"
                   else (lambda: bwd(*inputs, gbar)))
        one_lane = [(lambda r=r: og.oak_gram_fused(*lane[r], depth)) if kind == "K1" else
                    (lambda r=r: og.oak_gram_bwd(*lane[r], gbar[r], depth))
                    for r in range(LANES)]
        plain_fn = ((lambda: og.oak_gram_plain(*inputs, depth)) if kind == "K1"
                    else (lambda: og.oak_gram_bwd_plain(*inputs, gbar, depth)))
        with torch.no_grad():
            # the one-lane launches' sum, each timed alone (the profiler has
            # dropped events of a call that launches several)
            dev = {"plain": [], "lanes in turn": [], "batched": []}
            for which in list(dev) + list(dev)[::-1]:
                dev[which].append(sum(_busy_ms(f) for f in one_lane)
                                  if which == "lanes in turn"
                                  else _busy_ms(batched if which == "batched" else plain_fn))
        work = _gram_work(kind, D_, N_, M_, E_, depth, LANES)
        bound = 1e3 * work.bound_s()
        ms, singles_ms = float(np.mean(dev["batched"])), float(np.mean(dev["lanes in turn"]))
        numbers[kind] = dict(max_abs_err=err, device_ms=ms, lanes_in_turn_ms=singles_ms,
                             plain_ms=float(np.mean(dev["plain"])), bound_ms=bound,
                             bound_by=work.limiter(), share=bound / ms, same_tile=same,
                             lanes=LANES)
        text.append(f"  {kind} {name} x{LANES} lanes: device {dev['batched']} ms batched vs "
                    f"{dev['lanes in turn']} ms for {LANES} one-lane launches, plain over the "
                    f"lanes {dev['plain']} ms; {_bound_text(work)}; share {bound / ms:.2f}; "
                    f"max abs err vs plain {err:.2e}; "
                    + ("each lane bitwise equal to a one-lane launch" if bitwise else
                       "the one-lane launch takes another tile: lanes held to it by the gates"))
    return numbers, text


def _in_turn_best(model, loss_fn, starts):
    """The reference of 14.3, the lanes in turn, each alone, through the
    package's one-lane pieces (plain autograd, ``fit.lbfgs_parts``): 300
    warm Adam steps at 2e-2 keeping the best finite iterate, then
    PUMA_ITERS L-BFGS iterations; (vectors, each lane's losses at its warm
    Adam steps, final losses, L-BFGS iterations, gradient norms)."""
    from oak_tpu_torch.optim import fit

    one = fit.LaneLoss(model, loss_fn)  # one lane at a time: plain autograd
    vecs, adam_losses, values, its, gnorms = [], [], [], [], []
    for start in starts:
        vec, _, losses = fit.adam_best(one, start[None], 300, 2e-2)
        init, run_range, stats = fit.lbfgs_parts(
            lambda v: fit.value_and_grad(model, loss_fn, v), 1e-8, 30)
        vec, state, it = run_range(vec[0], init(vec[0]), 0, PUMA_ITERS)
        vecs.append(vec)
        adam_losses.append(losses[:, 0])
        values.append(float(one.values(vec[None])[0]) if bool(torch.isfinite(vec).all())
                      else np.inf)
        its.append(it)
        gnorms.append(float(np.sqrt(state.grad_sq[0])))
    return torch.stack(vecs), torch.stack(adam_losses, 1), values, its, gnorms


@_recorded
def phase_lanes(device):
    """Phase 14, a multistart's lanes as one batched program.

    14.1 K1 and K2 launched once for LANES lanes at phase 9's pumadyn Kuf
    (500 x 6553, D 8, depth 8) and the bench's Kuf (512 x 8192, D 32, depth
    3): each lane against a one-lane launch (bitwise where the tile is the
    same) and the plain version; device ms against the one-lane launches',
    the bound and the share.
    14.2 ``fit.LaneLoss`` (vmap of grad_and_value over the trainable vector)
    of the bench SVGP (create defaults) and of the pumadyn SGPR at LANES
    starts from ``_make_starts``, against the lanes one by one (value within
    1e-4 relative, gradient within 1e-3 of max |g|); one K1 and K2 launch
    per gram for all lanes, and no vmap fallback warning.
    14.3 ``oak_model.optimise(max_iters=PUMA_ITERS, restarts=LANES)`` at
    phase 9's configuration, batched, against the same starts in turn
    (``_in_turn_best``): the first 5 warm Adam steps equal lane by lane
    within 1e-4 relative, the best loss within 1e-3 relative of the in-turn
    best or the same lane accepted, test RMSE below std(y); both wall
    times, the step where the float32 warm-up trajectories part, and the
    linesearch's evaluations per lane and iteration. Returns the launches of
    the batched optimise."""
    import warnings

    from oak_tpu_torch import oak_model
    from oak_tpu_torch.optim import fit
    from oak_tpu_torch.optim import multistart as ms
    from oak_tpu_torch.params import flatten_trainable

    t0 = time.perf_counter()
    kernels, rows = {}, []
    for seed, shape in enumerate(LANE_SHAPES, start=140):
        kernels[shape[0]], text = _lane_kernels(*shape, device, seed)
        rows.extend(text)
    print(f"phase 14.1 K1 and K2 over {LANES} lanes in one launch "
          f"({time.perf_counter() - t0:.1f} s; device ms, benchmark/devtrace.py, in turns "
          f"plain, one-lane, batched, batched, one-lane, plain):\n" + "\n".join(rows))

    t0 = time.perf_counter()
    Xtr, ytr, Xte, yte = pumadyn_fold0()
    oak = oak_model(max_interaction_depth=PUMA_DEPTH, num_inducing=PUMA_M,
                    lengthscale_bounds=[1e-3, 1e3], use_sparsity_prior=True,
                    use_normalising_flow=True, optimizer="lbfgs")
    oak.fit(Xtr, ytr, optimise=False)
    bmodel, bX, bY = build_bench_model(device)
    losses = {"bench SVGP": (bmodel, lambda m: m.training_loss(bX, bY)),
              "pumadyn SGPR": (oak.m, lambda m: m.training_loss())}
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    lines = []
    try:
        for name, (model, loss_fn) in losses.items():
            starts = ms._make_starts(flatten_trainable(model).detach(), LANES, 0.3, 0, True)
            lane_loss = fit.LaneLoss(model, loss_fn)
            lane_loss.value_and_grad(starts)  # warm
            before = _launches()
            fit.value_and_grad(model, loss_fn, starts[0])
            middle = _launches()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                values, grads = lane_loss.value_and_grad(starts)
                torch.cuda.synchronize()
            one = tuple(a - b for a, b in zip(middle, before))
            batched = tuple(a - b for a, b in zip(_launches(), middle))
            fallback = [str(w.message) for w in caught if "allback" in str(w.message)]
            if batched != one or 0 in one or fallback:
                raise RuntimeError(f"14.2 {name}: K1, K2 launches {batched} for {LANES} lanes "
                                   f"against {one} for one; fallback warnings {fallback[:2]}")
            v_err = g_err = 0.0
            for r in range(LANES):
                v, g = fit.value_and_grad(model, loss_fn, starts[r])
                v_err = max(v_err, abs(float(values[r]) - float(v)) / abs(float(v)))
                g_err = max(g_err, float((grads[r] - g).abs().max() / g.abs().max()))
            if not (v_err < LANE_LOSS_TOL and g_err < LANE_GRAD_TOL):
                raise RuntimeError(f"14.2 {name}: batched vs in turn, value {v_err:.2e} "
                                   f"(tol {LANE_LOSS_TOL}), gradient {g_err:.2e} (tol "
                                   f"{LANE_GRAD_TOL})")
            lines.append(
                f"phase 14.2 {name}: {LANES} lanes batched vs one by one: value {v_err:.2e} "
                f"(tol {LANE_LOSS_TOL}), gradient {g_err:.2e} of max |g| (tol "
                f"{LANE_GRAD_TOL}); K1, K2 launches {batched} per value_and_grad for all "
                f"lanes ({one} for one); no vmap fallback warning")
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    print("\n".join(lines) + f"\nphase 14.2 took {time.perf_counter() - t0:.1f} s")

    # 14.3: the user path batched, then the same starts in turn
    ref = copy.deepcopy(oak.m)
    starts = ms._make_starts(flatten_trainable(oak.m).detach(), LANES, 0.3, 0, True)
    warm, evals, steps = [], [], []
    adam_best, evaluate, lbfgs_step = fit.adam_best, fit._evaluate, fit.lbfgs_step

    def recording_adam_best(*args):
        out = adam_best(*args)
        warm.append(out[2])
        return out

    def recording_evaluate(fn, vec, u, rows, step):
        evals.append(len(rows))
        return evaluate(fn, vec, u, rows, step)

    def recording_step(fn, vec, state):
        steps.append(vec.shape[0])
        return lbfgs_step(fn, vec, state)

    ms.adam_best, fit._evaluate, fit.lbfgs_step = (recording_adam_best, recording_evaluate,
                                                   recording_step)
    before = _launches()
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = oak.optimise(max_iters=PUMA_ITERS, restarts=LANES)
        torch.cuda.synchronize()
        batched_s = time.perf_counter() - t
    finally:
        ms.adam_best, fit._evaluate, fit.lbfgs_step = adam_best, evaluate, lbfgs_step
    launches = dict(zip(("fwd", "bwd"), (a - b for a, b in zip(_launches(), before))))
    lanes = res.losses.numpy()
    rmse = float(np.sqrt(np.mean((oak.predict(Xte, clip=True) - yte[:, 0]) ** 2)))
    std = float(yte.std())

    torch.cuda.synchronize()
    t = time.perf_counter()
    vecs, turn_warm, turn_values, turn_its, turn_gnorms = _in_turn_best(
        ref, lambda m: m.training_loss(), starts)
    pick = copy.deepcopy(ref)
    turn = ms._finish_multistart(
        vecs, turn_values, pick, lambda m: not (oak._degenerate_noise_fit(m)
                                               or oak._pathological_fit(m)),
        "", turn_its, gnorms=turn_gnorms, tol=1e-8)
    torch.cuda.synchronize()
    turn_s = time.perf_counter() - t

    ours = warm[0].double()
    theirs = turn_warm.double()
    rel = ((ours - theirs).abs() / theirs.abs()).cpu().numpy()
    rel = np.where(np.isfinite(rel), rel, 0.0)
    parted = np.flatnonzero((rel > LANE_ADAM_TOL).any(axis=1))
    first5 = float(rel[:5].max())
    best_b, best_t = int(np.argmin(lanes)), int(np.argmin(turn.losses.numpy()))
    best_rel = abs(res.fun - turn.fun) / abs(turn.fun)
    per_iteration = sum(evals) / max(sum(steps), 1)
    print(f"phase 14.3 oak_model.optimise(max_iters={PUMA_ITERS}, restarts={LANES}) at "
          f"phase 9's configuration: batched {batched_s:.3f} s, the same starts in turn "
          f"{turn_s:.3f} s ({turn_s / batched_s:.2f}x); lane losses batched "
          + ", ".join(f"{v:.6g}" for v in lanes) + " / in turn "
          + ", ".join(f"{v:.6g}" for v in turn.losses.numpy())
          + f"; returned {res.fun:.6g} (lane {best_b}) vs {turn.fun:.6g} (lane {best_t}), "
          f"{best_rel:.2e} relative (tol {LANE_BEST_TOL}); first 5 warm Adam steps "
          f"{first5:.2e} relative (tol {LANE_ADAM_TOL}); the float32 warm-up trajectories "
          + (f"part at step {int(parted[0])} of 300 (relative > {LANE_ADAM_TOL})"
             if len(parted) else f"stay within {LANE_ADAM_TOL} for all 300 steps")
          + f"; L-BFGS {sum(steps)} lane-iterations, {sum(evals)} linesearch evaluations "
          f"({per_iteration:.2f} a lane and iteration, so {per_iteration - 1:.2f} rejected), "
          f"{len(evals)} batched calls; test rmse {rmse:.6g} (std {std:.6g}); launches of "
          f"the batched optimise K1 {launches['fwd']}, K2 {launches['bwd']}")
    if not (first5 < LANE_ADAM_TOL and (best_rel < LANE_BEST_TOL or best_b == best_t)
            and rmse < std and np.isfinite(res.fun)):
        raise RuntimeError(f"14.3: first 5 Adam steps {first5:.2e}, best {res.fun} (lane "
                           f"{best_b}) vs {turn.fun} (lane {best_t}), rmse {rmse} (std {std})")
    if 0 in launches.values():
        raise RuntimeError(f"14.3: the batched optimise launched {launches}")
    return launches, kernels, dict(batched_s=batched_s, in_turn_s=turn_s)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parallel-rank", nargs=4, metavar=("RANK", "WORLD", "DIR", "BACKEND"),
                        help="run one rank of a phase-12 job (phase_parallel starts them)")
    parser.add_argument("--compile-served", metavar="DIR",
                        help="compile phase 10.2's packages into DIR (the script starts it)")
    args = parser.parse_args()
    if args.parallel_rank:
        rank, world, folder, backend = args.parallel_rank
        parallel_rank(int(rank), int(world), folder, backend)
        return
    if args.compile_served:
        compile_served(args.compile_served)
        return
    t0 = time.perf_counter()
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    model, X = build_model(device)
    seconds = {"0-1": time.perf_counter() - t0}

    def timed(name, fn, *fn_args):
        t = time.perf_counter()
        out = fn(*fn_args)
        seconds[name] = time.perf_counter() - t
        print(f"phase {name} took {seconds[name]:.1f} s")
        return out

    # phase 10.2's compiles run in a process of their own meanwhile
    compiles = _CompileServed()
    try:
        gpr = build_gpr_model(device)
        kernel = timed("2", phase_kernel, model, X, gpr, device)
        kernel_bwd = timed("2b", phase_kernel_bwd, model, X, gpr, device)
        solve = timed("2c", phase_solve, device)
        del gpr
        predict_launches = timed("3", phase_main_path, model, X, device)
        train_launches, trained, X_train = timed("4", phase_training, device)
        sobol_launches = timed("5", phase_sobol, trained, X_train)
        del trained, X_train
        sgpr_launches = timed("6", phase_sgpr, device)
        gpr_launches = timed("7", phase_gpr, device)
        timed("8", phase_defaults, device)
        oak_launches, oak_kernels = timed("9", phase_oak_model, device)
        committed_launches, triton = timed("10", phase_committed, device, compiles)
        surface_launches = timed("11", phase_surface, device)
        parallel_launches = timed("12", phase_parallel, device)
        grouped_launches = timed("13", phase_grouped, device)
        lanes_launches, lanes_kernels, _ = timed("14", phase_lanes, device)
    finally:
        compiles.close()
    print(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
          f"total {time.perf_counter() - t0:.1f} s")

    def entry(name, source, replaces, launches, numbers, depth8, kind):
        # at Kus / Kuf: device_ms the kernel's device time per launch,
        # plain_ms the plain version's, bound_ms benchmark/roofline.py's; no
        # PyTorch call computes the fused gram. The same numbers at phase 9's
        # depth-8 Kuf under "kuf_depth8", and one launch for phase 14's LANES
        # lanes at its two Kuf shapes under "lanes"
        n = numbers["Kus/Kuf 512x8192"]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": n["max_abs_err"],
                "device_ms": n["device_ms"], "plain_ms": n["plain_ms"],
                "bound_ms": n["bound_ms"], "bound_by": n["bound_by"], "share": n["share"],
                "library_ms": None,
                "kuf_depth8": {k: depth8[k] for k in ("max_abs_err", "device_ms", "plain_ms",
                                                      "bound_ms", "bound_by", "share")},
                "lanes": {shape: lanes_kernels[shape][kind] for shape in lanes_kernels}}

    def triton_entry(launches, n, shapes):
        # the Triton K1 in the compiled packages: launches counted by name in
        # phase 10.2's profiled package requests (the package launches it
        # from C++); device_ms, plain_ms at the bench's Kus as above, and the
        # same at the other timed shapes (the bench's Kus at depths 16 and
        # 32, pumadyn's and heart's served Kus) under "shapes"
        keys = ("device_ms", "k1_ms", "plain_ms", "bound_ms", "bound_by", "share")
        return {"name": "oak_gram_fwd_triton_kernel", "route": "triton",
                "source": "oak_tpu_torch/ops/oak_gram_triton.py",
                "replaces": "oak_tpu/ops/oak_gram_pallas.py:63", "launches": launches,
                "max_abs_err": n["max_abs_err"],
                "device_ms": n["device_ms"], "plain_ms": n["plain_ms"],
                "bound_ms": n["bound_ms"], "bound_by": n["bound_by"], "share": n["share"],
                "library_ms": None, "k1_ms": n["k1_ms"],
                "shapes": {name: {k: v[k] for k in keys} for name, v in shapes.items()}}

    def solve_entry(numbers, launches):
        # the training bounds' solve, which replaces no TPU kernel: its
        # launches on phase 4's training path (each phase counted and checked
        # there), the numbers of phase 2c at SVGP's forward solve, and every
        # timed shape and form under "shapes"
        n = numbers["svgp32 512x8192 forward"]
        return {"name": "tri_solve_f32", "route": "cuda",
                "source": "oak_tpu_torch/csrc/tri_solve.cu", "replaces": None,
                "launches": launches, "max_abs_err": None,
                "device_ms": n["device_ms"], "plain_ms": n["plain_ms"],
                "bound_ms": n["bound_ms"], "bound_by": n["bound_by"], "share": n["share"],
                "library_ms": n["library_ms"],
                "shapes": {k: v for k, v in numbers.items() if not k.startswith("gemmt ")}}

    def gemmt_entry(numbers, launches):
        # the bounds' lower-triangle product, which replaces no TPU kernel:
        # its launches on phase 4's training path (one a gradient evaluation,
        # the wide solve's dL), the numbers of phase 2c at SGPR's A A^T, and
        # every timed shape under "shapes"
        shapes = {k: v for k, v in numbers.items() if k.startswith("gemmt ")}
        n = shapes["gemmt sgpr8 4x500x6553 symmetric"]
        return {"name": "gemmt_f32", "route": "cuda", "source": "oak_tpu_torch/csrc/gemmt.cu",
                "replaces": None, "launches": launches, "max_abs_err": None,
                "device_ms": n["device_ms"], "plain_ms": n["plain_ms"],
                "bound_ms": n["bound_ms"], "bound_by": n["bound_by"], "share": n["share"],
                "library_ms": n["library_ms"], "shapes": shapes}

    print(json.dumps({"kernels": [
        entry("oak_gram_fwd_f32", "oak_tpu_torch/csrc/oak_gram_fwd.cu",
              "oak_tpu/ops/oak_gram_pallas.py:63",
              predict_launches + train_launches["fwd"] + sobol_launches
              + sgpr_launches["fwd"] + gpr_launches["fwd"] + oak_launches["fwd"]
              + committed_launches["fwd"] + surface_launches["fwd"] + parallel_launches["fwd"]
              + grouped_launches["fwd"] + lanes_launches["fwd"],
              kernel, oak_kernels["K1"], "K1"),
        entry("oak_gram_bwd_f32", "oak_tpu_torch/csrc/oak_gram_bwd.cu",
              "oak_tpu/ops/oak_gram_pallas.py:158",
              train_launches["bwd"] + sgpr_launches["bwd"] + gpr_launches["bwd"]
              + oak_launches["bwd"] + committed_launches["bwd"] + surface_launches["bwd"]
              + parallel_launches["bwd"] + grouped_launches["bwd"] + lanes_launches["bwd"],
              kernel_bwd,
              oak_kernels["K2"], "K2"),
        solve_entry(solve, train_launches["solve"]),
        gemmt_entry(solve, train_launches["gemmt"]),
        triton_entry(triton["triton"], kernel["Triton"],
                     {name.removeprefix("Triton "): v for name, v in kernel.items()
                      if name.startswith("Triton ")} | triton["numbers"])]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
