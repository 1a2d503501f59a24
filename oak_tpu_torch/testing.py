"""Inputs for checking the fused gram kernels, forward and backward, against
their plain versions on the card: one generator, one list of cases and one
acceptance rule, shared by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# (name, D, N, M, E, depth): a ragged shape, a mixed case with two extra
# grams, every depth with its own kernel template (1..8), and the deep
# variants' buckets (9..16, 17..32) at D = 32
KERNEL_CASES = [("ragged 1000x77", 32, 1000, 77, 0, 3),
                ("mixed E=2", 30, 300, 200, 2, 3)] + \
    [(f"P={p}", 32, 300, 200, 0, p) for p in range(1, 9)] + \
    [(f"P={p}", 32, 300, 200, 0, p) for p in (9, 12, 16, 32)]


def kernel_error(out: torch.Tensor, plain: torch.Tensor,
                 plain64: torch.Tensor, tol: float) -> Tuple[bool, float, str]:
    """Whether a kernel's result ``out`` passes against the plain version in
    float32 (``plain``) and in float64 (``plain64``) on the same inputs, its
    error relative to max |plain|, and a finding. It passes within ``tol``
    of max |plain|; or, where the float32 plain version itself drifts (deep
    Newton–Girard), when its error against float64 is at most twice the
    float32 plain version's."""
    scale = max(float(plain64.abs().max()), 1e-30)
    err = float((out - plain).abs().max()) / max(float(plain.abs().max()), 1e-30)
    if err < tol:
        return True, err, f"{err:.1e}"
    ours = float((out.double() - plain64).abs().max()) / scale
    theirs = float((plain.double() - plain64).abs().max()) / scale
    return ours <= 2.0 * theirs, err, f"{err:.1e} (vs f64 {ours:.1e}, plain f32 {theirs:.1e})"


# (name, D, N, depth): the exact GP's square gram K(X), X2 = None, at the width
# of bench.py's --gpr-scale rows (N = 8192, D = 8, depth 2)
SQUARE_CASE = ("square 8192x8192", 8, 8192, 2)


def square_inputs(seed: int, D: int, N: int, depth: int, device) -> List[torch.Tensor]:
    """``prescaled_inputs`` of a square gram K(X, X): u2 and c2 are copies of
    u1 and c1, as ``ops.oak_gram._prep`` gives them for X2 = None."""
    u1, _, c1, _, extra, logb, sig2 = prescaled_inputs(seed, D, N, N, 0, depth, device)
    return [u1, u1.clone(), c1, c1.clone(), extra, logb, sig2]


def prescaled_inputs(seed: int, D: int, N: int, M: int, E: int, depth: int,
                     device) -> List[torch.Tensor]:
    """[u1, u2, c1, c2, extra, logb, sig2] in float32, shaped like
    ``ops.oak_gram._prep``'s, for lengthscales in U(1, 3) under the N(0, 1)
    measure, with order variances 1, 0.5, 0.2, 0.05, ..."""
    rng = np.random.default_rng(seed)
    l = rng.uniform(1.0, 3.0, size=(D, 1))
    x1, x2 = rng.normal(size=(D, N)), rng.normal(size=(D, M))
    t = l * l + 1.0
    rs = 1.0 / np.sqrt(l / np.sqrt(l * l + 2.0))
    sig2 = [1.0, 0.5, 0.2, 0.05] + [0.05 * 0.25 ** k for k in range(1, depth)]
    arrays = (x1 / (l * np.sqrt(2.0)), x2 / (l * np.sqrt(2.0)),
              l / np.sqrt(t) * np.exp(-0.5 * x1 ** 2 / t) * rs,
              l / np.sqrt(t) * np.exp(-0.5 * x2 ** 2 / t) * rs,
              rng.uniform(-0.3, 0.3, size=(E, N, M)),
              np.zeros(D), np.array(sig2[:depth + 1]))
    return [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in arrays]
