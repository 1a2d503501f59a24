"""The CUDA kernel csrc/oak_gram_fwd.cu against its plain torch version, on
the card, at the shapes chip_smoke.py drives. Marked ``gpu``; each test asks
the ``cuda`` fixture, which skips when no card is present. This file imports
no JAX, so on a machine with a card and no JAX it runs without the suite's
conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from oak_tpu_torch.kernels import OAKKernel
from oak_tpu_torch.ops import oak_gram as og
from oak_tpu_torch.testing import KERNEL_CASES, prescaled_inputs

pytestmark = pytest.mark.gpu

# the Pallas gate's bound on the forward, relative to max |plain|
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the predict path's Kus and Kuu at the bench width, then the shared cases
CASES = [("Kus 512x8192", 32, 512, 8192, 0, 3),
         ("Kuu 512x512", 32, 512, 512, 0, 3)] + KERNEL_CASES


@pytest.mark.parametrize("name,D,N,M,E,depth", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, D, N, M, E, depth):
    args = prescaled_inputs(61, D, N, M, E, depth, cuda)
    before = og.LAUNCHES
    out = og.oak_gram_fused(*args, depth)
    torch.cuda.synchronize()
    assert og.LAUNCHES == before + 1
    ref = og.oak_gram_plain(*args, depth)
    assert out.shape == (N, M) and torch.isfinite(out).all()
    err = float((out - ref).abs().max() / ref.abs().max())
    assert err < TOL, err


def test_kernel_refuses_what_it_cannot_run(cuda):
    args = prescaled_inputs(62, 4, 16, 8, 0, 3, cuda)
    with pytest.raises(NotImplementedError, match="K2"):
        og.oak_gram_fused(*[a.clone().requires_grad_(True) for a in args], 3)
    with pytest.raises(TypeError, match="float32"):
        og.oak_gram_fused(*[a.double() for a in args], 3)
    with pytest.raises(ValueError, match="1..8"):
        og.oak_gram_fused(*args[:6], torch.ones(10, device=cuda), 9)
    with pytest.raises(ValueError, match="contiguous"):
        og.oak_gram_fused(args[0].t().contiguous().t(), *args[1:], 3)
    with pytest.raises(ValueError, match="cpu"):
        og.oak_gram_fused(args[0].cpu(), *args[1:], 3)
    with pytest.raises(ValueError, match="shape"):
        og.oak_gram_fused(args[0], args[1], args[2][:, :-1].contiguous(), *args[3:], 3)


def test_oak_kernel_K_routes_through_kernel(cuda):
    """float32 CUDA input takes the kernel; float64 on the same card takes
    the per-dim route, and the two agree."""
    k = OAKKernel.create(num_dims=6, max_interaction_depth=3, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(63).normal(size=(300, 6)),
                        dtype=torch.float32, device=cuda)
    with torch.no_grad():
        before = og.LAUNCHES
        K = k.K(X[:100], X)
        torch.cuda.synchronize()
        assert og.LAUNCHES == before + 1
        K64 = k.double().K(X[:100].double(), X.double())
        assert og.LAUNCHES == before + 1
    err = float((K.double() - K64).abs().max() / K64.abs().max())
    assert err < TOL, err


def test_oak_kernel_K_deeper_than_kernel_raises(cuda):
    """Depth 9 qualifies for the fused route, as in oak_tpu, and the wrapper
    refuses it instead of running the per-dim route on the card."""
    k = OAKKernel.create(num_dims=10, max_interaction_depth=9, dtype=torch.float32,
                         device=cuda)
    X = torch.as_tensor(np.random.default_rng(64).normal(size=(20, 10)),
                        dtype=torch.float32, device=cuda)
    assert og.supports_fused(k)
    with torch.no_grad(), pytest.raises(ValueError, match="K1-P8"):
        k.K(X)
