"""oak-tpu ported to PyTorch and CUDA: the SVGP predict path of the
Orthogonal Additive Kernel GP, with the fused OAK gram forward as a
hand-written CUDA kernel for Hopper (``csrc/oak_gram_fwd.cu``).

Imports torch and numpy only. Module names follow ``oak_tpu``'s, so each
module's JAX counterpart has the same path.
"""

from .kernels import OAKKernel
from .measures import EmpiricalMeasure, GaussianMeasure, MOGMeasure, UniformMeasure
from .models import SVGP, Gaussian

__all__ = [
    "EmpiricalMeasure",
    "Gaussian",
    "GaussianMeasure",
    "MOGMeasure",
    "OAKKernel",
    "SVGP",
    "UniformMeasure",
]
