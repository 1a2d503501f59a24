"""oak-tpu ported to PyTorch and CUDA: the SVGP of the Orthogonal Additive
Kernel GP, predicting and training (Adam, natural gradients; Gaussian and
Bernoulli likelihoods), with the fused OAK gram forward and backward as
hand-written CUDA kernels for Hopper (``csrc/oak_gram_fwd.cu``,
``csrc/oak_gram_bwd.cu``).

Imports torch and numpy only. Module names follow ``oak_tpu``'s, so each
module's JAX counterpart has the same path.
"""

from .kernels import OAKKernel
from .measures import EmpiricalMeasure, GaussianMeasure, MOGMeasure, UniformMeasure
from .models import SVGP, Bernoulli, Gaussian

__all__ = [
    "Bernoulli",
    "EmpiricalMeasure",
    "Gaussian",
    "GaussianMeasure",
    "MOGMeasure",
    "OAKKernel",
    "SVGP",
    "UniformMeasure",
]
