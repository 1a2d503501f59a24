"""oak-tpu ported to PyTorch and CUDA: the Orthogonal Additive Kernel GP as
SVGP (predicting and training with Adam and natural gradients; Gaussian and
Bernoulli likelihoods), SGPR and GPR, posterior sampling, and Sobol indices
with per-component predictions, with the fused OAK gram forward and backward
as hand-written CUDA kernels for Hopper (``csrc/oak_gram_fwd.cu``,
``csrc/oak_gram_bwd.cu``).

Imports torch and numpy only. Module names follow ``oak_tpu``'s, so each
module's JAX counterpart has the same path.
"""

from .kernels import OAKKernel
from .measures import EmpiricalMeasure, GaussianMeasure, MOGMeasure, UniformMeasure
from .models import GPR, SGPR, SVGP, Bernoulli, Gaussian
from .sobol import select_latent

__all__ = [
    "Bernoulli",
    "EmpiricalMeasure",
    "GPR",
    "Gaussian",
    "GaussianMeasure",
    "MOGMeasure",
    "OAKKernel",
    "SGPR",
    "SVGP",
    "UniformMeasure",
    "select_latent",
]
