"""oak-tpu ported to PyTorch and CUDA: the Orthogonal Additive Kernel GP as
SVGP, SGPR and GPR (Gaussian and Bernoulli likelihoods), trained by L-BFGS,
scipy, Adam or natural gradients, single- or multi-start; posterior sampling;
Sobol indices with per-component predictions; normalising flows and input
preprocessing; and ``oak_model``, the user-facing wrapper, with its
checkpoint. The fused OAK gram forward and backward are hand-written CUDA
kernels for Hopper (``csrc/oak_gram_fwd.cu``, ``csrc/oak_gram_bwd.cu``).

Imports torch, numpy and scipy only. Module names follow ``oak_tpu``'s, so
each module's JAX counterpart has the same path.
"""

from .checkpoint import load_oak_model, save_oak_model
from .kernels import OAKKernel
from .measures import EmpiricalMeasure, GaussianMeasure, MOGMeasure, UniformMeasure
from .model import create_model_oak, oak_model
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
    "create_model_oak",
    "load_oak_model",
    "oak_model",
    "save_oak_model",
    "select_latent",
]
