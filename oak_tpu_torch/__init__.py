"""oak-tpu ported to PyTorch and CUDA: the Orthogonal Additive Kernel GP as
SVGP, SGPR and GPR (Gaussian and Bernoulli likelihoods), trained by L-BFGS,
scipy, Adam or natural gradients, single- or multi-start; posterior sampling;
Sobol indices with per-component predictions; normalising flows and input
preprocessing; ``oak_model``, the user-facing wrapper, with its checkpoint,
the reference's positional checkpoint layout, the experiment configs,
the ``torch.export`` serving artifact, the effect plots (``plotting``,
matplotlib imported only to draw), the reference-name layer (``compat``),
the timers and numerical diagnostics of ``utils``, and the multi-device layer
(``parallel``: data- and restart-sharded training, sharded prediction and
Sobol on ``torch.distributed``, one process per device). The fused OAK gram
forward and backward are hand-written CUDA kernels for Hopper
(``csrc/oak_gram_fwd.cu``, ``csrc/oak_gram_bwd.cu``).

Imports torch, numpy and scipy only. Module names follow ``oak_tpu``'s, so
each module's JAX counterpart has the same path, and this package exports
the names of ``oak_tpu/__init__.py`` (its ``OAK_TPU_PLATFORM`` hook is JAX's
and has no counterpart).
"""

from . import bijectors, config, measures, params
from .kernels import (
    OAKKernel,
    OrthogonalBinary,
    OrthogonalCategorical,
    OrthogonalRBF,
    UnconstrainedRBF,
    component_index_tuples,
)
from .measures import (
    EmpiricalMeasure,
    GaussianMeasure,
    Measure,
    MOGMeasure,
    UniformMeasure,
)
from .params import Gamma, Normal, Param, bounded, fixed, param, positive
from .flows import Normalizer, fit_normalizer
from .model import create_model_oak, oak_model
from .models import GPR, SGPR, SVGP, Bernoulli, Gaussian
from .optim import (
    fit_adam,
    fit_lbfgs,
    fit_lbfgs_multistart,
    fit_natgrad_adam,
    fit_scipy,
)
from .serving import deserialize_predict, serialize_predict
from .sobol import (
    compute_sobol_by_order,
    compute_sobol_oak,
    get_prediction_component,
    normalize_sobol,
    num_latents,
    select_latent,
)
from .checkpoint import (
    load_oak_model,
    load_params,
    load_reference_npz,
    save_oak_model,
    save_params,
)
from .experiment import ExperimentConfig, FitConfig, ModelConfig

__version__ = "0.1.0"
