"""Joint posterior function draws (``oak_tpu.models.sampling``): every model's
``predict_f_samples(Xnew, num_samples, generator_or_seed)`` draws from the
full predictive covariance through the jitter-escalating Cholesky.

Draws come from a ``torch.Generator``, so they are not ``oak_tpu``'s (JAX's
PRNG); the factor and the moments are the same.
"""

from __future__ import annotations

from typing import Union

import torch

from ..ops.psd import safe_cholesky


def sample_mvn_columns(generator: torch.Generator, mean: torch.Tensor,
                       cov: torch.Tensor, num_samples: int) -> torch.Tensor:
    """Draws from independent-per-column Gaussians N(mean[:, r], cov).

    ``mean``: [S, R]; ``cov``: [S, S] (one covariance shared by the R output
    columns: GPR, SGPR) or [R, S, S] (one per latent: SVGP). The standard
    normals are drawn on the generator's device and moved to the mean's.
    Returns [num_samples, S, R]."""
    S, R = mean.shape
    eps = torch.randn((num_samples, S, R), generator=generator, dtype=mean.dtype,
                      device=generator.device).to(mean.device)
    if cov.dim() == 2:
        L = safe_cholesky(cov)[0]
        draws = torch.einsum("st,ntr->nsr", L, eps)
    else:
        Ls = torch.stack([safe_cholesky(cov[r])[0] for r in range(cov.shape[0])])
        draws = torch.einsum("rst,ntr->nsr", Ls, eps)
    return mean[None] + draws


def predict_f_samples(model, Xnew: torch.Tensor, num_samples: int = 1,
                      generator_or_seed: Union[int, torch.Generator] = 0) -> torch.Tensor:
    """Joint samples of the posterior function at ``Xnew``: [num_samples, S,
    R]. An int seeds a new generator on Xnew's device."""
    mean, cov = model.predict_f(Xnew, full_cov=True)
    generator = generator_or_seed
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=mean.device).manual_seed(int(generator_or_seed))
    return sample_mvn_columns(generator, mean, cov, num_samples)
