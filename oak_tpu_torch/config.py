"""Defaults of the PyTorch port: the dtype and device a model is built in,
and the numerics constants.

``oak_tpu`` builds in float32 (``oak_tpu.config.default_float`` without x64)
on the accelerator JAX finds. The port's counterpart: every constructor and
``create`` takes ``dtype=None, device=None`` and resolves them here, to
float32 on the CUDA card. There is no CPU fallback: without a card, building
on the default device raises torch's CUDA error. CPU work, the tests' among
it, names ``device="cpu"`` (and ``dtype=torch.float64`` for parity runs).
A ``create`` that receives a built module (``SVGP.create(kernel, ...)``)
builds in that module's dtype and device unless told otherwise (``like``).

There is no module-level route switch (``oak_tpu.config``'s
``set_pallas_gram`` / ``exact_gram`` exist because the TPU's dots run in
bf16); which gram route runs is decided by the tensor itself, see
``oak_tpu_torch.kernels.oak_kernel.OAKKernel.K``.
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch
from torch import nn

DEFAULT_DTYPE = torch.float32
DEFAULT_DEVICE = torch.device("cuda")

# Default jitter added to Kuu / K for Cholesky stability (GPflow's default
# is 1e-6; f32 needs a larger floor).
DEFAULT_JITTER_F64 = 1e-6
DEFAULT_JITTER_F32 = 1e-5


def resolve(dtype: Optional[torch.dtype] = None,
            device=None) -> Tuple[torch.dtype, torch.device]:
    """(dtype, device) with None replaced by float32 and the CUDA card. Only
    names the device: it touches no card, so it is safe without one."""
    return (DEFAULT_DTYPE if dtype is None else dtype,
            DEFAULT_DEVICE if device is None else torch.device(device))


def like(module: nn.Module, dtype: Optional[torch.dtype] = None,
         device=None) -> Tuple[torch.dtype, torch.device]:
    """``resolve`` with None replaced by the dtype and device of ``module``'s
    first floating parameter or buffer, where it has one."""
    t = next((t for t in itertools.chain(module.parameters(), module.buffers())
              if t.is_floating_point()), None)
    if t is not None:
        dtype = t.dtype if dtype is None else dtype
        device = t.device if device is None else device
    return resolve(dtype, device)


def default_jitter(dtype: torch.dtype) -> float:
    return DEFAULT_JITTER_F64 if dtype == torch.float64 else DEFAULT_JITTER_F32
