"""Numerics constants of the PyTorch port.

The port has no global dtype or device: every constructor takes an explicit
``dtype`` and ``device``, and the jitter follows the dtype of the matrix it is
added to. There is no module-level route switch either (``oak_tpu.config``'s
``set_pallas_gram`` / ``exact_gram`` exist because the TPU's dots run in bf16);
which gram route runs is decided by the tensor itself, see
``oak_tpu_torch.kernels.oak_kernel.OAKKernel.K``.
"""

from __future__ import annotations

import torch

# Default jitter added to Kuu / K for Cholesky stability (GPflow's default
# is 1e-6; f32 needs a larger floor).
DEFAULT_JITTER_F64 = 1e-6
DEFAULT_JITTER_F32 = 1e-5


def default_jitter(dtype: torch.dtype) -> float:
    return DEFAULT_JITTER_F64 if dtype == torch.float64 else DEFAULT_JITTER_F32
