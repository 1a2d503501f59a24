from .oak_kernel import (OAKKernel, UnconstrainedRBF, component_index_tuples,
                         kernel_K, kernel_K_diag)
from .ortho_binary import OrthogonalBinary
from .ortho_categorical import OrthogonalCategorical
from .ortho_rbf import OrthogonalRBF

__all__ = [
    "OAKKernel",
    "UnconstrainedRBF",
    "OrthogonalBinary",
    "OrthogonalCategorical",
    "OrthogonalRBF",
    "component_index_tuples",
    "kernel_K",
    "kernel_K_diag",
]
