from .oak_kernel import (KernelComponenent, KernelComponent, OAKKernel,
                         UnconstrainedRBF, component_index_tuples,
                         get_list_representation, kernel_K, kernel_K_diag,
                         per_dim_batched, stack_group, stackable_groups)
from .ortho_binary import OrthogonalBinary
from .ortho_categorical import OrthogonalCategorical
from .ortho_rbf import OrthogonalRBF

__all__ = [
    "KernelComponenent",
    "KernelComponent",
    "OAKKernel",
    "UnconstrainedRBF",
    "OrthogonalBinary",
    "OrthogonalCategorical",
    "OrthogonalRBF",
    "component_index_tuples",
    "get_list_representation",
    "kernel_K",
    "kernel_K_diag",
    "per_dim_batched",
    "stack_group",
    "stackable_groups",
]
