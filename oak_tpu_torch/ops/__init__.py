"""Operations on tensors: Newton–Girard, the fused OAK gram and its CUDA
kernel's wrapper, PSD linear algebra. Import the submodules; this package
re-exports nothing, so ``ops.oak_gram`` and ``ops.newton_girard`` name the
modules, not their functions of the same name."""
