"""Hand-written Hopper kernels with plain PyTorch oracles.

Port of ``repro.kernels``.  Layout as there: ``scaled_gemm.py`` holds the
kernel wrappers (the CUDA C++ sources are in ``../csrc``), ``ops.py`` the
public padding wrapper, ``ref.py`` the oracles, and ``_build.py`` compiles
CUDA source text with nvcc.  Attention and the SSD scan are ported in later
slices.  (Unlike ``repro.kernels``, the kernel functions are not
re-exported here, so ``kernels.scaled_gemm`` stays the module.)
"""
from . import ops, ref, scaled_gemm  # noqa: F401
