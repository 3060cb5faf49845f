"""Hand-written Hopper kernels with plain PyTorch oracles.

Port of ``repro.kernels``.  Layout as there: ``scaled_gemm.py``,
``flash_attention.py`` and ``ssd.py`` hold the kernel wrappers (the CUDA
C++ sources are in ``../csrc``), ``ops.py`` the public wrappers, ``ref.py``
the oracles, and ``_build.py`` compiles CUDA source text with nvcc.
(Unlike ``repro.kernels``, the kernel functions are not re-exported here,
so ``kernels.scaled_gemm`` stays the module.)
"""
from . import flash_attention, ops, ref, scaled_gemm, ssd  # noqa: F401
