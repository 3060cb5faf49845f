"""PyTorch and CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
nothing of it and nothing of JAX.  Its first slice is the Kernel
Scientist's campaign (``repro_torch.core``) on the block-scaled GEMM
kernels of ``repro_torch.kernels``.  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
