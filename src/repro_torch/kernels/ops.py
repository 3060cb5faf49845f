"""Public wrapper around the block-scaled GEMM kernel.

Port of ``repro.kernels.ops`` (``scaled_gemm`` only; attention and SSD
come in later slices).  The wrapper pads arbitrary shapes to kernel-legal
ones and slices the result back.  Tiles are clamped to the problem's
dimensions rounded up to 128, as ``repro.core.codegen`` clamps them, so
every tile stays a multiple of the quantization block.
"""
from __future__ import annotations

from . import scaled_gemm as _sg
from .ref import SCALE_BLOCK, pad_to


def clamp_block(block: int, dim: int) -> int:
    return min(block, -(-dim // SCALE_BLOCK) * SCALE_BLOCK)


def scaled_gemm(a, b, a_scale, b_scale, *, block_m: int = 128,
                block_n: int = 128, block_k: int = 128,
                grid_order: str = "mn", scale_application: str = "scale_acc"):
    m, k = a.shape
    n = b.shape[1]
    block_m = clamp_block(block_m, m)
    block_n = clamp_block(block_n, n)
    block_k = clamp_block(block_k, k)
    ap = pad_to(pad_to(a, block_m, 0), block_k, 1)
    bp = pad_to(pad_to(b, block_k, 0), block_n, 1)
    asp = pad_to(pad_to(a_scale, block_m, 0), block_k // SCALE_BLOCK, 1)
    bsp = pad_to(pad_to(b_scale, block_k // SCALE_BLOCK, 0),
                 block_n // SCALE_BLOCK, 1)
    out = _sg.scaled_gemm(ap.contiguous(), bp.contiguous(), asp.contiguous(),
                          bsp.contiguous(), block_m=block_m, block_n=block_n,
                          block_k=block_k, grid_order=grid_order,
                          scale_application=scale_application)
    return out[:m, :n]
