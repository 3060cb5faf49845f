"""Public wrappers around the kernels.

Port of ``repro.kernels.ops`` (``scaled_gemm``, ``attention``,
``decode_attention`` and ``ssd``), without the ``use_pallas`` and
``interpret`` switches: a CPU tensor runs the kernel's
plain version, a CUDA tensor the kernel.  ``scaled_gemm`` pads arbitrary
shapes to kernel-legal ones and slices the result back.  Tiles are clamped
to the problem's dimensions rounded up to 128, as ``repro.core.codegen``
clamps them, so every tile stays a multiple of the quantization block.
The attention kernels mask any S themselves and pick their own tiles, so
the JAX wrappers' ``block_q``/``block_k`` have no counterpart here; nor
has ``ssd``'s ``chunk``, since the SSD kernel masks a ragged last chunk.
"""
from __future__ import annotations

from . import flash_attention as _fa
from . import scaled_gemm as _sg
from . import ssd as _ssd
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


def attention(q, k, v, *, causal=True, window=None):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D) — K5."""
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len):
    """q: (B, Hq, D); k, v: (B, Hkv, S, D); kv_len: (B,) — K6."""
    return _fa.decode_attention(q, k, v, kv_len)


def ssd(x, dt, a, b, c, *, d_skip=None):
    """x: (B, S, H, P), dt: (B, S, H), a: (H,), b/c: (B, S, N) — K7.
    Returns y (B, S, H, P) in x's dtype; ``d_skip`` (H,) is added after
    the kernel in f32, as the JAX wrapper adds it.  The model does not
    call this wrapper: ``models.ssm`` calls ``kernels.ssd.ssd`` and adds
    the skip to y already in x's dtype, as the JAX model does, so the two
    round at different points in bf16, as their JAX originals do."""
    y, _ = _ssd.ssd(x, dt, a, b, c)
    if d_skip is not None:
        y = (y.float() + x.float() * d_skip.float()[None, None, :, None]
             ).to(x.dtype)
    return y
