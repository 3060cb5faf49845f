"""Plain PyTorch reference oracles for the block-scaled GEMM.

Port of ``repro.kernels.ref`` (``scaled_gemm``, ``quantize_blockwise``,
``quantize_blockwise_2d``).  These are the ground truth of the tests and of
the EvaluationService's correctness check; they are written for clarity,
not speed.

On 128-aligned shapes the quantizers produce the same bytes and scales as
the JAX package.  They also accept a ragged last block (two of the 18
challenge shapes have N = 576): the scale grid then has ceil(dim/128)
entries, computed over a zero-padded last block.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

SCALE_BLOCK = 128  # quantization block edge (matches the AMD challenge spec)


def fmax_of(dtype) -> float:
    """Largest finite magnitude the quantizer maps onto."""
    if dtype == torch.float8_e4m3fn:
        return 448.0
    if dtype == torch.int8:
        return 127.0
    return 3e38


@contextlib.contextmanager
def full_f32_matmul():
    """Run f32 matrix products in full f32 (TF32 off) on the card.

    The flag is process-wide in PyTorch, so it is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def pad_to(x: torch.Tensor, multiple: int, dim: int) -> torch.Tensor:
    """Zero-pad ``dim`` of ``x`` up to a multiple of ``multiple``."""
    pad = (-x.shape[dim]) % multiple
    if pad == 0:
        return x
    widths = [0, 0] * x.ndim
    widths[2 * (x.ndim - 1 - dim) + 1] = pad
    if x.dtype in (torch.float8_e4m3fn, torch.int8):  # pad the raw bytes
        return F.pad(x.view(torch.uint8), widths).view(x.dtype)
    return F.pad(x, widths)


def expand_b_scale(b_scale: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """(K/128, N/128) per-block scales -> (K, N) per-element f32 scales."""
    s = b_scale.float().repeat_interleave(SCALE_BLOCK, 0)
    return s.repeat_interleave(SCALE_BLOCK, 1)[:k, :n]


def dequantize(a, b, a_scale, b_scale):
    """f32 (A, B) with the block scales applied."""
    m, k = a.shape
    n = b.shape[1]
    a32 = a.float() * a_scale.float().repeat_interleave(SCALE_BLOCK, 1)[:, :k]
    b32 = b.float() * expand_b_scale(b_scale, k, n)
    return a32, b32


def scaled_gemm(a, b, a_scale, b_scale, out_dtype=torch.bfloat16):
    """C = dequant(A) @ dequant(B), f32 accumulate, TF32 off.

    a        : (M, K)       storage dtype (float8_e4m3fn / int8 / bf16)
    b        : (K, N)       same storage dtype
    a_scale  : (M, K/128)   f32 — per-row, per-128-K-block scales
    b_scale  : (K/128, N/128) f32 — per-128x128-block scales
    returns  : (M, N) out_dtype
    """
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"inner dimensions differ: {a.shape} @ {b.shape}")
    a32, b32 = dequantize(a, b, a_scale, b_scale)
    with full_f32_matmul():
        out = a32 @ b32
    return out.to(out_dtype)


def quantize_blockwise(x: torch.Tensor, dtype=torch.float8_e4m3fn):
    """Quantize a (M, K) f32 matrix into (values, (M, ceil(K/128)) scales),
    one scale per (row, 128-K-block)."""
    m, k = x.shape
    xr = pad_to(x.float(), SCALE_BLOCK, 1).reshape(m, -1, SCALE_BLOCK)
    max_abs = xr.abs().amax(dim=-1)
    scale = torch.where(max_abs > 0, max_abs / fmax_of(dtype),
                        torch.ones_like(max_abs))
    q = (xr / scale[:, :, None]).to(dtype)
    return q.reshape(m, -1)[:, :k].contiguous(), scale


def quantize_blockwise_2d(x: torch.Tensor, dtype=torch.float8_e4m3fn):
    """Quantize (K, N) into values + (ceil(K/128), ceil(N/128)) block scales."""
    k, n = x.shape
    xp = pad_to(pad_to(x.float(), SCALE_BLOCK, 0), SCALE_BLOCK, 1)
    kb, nb = xp.shape[0] // SCALE_BLOCK, xp.shape[1] // SCALE_BLOCK
    xr = xp.reshape(kb, SCALE_BLOCK, nb, SCALE_BLOCK)
    max_abs = xr.abs().amax(dim=(1, 3))
    scale = torch.where(max_abs > 0, max_abs / fmax_of(dtype),
                        torch.ones_like(max_abs))
    q = (xr / scale[:, None, :, None]).to(dtype)
    return q.reshape(kb * SCALE_BLOCK, nb * SCALE_BLOCK)[:k, :n].contiguous(), scale
