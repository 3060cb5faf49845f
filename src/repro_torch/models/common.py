"""Shared model machinery for inference: norms, rotary embeddings, attention
and parameter init.

Port of ``repro.models.common`` (the inference part), plus
:func:`logits_f32`, the f32 unembedding that every family's prefill and
decode end in.  Where the JAX module keeps XLA formulations and notes
that the Pallas kernels are drop-in replacements for the hot paths, the
port makes that swap:
:func:`blockwise_attention` goes to ``kernels.ops.attention`` (K5) and
:func:`decode_attention` to ``kernels.ops.decode_attention`` (K6); on CPU
tensors those run the kernels' plain versions.  The flash VJP and
``chunked_softmax_xent`` wait for the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels import ops


def rms_norm(x, scale, eps: float = 1e-6):
    """RMS norm in f32, multiplied by ``1 + scale`` (zero-initialised)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype)


def logits_f32(model, x):
    """x: (B, D).  f32 logits of the products of x and the model's
    unembedding (its ``unembed``, or ``embed`` when tied), summed in f32
    and never rounded to the weights' dtype."""
    unembed = model.unembed if model.unembed is not None else model.embed
    if x.is_cuda and x.dtype != torch.float32:
        # cuBLAS writes the f32 sums of the bf16 products directly, with
        # no f32 copy of the (V, D) unembedding; the CPU has no such call
        return torch.mm(x, unembed.t(), out_dtype=torch.float32)
    return torch.nn.functional.linear(x.float(), unembed.float())


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_tables(positions, head_dim: int, theta: float, *,
                mrope: bool = False, sections=(1, 2, 2)):
    """cos and sin of the rotation angles, each (B, 1, S, D/2) f32.

    positions: (B, S) integers, or (3, B, S) for (t, h, w) with ``mrope``
    (Qwen2-VL multimodal RoPE: the D/2 frequency pairs are split between
    the three components in ``sections`` proportion).  The model computes
    them once per forward or decode step and every layer shares them."""
    freqs = rope_freqs(head_dim, theta, positions.device)         # (D/2,)
    if mrope:
        d2 = head_dim // 2
        total = sum(sections)
        splits = [d2 * s // total for s in sections]
        splits[-1] = d2 - sum(splits[:-1])
        comp = torch.repeat_interleave(
            torch.arange(3, device=positions.device),
            torch.tensor(splits, device=positions.device))        # (D/2,)
        pos_per_freq = positions.float()[comp]                    # (D/2,B,S)
        angles = pos_per_freq.permute(1, 2, 0)[:, None] * freqs   # (B,1,S,D/2)
    else:
        angles = positions[:, None, :, None].float() * freqs      # (B,1,S,D/2)
    return torch.cos(angles), torch.sin(angles)


def rotate_halves(x, tables):
    """Rotate the pairs (x[i], x[i + D/2]) of x (B, H, S, D) by the angles
    whose ``(cos, sin)`` are ``tables`` (from :func:`rope_tables`)."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (B, H, S, D); positions: (B, S) integers."""
    return rotate_halves(x, rope_tables(positions, x.shape[-1], theta))


def apply_mrope(x, positions, theta: float, sections=(1, 2, 2)):
    """Qwen2-VL multimodal RoPE: x (B, H, S, D), positions (3, B, S)."""
    return rotate_halves(x, rope_tables(positions, x.shape[-1], theta,
                                        mrope=True, sections=sections))


# ---------------------------------------------------------------------------
# Attention: the kernels K5 (prefill) and K6 (decode)
# ---------------------------------------------------------------------------
def blockwise_attention(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        kv_len=None, q_offset: int = 0):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D), Hq % Hkv == 0.

    The JAX function's ``kv_len`` (valid KV prefix per row) and
    ``q_offset`` (queries that start inside the KV sequence) are not
    covered by K5; no dense prefill passes them, and here they raise.  Its
    XLA tiling knobs (``q_chunk``, ``k_chunk``, ``unroll``) have no
    counterpart: the kernel picks its tiles."""
    if kv_len is not None or q_offset:
        raise NotImplementedError(
            "blockwise_attention with kv_len or q_offset: K5 covers a "
            "prompt attending to itself only")
    return ops.attention(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, kv_len, *, window=None):
    """Counterpart of the JAX ``decode_attention_xla``: one new token vs. a
    cache.  q: (B, Hq, D); k, v: (B, Hkv, S, D) (strided views are fine);
    kv_len: (B,) — the new token sits at position kv_len - 1.  A local
    ``window`` is not covered by K6 and raises."""
    if window is not None:
        raise NotImplementedError("decode attention with a window: K6 "
                                  "attends to the whole valid prefix")
    return ops.decode_attention(q, k, v, kv_len)


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------
def dense_init(shape, *, generator: torch.Generator, in_axis: int = 0,
               dtype=torch.bfloat16, device=None):
    """Truncated normal on (-2, 2) times 1/sqrt(fan_in), drawn in f32 from
    ``generator`` (on ``device``) and cast, as the JAX ``dense_init``.  The
    two frameworks draw different numbers from one seed: tests carry JAX
    weights across with ``models.convert`` instead."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * (1.0 / math.sqrt(shape[in_axis]))).to(dtype)
