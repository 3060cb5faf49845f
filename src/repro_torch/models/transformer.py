"""Decoder/encoder transformer, dense family (qwen1.5/2.5, stablelm,
command-r+, qwen2-vl, hubert), for inference.

Port of ``repro.models.transformer`` (``init_params``, ``attention_seq``,
``attention_decode``, ``ffn_dense``, ``_layer_seq``, ``_layer_decode``,
``forward`` without the loss, ``init_cache``, ``prefill`` and
``decode_step``).  Parameters are ``nn.Module``s, one :class:`Layer` per
layer in an ``nn.ModuleList``, and a Python loop takes the place of
``lax.scan``.  Projection weights are kept as ``(d_out, d_in)`` for
``F.linear`` (``models.convert`` transposes the JAX ``(d_in, d_out)``
kernels).  Prefill attention is K5 and decode attention K6, through
``common``; the projections, FFN and unembedding stay ``torch.matmul``, as
the JAX package left them to XLA.

The cache keeps the JAX layout, ``k``/``v`` of ``(L, B, Smax, Hkv, dh)``
and ``len`` of ``(B,)`` int32.  :func:`decode_step` writes the new keys
and values **in place** and returns the same tensors with ``len + 1``; the
write index is clamped to ``Smax - 1`` as the JAX ``dynamic_update_slice``
clamps it, so a slot that counts past ``Smax`` overwrites its last
position and attends to all of them.

Logits are f32, as the JAX package computes them
(``preferred_element_type=f32``): on the card the bf16 product is summed
and written in f32 by one ``torch.mm(..., out_dtype=float32)``, on the CPU
it is taken in f32, so a greedy argmax over ~152k entries is not decided
by bf16 rounding of the logits.  The RoPE cos and sin are computed once
per forward or decode step and shared by every layer.  The MoE and MLA families
raise ``NotImplementedError`` until their slice (ROADMAP queue 1).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (blockwise_attention, decode_attention, dense_init,
                     logits_f32, rms_norm, rope_tables, rotate_halves)
from .config import ArchConfig


def _param(shape, dtype, device):
    """An uninitialised weight; inference only, so no gradient."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
        self.wq = _param((h * dh, d), dtype, device)
        self.wk = _param((hkv * dh, d), dtype, device)
        self.wv = _param((hkv * dh, d), dtype, device)
        self.wo = _param((d, h * dh), dtype, device)
        self.bq = _param((h * dh,), dtype, device) if cfg.qkv_bias else None
        self.bk = _param((hkv * dh,), dtype, device) if cfg.qkv_bias else None
        self.bv = _param((hkv * dh,), dtype, device) if cfg.qkv_bias else None


class DenseFFN(nn.Module):
    def __init__(self, d: int, f: int, dtype, device):
        super().__init__()
        self.w_gate = _param((f, d), dtype, device)
        self.w_up = _param((f, d), dtype, device)
        self.w_down = _param((d, f), dtype, device)


class Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.attn = Attention(cfg, dtype, device)
        self.ffn = DenseFFN(cfg.d_model, cfg.d_ff, dtype, device)


class Transformer(nn.Module):
    """The parameters of one dense model, uninitialised (see
    :func:`init_params` and ``models.convert.from_jax``)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet "
                "(ROADMAP queue 1: MoE and MLA)")
        dtype = getattr(torch, cfg.param_dtype)
        vp, d = cfg.vocab_padded, cfg.d_model
        self.embed = _param((vp, d), dtype, device)
        self.ln_f = _param((d,), dtype, device)
        self.unembed = (None if cfg.tie_embeddings
                        else _param((vp, d), dtype, device))
        self.layers = nn.ModuleList(Layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Transformer:
    """Random weights as the JAX ``init_params`` draws them (truncated
    normal / sqrt(fan_in), norms and biases zero), from ``generator``."""
    model = Transformer(cfg, device)

    def fill(p, in_axis):
        p.copy_(dense_init(tuple(p.shape), generator=generator,
                           in_axis=in_axis, dtype=p.dtype, device=device))

    with torch.no_grad():
        fill(model.embed, 1)
        for lp in model.layers:
            for w in (lp.attn.wq, lp.attn.wk, lp.attn.wv, lp.attn.wo,
                      lp.ffn.w_gate, lp.ffn.w_up, lp.ffn.w_down):
                fill(w, 1)          # (d_out, d_in): fan_in is axis 1
            for z in (lp.ln1, lp.ln2, lp.attn.bq, lp.attn.bk, lp.attn.bv):
                if z is not None:
                    z.zero_()
        model.ln_f.zero_()
        if model.unembed is not None:
            fill(model.unembed, 1)
    return model


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def _rope_tables(cfg: ArchConfig, positions):
    """RoPE (or M-RoPE) cos and sin for ``positions``, shared by every
    layer of one step."""
    return rope_tables(positions, cfg.head_dim_, cfg.rope_theta,
                       mrope=cfg.mrope)


def _split_heads(x, h):
    b, s, hd = x.shape
    return x.view(b, s, h, hd // h).transpose(1, 2)              # (B,H,S,dh)


def attention_seq(p: Attention, x, rope, cfg: ArchConfig):
    """Full-sequence attention (prefill); ``rope`` is the step's
    ``_rope_tables``.  Returns (y, (k, v)) with k, v of (B, Hkv, S, dh)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = _split_heads(F.linear(x, p.wq, p.bq), h)
    k = _split_heads(F.linear(x, p.wk, p.bk), hkv)
    v = _split_heads(F.linear(x, p.wv, p.bv), hkv)
    q = rotate_halves(q, rope)
    k = rotate_halves(k, rope)
    y = blockwise_attention(q, k, v, causal=not cfg.encoder_only)
    y = y.transpose(1, 2).reshape(b, s, h * dh)
    return F.linear(y, p.wo), (k, v)


def attention_decode(p: Attention, x, rope, cfg: ArchConfig, cache_k,
                     cache_v, kv_len):
    """x: (B, D) one token; ``rope``: the step's ``_rope_tables`` (S = 1);
    cache_k/v: (B, Smax, Hkv, dh), written in place at
    ``min(kv_len, Smax - 1)``.  Returns y."""
    b, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = F.linear(x, p.wq, p.bq).view(b, h, dh)
    k = F.linear(x, p.wk, p.bk).view(b, hkv, dh)
    v = F.linear(x, p.wv, p.bv).view(b, hkv, dh)
    q = rotate_halves(q[:, :, None, :], rope)[:, :, 0, :]
    k = rotate_halves(k[:, :, None, :], rope)[:, :, 0, :]
    rows = torch.arange(b, device=x.device)
    idx = kv_len.clamp(max=cache_k.shape[1] - 1)
    cache_k[rows, idx] = k
    cache_v[rows, idx] = v
    y = decode_attention(q, cache_k.transpose(1, 2), cache_v.transpose(1, 2),
                         kv_len + 1)
    return F.linear(y.reshape(b, h * dh), p.wo)


# ---------------------------------------------------------------------------
# FFN + layer bodies
# ---------------------------------------------------------------------------
def ffn_dense(p: DenseFFN, x):
    g = F.linear(x, p.w_gate)
    u = F.linear(x, p.w_up)
    return F.linear(F.silu(g.float()).to(u.dtype) * u, p.w_down)


def _layer_seq(lp: Layer, x, rope, cfg: ArchConfig):
    y, kv = attention_seq(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps),
                          rope, cfg)
    x = x + y
    return x + ffn_dense(lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps)), kv


def _layer_decode(lp: Layer, x, rope, cfg: ArchConfig, cache_k, cache_v,
                  kv_len):
    x = x + attention_decode(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps),
                             rope, cfg, cache_k, cache_v, kv_len)
    return x + ffn_dense(lp.ffn, rms_norm(x, lp.ln2, cfg.norm_eps))


# ---------------------------------------------------------------------------
# Full model: forward / prefill / decode
# ---------------------------------------------------------------------------
def _embed_in(model: Transformer, cfg: ArchConfig, batch):
    if cfg.inputs == "embeddings":
        return batch["embeds"]
    return F.embedding(batch["tokens"], model.embed)


def _positions(cfg: ArchConfig, batch, b, s, device):
    if "positions" in batch:
        return batch["positions"]
    pos = torch.arange(s, dtype=torch.int32, device=device).expand(b, s)
    if cfg.mrope:
        pos = pos.expand(3, b, s)
    return pos


@torch.no_grad()
def forward(model: Transformer, cfg: ArchConfig, batch):
    """Returns (hidden (B, S, D), [(k, v) per layer, each (B, Hkv, S, dh)])."""
    x = _embed_in(model, cfg, batch)
    b, s, _ = x.shape
    rope = _rope_tables(cfg, _positions(cfg, batch, b, s, x.device))
    kvs = []
    for lp in model.layers:
        x, kv = _layer_seq(lp, x, rope, cfg)
        kvs.append(kv)
    return rms_norm(x, model.ln_f, cfg.norm_eps), kvs


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def prefill(model: Transformer, cfg: ArchConfig, batch, max_seq: int):
    """Full-sequence forward that also builds the KV cache (padded to
    ``max_seq``).  Returns (last-token logits (B, V) f32, cache)."""
    hidden, kvs = forward(model, cfg, batch)
    b, s, _ = hidden.shape
    logits = logits_f32(model, hidden[:, -1, :])
    if cfg.encoder_only:
        return logits, None
    if s > max_seq:
        raise ValueError(f"prompt of {s} tokens exceeds max_seq={max_seq}")
    cache = init_cache(cfg, b, max_seq, dtype=kvs[0][0].dtype,
                       device=hidden.device)
    for i, (k, v) in enumerate(kvs):     # (B, Hkv, S, dh) -> (B, S, Hkv, dh)
        cache["k"][i, :, :s] = k.transpose(1, 2)
        cache["v"][i, :, :s] = v.transpose(1, 2)
    cache["len"].fill_(s)
    return logits, cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: ArchConfig, cache, tokens,
                positions=None):
    """One decode step.  tokens: (B,) integers (or embeds (B, D)).
    Returns (logits (B, V) f32, cache) — the cache's k/v written in place."""
    if cfg.inputs == "embeddings" and tokens.ndim == 2:
        x = tokens
    else:
        x = F.embedding(tokens, model.embed)
    kv_len = cache["len"]
    if positions is None:
        positions = kv_len
        if cfg.mrope:  # text continuation: t advances, h/w stay 0
            positions = torch.stack([kv_len, kv_len * 0, kv_len * 0], 0)
    rope = _rope_tables(cfg, positions[..., None])           # S = 1
    for i, lp in enumerate(model.layers):
        x = _layer_decode(lp, x, rope, cfg, cache["k"][i],
                          cache["v"][i], kv_len)
    logits = logits_f32(model, rms_norm(x, model.ln_f, cfg.norm_eps))
    return logits, {"k": cache["k"], "v": cache["v"], "len": kv_len + 1}
