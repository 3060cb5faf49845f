"""RecurrentGemma / Griffin: RG-LRU recurrent blocks and local attention,
2:1, for inference.

Port of ``repro.models.rglru`` (``init_params``, ``_rglru_coeffs``,
``rglru_seq``, ``rglru_step``, the conv, ``recurrent_block_seq``/``_step``,
``_attn_seq``, ``forward`` without the loss, ``init_cache``,
``prefill``, ``_decode_block`` and ``decode_step``).  Parameters are
``nn.Module``s: one :class:`Block` per layer in layer order, whose kind is
``cfg.rglru.pattern[i % len(pattern)]`` — the JAX super-blocks
(``pattern`` repeated ``n_layers // len(pattern)`` times) followed by the
tail (its first ``n_layers % len(pattern)`` kinds); at 38 layers, 12
attention and 26 recurrent.  Projections are ``(d_out, d_in)`` for
``F.linear`` (``models.convert`` transposes the JAX kernels); ``conv_w``
keeps the JAX ``(conv_width, W)`` layout and ``lambda_p`` is f32.

The linear recurrence h_t = a_t h_{t-1} + b_t has no Pallas kernel: JAX
runs it as ``lax.associative_scan``.  Here it is a log-depth doubling
(Hillis-Steele) scan in f32 in plain PyTorch (:func:`rglru_seq`):
ceil(log2 S) steps of a few elementwise launches each, where a loop over
the tokens would cost S launches a recurrent layer.  Prefill attention is
K5, causal with ``window=cfg.rglru.window``; decode attention is K6 over
the ring cache, as ``common`` maps the JAX ``blockwise_attention`` and
``decode_attention_xla``.

The cache keeps the JAX layout: ``k``/``v`` of ``(n_attn, B, W, Hkv,
dh)`` with ``W = min(window, max_seq)`` ring slots, position p in slot
``p % W``; ``state`` ``(n_rec, B, lru_width)`` f32; ``conv`` ``(n_rec, B,
conv_width - 1, lru_width)`` holding the last pre-conv inputs; ``len``
``(B,)`` int32.  :func:`decode_step` writes ``k``/``v`` at ``len % W``
and updates ``state`` and ``conv`` **in place**, then attends over
``min(len + 1, W)`` slots through the ring's strides (their order is not
the tokens', which attention does not see), and returns the same tensors
with ``len + 1``.  An idle serving slot keeps counting ``len`` past any
bound, as in JAX: ``% W`` keeps its write inside the ring and its valid
count stays ``W``.  A prompt shorter than ``conv_width - 1`` tokens raises
``ValueError``, as the ssm port does: its conv tail would be short, and
the JAX engine then fails on the slot write.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import (blockwise_attention, decode_attention, dense_init,
                     logits_f32, rms_norm, rope_tables, rotate_halves)
from .config import ArchConfig
from .ssm import _conv1d_seq
from .transformer import Attention, DenseFFN, _param, _split_heads, ffn_dense

_C_RGLRU = 8.0


def kinds(cfg: ArchConfig) -> list:
    """The kind of each layer, in layer order (the JAX ``_counts`` per
    stack, laid end to end)."""
    pat = cfg.rglru.pattern
    return [pat[i % len(pat)] for i in range(cfg.n_layers)]


class Recurrent(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d = cfg.d_model
        w = cfg.rglru.lru_width or d
        self.w_in = _param((w, d), dtype, device)
        self.w_gate_branch = _param((w, d), dtype, device)
        self.conv_w = _param((cfg.rglru.conv_width, w), dtype, device)
        self.conv_b = _param((w,), dtype, device)
        self.wi_gate = _param((w, w), dtype, device)
        self.wr_gate = _param((w, w), dtype, device)
        self.lambda_p = _param((w,), torch.float32, device)
        self.w_out = _param((d, w), dtype, device)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, kind: str, dtype, device):
        super().__init__()
        self.kind = kind
        self.ln1 = _param((cfg.d_model,), dtype, device)
        self.ln2 = _param((cfg.d_model,), dtype, device)
        self.ffn = DenseFFN(cfg.d_model, cfg.d_ff, dtype, device)
        if kind == "attn":
            self.attn = Attention(cfg, dtype, device)
        else:
            self.rec = Recurrent(cfg, dtype, device)


class RecurrentGemma(nn.Module):
    """The parameters of one RG-LRU model, uninitialised (see
    :func:`init_params` and ``models.convert.from_jax``)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        vp, d = cfg.vocab_padded, cfg.d_model
        self.embed = _param((vp, d), dtype, device)
        self.ln_f = _param((d,), dtype, device)
        self.unembed = (None if cfg.tie_embeddings
                        else _param((vp, d), dtype, device))
        self.layers = nn.ModuleList(Block(cfg, kind, dtype, device)
                                    for kind in kinds(cfg))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> RecurrentGemma:
    """Random weights as the JAX ``init_params`` draws them: truncated
    normal / sqrt(fan_in) (fan-in d for the input projections, the LRU
    width for the gates and ``w_out``, ``conv_width`` for ``conv_w``),
    ``lambda_p`` 2, norms and biases zero."""
    model = RecurrentGemma(cfg, device)

    def fill(p, in_axis):
        p.copy_(dense_init(tuple(p.shape), generator=generator,
                           in_axis=in_axis, dtype=p.dtype, device=device))

    with torch.no_grad():
        fill(model.embed, 1)
        for blk in model.layers:
            if blk.kind == "attn":
                for w in (blk.attn.wq, blk.attn.wk, blk.attn.wv, blk.attn.wo):
                    fill(w, 1)          # (d_out, d_in): fan_in is axis 1
            else:
                rec = blk.rec
                for w in (rec.w_in, rec.w_gate_branch, rec.wi_gate,
                          rec.wr_gate, rec.w_out):
                    fill(w, 1)
                fill(rec.conv_w, 0)     # (conv_width, W): fan_in conv_width
                rec.conv_b.zero_()
                rec.lambda_p.fill_(2.0)
            for w in (blk.ffn.w_gate, blk.ffn.w_up, blk.ffn.w_down):
                fill(w, 1)
            blk.ln1.zero_()
            blk.ln2.zero_()
        model.ln_f.zero_()
        if model.unembed is not None:
            fill(model.unembed, 1)
    return model


# ---------------------------------------------------------------------------
# RG-LRU primitive
# ---------------------------------------------------------------------------
def _rglru_coeffs(rec: Recurrent, x):
    """The recurrence's a_t and b_t, f32: the gates are taken in f32 from
    products in x's dtype, as in JAX."""
    xf = x.float()
    i_gate = torch.sigmoid(F.linear(x, rec.wi_gate).float())
    r_gate = torch.sigmoid(F.linear(x, rec.wr_gate).float())
    log_a = -_C_RGLRU * F.softplus(rec.lambda_p) * r_gate
    a = torch.exp(log_a)
    norm = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, norm * (i_gate * xf)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    after the step of offset o, (a_t, b_t) composes the o' <= 2o steps that
    end at t.  f32 in, f32 out; ceil(log2 S) steps, each writing into the
    other of two buffers (``a`` and ``b`` are overwritten)."""
    s = a.shape[1]
    a2, b2 = torch.empty_like(a), torch.empty_like(b)
    off = 1
    while off < s:
        b2[:, :off] = b[:, :off]
        torch.addcmul(b[:, off:], a[:, off:], b[:, :-off], out=b2[:, off:])
        b, b2 = b2, b
        if off * 2 < s:
            a2[:, :off] = a[:, :off]
            torch.mul(a[:, off:], a[:, :-off], out=a2[:, off:])
            a, a2 = a2, a
        off *= 2
    return b


def rglru_seq(rec: Recurrent, x):
    """x: (B, S, W) -> (y (B, S, W) in x's dtype, final state (B, W) f32),
    from a zero state (the JAX ``h0``, which no caller passes, is left
    out)."""
    a, b = _rglru_coeffs(rec, x)
    h = linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rglru_step(rec: Recurrent, x, h_prev):
    a, b = _rglru_coeffs(rec, x)
    h = a * h_prev + b
    return h.to(x.dtype), h


def _conv1d_step(rec: Recurrent, x, buf):
    """x: (B, W) one token; buf (B, conv_width - 1, W) is shifted in
    place.  Returns the conv's output."""
    window = torch.cat([buf, x[:, None, :]], dim=1)            # (B, cw, W)
    out = ((window.float() * rec.conv_w.float()).sum(1).to(x.dtype)
           + rec.conv_b)
    buf.copy_(window[:, 1:])
    return out


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation, in f32."""
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def recurrent_block_seq(rec: Recurrent, x):
    """Returns (y, (final_state f32, conv_tail))."""
    gate = _gelu(F.linear(x, rec.w_gate_branch))
    h_in = F.linear(x, rec.w_in)
    h = _conv1d_seq(rec.conv_w, rec.conv_b, h_in)
    h, final_state = rglru_seq(rec, h)
    conv_tail = h_in[:, -(rec.conv_w.shape[0] - 1):, :].clone()
    return F.linear(h * gate, rec.w_out), (final_state, conv_tail)


def recurrent_block_step(rec: Recurrent, x, state, conv_buf):
    """x: (B, D) one token; state (B, W) f32 and conv_buf are updated in
    place.  Returns y."""
    gate = _gelu(F.linear(x, rec.w_gate_branch))
    h = _conv1d_step(rec, F.linear(x, rec.w_in), conv_buf)
    h, new_state = rglru_step(rec, h, state)
    state.copy_(new_state)
    return F.linear(h * gate, rec.w_out)


# ---------------------------------------------------------------------------
# Sequence blocks
# ---------------------------------------------------------------------------
def _attn_seq(p: Attention, x, rope, cfg: ArchConfig):
    """Local attention over the prompt (K5 with the config's window).
    Returns (y, (k, v)) with k, v of (B, Hkv, S, dh)."""
    b, s, _ = x.shape
    hh, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = rotate_halves(_split_heads(F.linear(x, p.wq), hh), rope)
    k = rotate_halves(_split_heads(F.linear(x, p.wk), hkv), rope)
    v = _split_heads(F.linear(x, p.wv), hkv)
    y = blockwise_attention(q, k, v, causal=True, window=cfg.rglru.window)
    y = y.transpose(1, 2).reshape(b, s, hh * dh)
    return F.linear(y, p.wo), (k, v)


def _block_seq(blk: Block, x, rope, cfg: ArchConfig):
    h = rms_norm(x, blk.ln1, cfg.norm_eps)
    if blk.kind == "attn":
        y, cache_out = _attn_seq(blk.attn, h, rope, cfg)
    else:
        y, cache_out = recurrent_block_seq(blk.rec, h)
    x = x + y
    return x + ffn_dense(blk.ffn, rms_norm(x, blk.ln2, cfg.norm_eps)), \
        cache_out


@torch.no_grad()
def forward(model: RecurrentGemma, cfg: ArchConfig, batch):
    """Returns (hidden (B, S, D), [cache output per layer]): (k, v) for an
    attention layer, (final_state, conv_tail) for a recurrent one."""
    x = F.embedding(batch["tokens"], model.embed)
    b, s, _ = x.shape
    pos = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    rope = rope_tables(pos, cfg.head_dim_, cfg.rope_theta)
    caches = []
    for blk in model.layers:
        x, cache = _block_seq(blk, x, rope, cfg)
        caches.append(cache)
    return rms_norm(x, model.ln_f, cfg.norm_eps), caches


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    layer_kinds = kinds(cfg)
    n_attn = layer_kinds.count("attn")
    n_rec = len(layer_kinds) - n_attn
    w = cfg.rglru.lru_width or cfg.d_model
    window = min(cfg.rglru.window, max_seq)
    dh, hkv = cfg.head_dim_, cfg.n_kv_heads
    return {
        "k": torch.zeros((n_attn, batch_size, window, hkv, dh), dtype=dtype,
                         device=device),
        "v": torch.zeros((n_attn, batch_size, window, hkv, dh), dtype=dtype,
                         device=device),
        "state": torch.zeros((n_rec, batch_size, w), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((n_rec, batch_size, cfg.rglru.conv_width - 1, w),
                            dtype=dtype, device=device),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def prefill(model: RecurrentGemma, cfg: ArchConfig, batch, max_seq: int):
    """Returns (last-token logits (B, V) f32, cache).  The keys and values
    go into the ring: below the window in order from slot 0; beyond it the
    last ``W`` of them, position p in slot ``p % W`` (the JAX roll)."""
    b, s = batch["tokens"].shape
    if s < cfg.rglru.conv_width - 1:
        raise ValueError(
            f"prompt of {s} tokens is shorter than conv_width - 1 = "
            f"{cfg.rglru.conv_width - 1}: its conv tail cannot fill the cache")
    hidden, caches = forward(model, cfg, batch)
    logits = logits_f32(model, hidden[:, -1, :])
    attn = [c for blk, c in zip(model.layers, caches) if blk.kind == "attn"]
    rec = [c for blk, c in zip(model.layers, caches) if blk.kind != "attn"]
    cache = init_cache(cfg, b, max_seq, dtype=hidden.dtype,
                       device=hidden.device)
    window = cache["k"].shape[2]
    slots = torch.arange(max(s - window, 0), s, device=hidden.device) % window
    for i, (k, v) in enumerate(attn):    # (B, Hkv, S, dh) -> ring slots
        cache["k"][i][:, slots] = k.transpose(1, 2)[:, -window:]
        cache["v"][i][:, slots] = v.transpose(1, 2)[:, -window:]
    for i, (state, tail) in enumerate(rec):
        cache["state"][i] = state
        cache["conv"][i] = tail
    cache["len"].fill_(s)
    return logits, cache


def _decode_attn(p: Attention, x, rope, cfg: ArchConfig, cache_k, cache_v,
                 kv_len):
    """x: (B, D) one token; cache_k/v: (B, W, Hkv, dh) rings, written in
    place at ``kv_len % W``; K6 reads ``min(kv_len + 1, W)`` slots."""
    b, _ = x.shape
    hh, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    window = cache_k.shape[1]
    q = F.linear(x, p.wq).view(b, hh, dh)
    k = F.linear(x, p.wk).view(b, hkv, dh)
    v = F.linear(x, p.wv).view(b, hkv, dh)
    q = rotate_halves(q[:, :, None, :], rope)[:, :, 0, :]
    k = rotate_halves(k[:, :, None, :], rope)[:, :, 0, :]
    rows = torch.arange(b, device=x.device)
    slot = kv_len % window
    cache_k[rows, slot] = k
    cache_v[rows, slot] = v
    n_valid = torch.clamp(kv_len + 1, max=window)
    y = decode_attention(q, cache_k.transpose(1, 2), cache_v.transpose(1, 2),
                         n_valid)
    return F.linear(y.reshape(b, hh * dh), p.wo)


@torch.no_grad()
def decode_step(model: RecurrentGemma, cfg: ArchConfig, cache, tokens,
                positions=None):
    """One decode step.  tokens: (B,) integers.  Returns (logits (B, V)
    f32, cache) — the ring, state and conv written in place."""
    x = F.embedding(tokens, model.embed)
    kv_len = cache["len"]
    rope = rope_tables(kv_len[:, None], cfg.head_dim_, cfg.rope_theta)
    ai = ri = 0
    for blk in model.layers:
        h = rms_norm(x, blk.ln1, cfg.norm_eps)
        if blk.kind == "attn":
            y = _decode_attn(blk.attn, h, rope, cfg, cache["k"][ai],
                             cache["v"][ai], kv_len)
            ai += 1
        else:
            y = recurrent_block_step(blk.rec, h, cache["state"][ri],
                                     cache["conv"][ri])
            ri += 1
        x = x + y
        x = x + ffn_dense(blk.ffn, rms_norm(x, blk.ln2, cfg.norm_eps))
    logits = logits_f32(model, rms_norm(x, model.ln_f, cfg.norm_eps))
    return logits, {"k": cache["k"], "v": cache["v"],
                    "state": cache["state"], "conv": cache["conv"],
                    "len": kv_len + 1}
