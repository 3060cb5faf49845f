"""Mamba-2 (SSD, state-space duality), the attention-free family, for
inference.

Port of ``repro.models.ssm`` (``_dims``, ``_init_layer``/``init_params``,
``_conv1d_seq``, ``_layer_seq``, ``forward`` without the loss,
``init_cache``, ``prefill``, ``_layer_step`` and ``decode_step``).
Parameters are ``nn.Module``s, one :class:`Layer` per layer in an
``nn.ModuleList``; the projections are kept as ``(d_out, d_in)`` for
``F.linear`` (``models.convert`` transposes the JAX kernels), while
``conv_w`` keeps the JAX ``(d_conv, conv_ch)`` layout and its fan-in of
``d_conv``.  ``dt_bias``, ``a_log`` and ``d_skip`` are f32 whatever the
weights' dtype, as in JAX.

The JAX model runs its prefill scan in jnp (``ssd_chunked``) and notes
that the Pallas kernel is the same decomposition; the port makes that
swap: the scan of every layer is K7 (``kernels.ssd``), which also returns
the final state the cache keeps.  The config's ``chunk`` has no
counterpart: the kernel picks its own chunk and masks a ragged last one.

The cache keeps the JAX layout: ``state`` (L, B, H, N, P) f32, ``conv``
(L, B, d_conv - 1, conv_ch) holding the last pre-conv inputs, ``len``
(B,) int32.  :func:`decode_step` updates ``state`` and ``conv`` **in
place** and returns the same tensors with ``len + 1``.  A prompt shorter
than ``d_conv - 1`` tokens raises ``ValueError``: its conv tail would be
short, and the JAX engine then fails on the slot write.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ssd as _ssd
from .common import dense_init, logits_f32, rms_norm
from .config import ArchConfig
from .transformer import _param


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.d_state
    return d_in, n_heads, conv_ch


class Layer(nn.Module):
    def __init__(self, cfg: ArchConfig, dtype, device):
        super().__init__()
        d, s = cfg.d_model, cfg.ssm
        d_in, h, conv_ch = _dims(cfg)
        f32 = torch.float32
        self.ln = _param((d,), dtype, device)
        self.w_in = _param((2 * d_in + 2 * s.d_state + h, d), dtype, device)
        self.conv_w = _param((s.d_conv, conv_ch), dtype, device)
        self.conv_b = _param((conv_ch,), dtype, device)
        self.dt_bias = _param((h,), f32, device)
        self.a_log = _param((h,), f32, device)
        self.d_skip = _param((h,), f32, device)
        self.gn = _param((d_in,), dtype, device)      # gated RMSNorm scale
        self.w_out = _param((d, d_in), dtype, device)


class Mamba2(nn.Module):
    """The parameters of one SSM model, uninitialised (see
    :func:`init_params` and ``models.convert.from_jax``)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        dtype = getattr(torch, cfg.param_dtype)
        vp, d = cfg.vocab_padded, cfg.d_model
        self.embed = _param((vp, d), dtype, device)
        self.ln_f = _param((d,), dtype, device)
        self.unembed = (None if cfg.tie_embeddings
                        else _param((vp, d), dtype, device))
        self.layers = nn.ModuleList(Layer(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Mamba2:
    """Random weights as the JAX ``init_params`` draws them: truncated
    normal / sqrt(fan_in) (fan-in d for ``w_in``, d_inner for ``w_out``,
    d_conv for ``conv_w``), ``a_log = log(linspace(1, 16, H))``,
    ``d_skip`` ones, norms, biases and ``dt_bias`` zero."""
    model = Mamba2(cfg, device)
    h = _dims(cfg)[1]

    def fill(p, in_axis):
        p.copy_(dense_init(tuple(p.shape), generator=generator,
                           in_axis=in_axis, dtype=p.dtype, device=device))

    with torch.no_grad():
        fill(model.embed, 1)
        for lp in model.layers:
            fill(lp.w_in, 1)            # (d_out, d_in): fan_in is axis 1
            fill(lp.conv_w, 0)          # (d_conv, conv_ch): fan_in d_conv
            fill(lp.w_out, 1)
            for z in (lp.ln, lp.conv_b, lp.dt_bias, lp.gn):
                z.zero_()
            lp.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
            lp.d_skip.fill_(1.0)
        model.ln_f.zero_()
        if model.unembed is not None:
            fill(model.unembed, 1)
    return model


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
def _conv1d_seq(w, bias, x):
    """Causal depthwise conv.  x: (B, S, C); w: (cw, C)."""
    out = x * w[-1]
    for i in range(1, w.shape[0]):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1], :]
        out = out + shifted * w[w.shape[0] - 1 - i]
    return out + bias


def _gate_out(lp: Layer, x, y, z, cfg: ArchConfig):
    """The gated RMSNorm of y by silu(z), the out-projection and the
    residual."""
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), lp.gn, cfg.norm_eps)
    return x + F.linear(y, lp.w_out)


def _layer_seq(lp: Layer, x, cfg: ArchConfig):
    """Returns (x_out, (final_state, conv_tail))."""
    s_cfg = cfg.ssm
    d_in, h, conv_ch = _dims(cfg)
    n = s_cfg.d_state
    bsz, s, _ = x.shape
    proj = F.linear(rms_norm(x, lp.ln, cfg.norm_eps), lp.w_in)
    z, xbc, dt_raw = proj.split([d_in, conv_ch, h], dim=-1)
    conv_tail = xbc[:, -(s_cfg.d_conv - 1):, :].clone()
    xbc = F.silu(_conv1d_seq(lp.conv_w, lp.conv_b, xbc).float()).to(x.dtype)
    xs, b, c = xbc.split([d_in, n, n], dim=-1)
    xs = xs.reshape(bsz, s, h, s_cfg.head_dim)    # a view: K7 reads strides
    dt = F.softplus(dt_raw.float() + lp.dt_bias)
    a = -torch.exp(lp.a_log)
    y, final_state = _ssd.ssd(xs, dt, a, b, c)
    y = y + (xs.float() * lp.d_skip[None, None, :, None]).to(y.dtype)
    return _gate_out(lp, x, y.reshape(bsz, s, d_in), z, cfg), \
        (final_state, conv_tail)


def _layer_step(lp: Layer, x, state, conv_buf, cfg: ArchConfig):
    """x: (B, D) one token; state (B, H, N, P) and conv_buf
    (B, d_conv - 1, conv_ch) are updated in place.  Returns x_out."""
    s_cfg = cfg.ssm
    d_in, h, conv_ch = _dims(cfg)
    n = s_cfg.d_state
    bsz = x.shape[0]
    proj = F.linear(rms_norm(x, lp.ln, cfg.norm_eps), lp.w_in)
    z, xbc, dt_raw = proj.split([d_in, conv_ch, h], dim=-1)
    window = torch.cat([conv_buf, xbc[:, None, :]], dim=1)     # (B, cw, C)
    conv_out = ((window.float() * lp.conv_w.float()).sum(1).to(x.dtype)
                + lp.conv_b)
    conv_buf.copy_(window[:, 1:])
    xbc = F.silu(conv_out.float()).to(x.dtype)
    xs, b, c = xbc.split([d_in, n, n], dim=-1)
    xs = xs.reshape(bsz, h, s_cfg.head_dim).float()
    dt = F.softplus(dt_raw.float() + lp.dt_bias)               # (B, H)
    decay = torch.exp(dt * -torch.exp(lp.a_log)[None, :])
    # state <- state * decay + b (x) (x dt), in place
    state.mul_(decay[..., None, None]).addcmul_(
        b.float()[:, None, :, None], (xs * dt[..., None])[:, :, None, :])
    y = torch.matmul(c.float()[:, None, None, :], state)[:, :, 0]  # (B,H,P)
    y = y + xs * lp.d_skip[None, :, None]
    return _gate_out(lp, x, y.reshape(bsz, d_in).to(x.dtype), z, cfg)


# ---------------------------------------------------------------------------
# Full model: forward / prefill / decode
# ---------------------------------------------------------------------------
@torch.no_grad()
def forward(model: Mamba2, cfg: ArchConfig, batch):
    """Returns (hidden (B, S, D), [(final_state, conv_tail) per layer])."""
    x = F.embedding(batch["tokens"], model.embed)
    caches = []
    for lp in model.layers:
        x, cache = _layer_seq(lp, x, cfg)
        caches.append(cache)
    return rms_norm(x, model.ln_f, cfg.norm_eps), caches


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed state and conv tail; neither grows with ``max_seq``."""
    s_cfg = cfg.ssm
    d_in, h, conv_ch = _dims(cfg)
    return {
        "state": torch.zeros((cfg.n_layers, batch_size, h, s_cfg.d_state,
                              s_cfg.head_dim), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((cfg.n_layers, batch_size, s_cfg.d_conv - 1,
                             conv_ch), dtype=dtype, device=device),
        "len": torch.zeros((batch_size,), dtype=torch.int32, device=device),
    }


@torch.no_grad()
def prefill(model: Mamba2, cfg: ArchConfig, batch, max_seq: int):
    """Returns (last-token logits (B, V) f32, cache); the cache holds each
    layer's final state and pre-conv tail."""
    b, s = batch["tokens"].shape
    if s < cfg.ssm.d_conv - 1:
        raise ValueError(
            f"prompt of {s} tokens is shorter than d_conv - 1 = "
            f"{cfg.ssm.d_conv - 1}: its conv tail cannot fill the cache")
    hidden, caches = forward(model, cfg, batch)
    logits = logits_f32(model, hidden[:, -1, :])
    cache = {"state": torch.stack([st for st, _ in caches]),
             "conv": torch.stack([tail for _, tail in caches]),
             "len": torch.full((b,), s, dtype=torch.int32,
                               device=hidden.device)}
    return logits, cache


@torch.no_grad()
def decode_step(model: Mamba2, cfg: ArchConfig, cache, tokens,
                positions=None):
    """One decode step.  tokens: (B,) integers.  Returns (logits (B, V)
    f32, cache) — the cache's state and conv updated in place."""
    x = F.embedding(tokens, model.embed)
    for i, lp in enumerate(model.layers):
        x = _layer_step(lp, x, cache["state"][i], cache["conv"][i], cfg)
    logits = logits_f32(model, rms_norm(x, model.ln_f, cfg.norm_eps))
    return logits, {"state": cache["state"], "conv": cache["conv"],
                    "len": cache["len"] + 1}
