"""Carry the JAX package's weights across to the port.

New in the port (the tests use it to feed one set of weights to both
packages).  :func:`from_jax` takes the parameter tree of
``repro.models.api.init_params`` for a dense or ssm config, as numpy
arrays (``jax.tree.map(np.asarray, params)``; bfloat16 arrays are read
through their raw bits), and returns the port's model of that family
(``transformer.Transformer`` or ``ssm.Mamba2``): the stacked ``layers``
leaves are split along L, the ``(d_in, d_out)`` projection kernels
transposed to the port's ``(d_out, d_in)``, and every other leaf (the
ssm ``conv_w`` among them) kept in its layout and dtype, f32 leaves
f32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import ssm, transformer
from .api import resolve_device
from .config import ArchConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _put(dst, src, transpose=False):
    t = _tensor(src)
    if tuple(t.shape[::-1] if transpose else t.shape) != tuple(dst.shape):
        raise ValueError(f"shape {tuple(t.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    dst.copy_(t.T if transpose else t)


def _dense_layer(lp, layers, i):
    _put(lp.ln1, layers["ln1"][i])
    _put(lp.ln2, layers["ln2"][i])
    for name in ("wq", "wk", "wv", "wo"):
        _put(getattr(lp.attn, name), layers["attn"][name][i], True)
    for name in ("bq", "bk", "bv"):
        if getattr(lp.attn, name) is not None:
            _put(getattr(lp.attn, name), layers["attn"][name][i])
    for name in ("w_gate", "w_up", "w_down"):
        _put(getattr(lp.ffn, name), layers["ffn"][name][i], True)


def _ssm_layer(lp, layers, i):
    for name in ("ln", "conv_w", "conv_b", "dt_bias", "a_log", "d_skip",
                 "gn"):
        _put(getattr(lp, name), layers[name][i])
    for name in ("w_in", "w_out"):
        _put(getattr(lp, name), layers[name][i], True)


_FAMILIES = {"dense": (transformer.Transformer, _dense_layer),
             "ssm": (ssm.Mamba2, _ssm_layer)}


def from_jax(cfg: ArchConfig, params, device=None):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"{cfg.name}: no conversion for the "
                                  f"{cfg.family} family")
    cls, put_layer = _FAMILIES[cfg.family]
    model = cls(cfg, resolve_device(device))
    with torch.no_grad():
        _put(model.embed, params["embed"])
        _put(model.ln_f, params["ln_f"])
        if model.unembed is not None:
            _put(model.unembed, params["unembed"])
        for i, lp in enumerate(model.layers):
            put_layer(lp, params["layers"], i)
    return model
