"""Carry the JAX package's weights across to the port.

New in the port (the tests use it to feed one set of weights to both
packages).  :func:`from_jax` takes the parameter tree of
``repro.models.api.init_params`` for a dense, ssm or rglru config, as
numpy arrays (``jax.tree.map(np.asarray, params)``; bfloat16 arrays are
read through their raw bits), and returns the port's model of that family
(``transformer.Transformer``, ``ssm.Mamba2`` or
``rglru.RecurrentGemma``): the stacked ``layers`` leaves are split along
L (for rglru, the ``super`` stack's ``{kind}_{i}`` blocks along the
super-blocks, then the ``tail`` stack's, in layer order), the
``(d_in, d_out)`` projection kernels transposed to the port's
``(d_out, d_in)``, and every other leaf (the ``conv_w`` of ssm and rglru
among them) kept in its layout and dtype, f32 leaves f32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rglru, ssm, transformer
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


def _rglru_block(blk, tree, i):
    """One rglru block from the ``{kind}_{i}`` tree of a JAX stack, at
    index i of its leading axis."""
    _put(blk.ln1, tree["ln1"][i])
    _put(blk.ln2, tree["ln2"][i])
    for name in ("w_gate", "w_up", "w_down"):
        _put(getattr(blk.ffn, name), tree["ffn"][name][i], True)
    if blk.kind == "attn":
        for name in ("wq", "wk", "wv", "wo"):
            _put(getattr(blk.attn, name), tree["attn"][name][i], True)
        return
    rec = tree["rec"]
    for name in ("conv_w", "conv_b", "lambda_p"):
        _put(getattr(blk.rec, name), rec[name][i])
    for name in ("w_in", "w_gate_branch", "wi_gate", "wr_gate", "w_out"):
        _put(getattr(blk.rec, name), rec[name][i], True)


def _rglru_layers(cfg: ArchConfig, params):
    """(tree, index) of each layer in layer order: the super-blocks, then
    the tail."""
    pat = cfg.rglru.pattern
    n_super = cfg.n_layers // len(pat)
    for layer in range(cfg.n_layers):
        sb, i = divmod(layer, len(pat))
        if sb < n_super:
            yield params["super"][f"{pat[i]}_{i}"], sb
        else:
            yield params["tail"][f"{pat[i]}_{i}"], 0


_FAMILIES = {"dense": (transformer.Transformer, _dense_layer),
             "ssm": (ssm.Mamba2, _ssm_layer),
             "rglru": (rglru.RecurrentGemma, _rglru_block)}


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
        if cfg.family == "rglru":
            for lp, (tree, i) in zip(model.layers, _rglru_layers(cfg, params)):
                put_layer(lp, tree, i)
        else:
            for i, lp in enumerate(model.layers):
                put_layer(lp, params["layers"], i)
    return model
