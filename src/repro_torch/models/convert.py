"""Carry the JAX package's weights across to the port.

New in the port (the tests use it to feed one set of weights to both
packages).  :func:`from_jax` takes the parameter tree of
``repro.models.api.init_params`` for a dense config, as numpy arrays
(``jax.tree.map(np.asarray, params)``; bfloat16 arrays are read through
their raw bits), and returns the port's ``transformer.Transformer``: the
stacked ``layers`` leaves are split along L, and the ``(d_in, d_out)``
kernels transposed to the port's ``(d_out, d_in)``.
"""
from __future__ import annotations

import numpy as np
import torch

from . import transformer
from .api import resolve_device
from .config import ArchConfig


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax(cfg: ArchConfig, params, device=None) -> transformer.Transformer:
    model = transformer.Transformer(cfg, resolve_device(device))

    def put(dst, src, transpose=False):
        t = _tensor(src)
        if tuple(t.shape[::-1] if transpose else t.shape) != tuple(dst.shape):
            raise ValueError(f"shape {tuple(t.shape)} does not fit "
                             f"{tuple(dst.shape)}")
        dst.copy_(t.T if transpose else t)

    with torch.no_grad():
        put(model.embed, params["embed"])
        put(model.ln_f, params["ln_f"])
        if model.unembed is not None:
            put(model.unembed, params["unembed"])
        layers = params["layers"]
        for i, lp in enumerate(model.layers):
            put(lp.ln1, layers["ln1"][i])
            put(lp.ln2, layers["ln2"][i])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(lp.attn, name), layers["attn"][name][i], True)
            for name in ("bq", "bk", "bv"):
                if getattr(lp.attn, name) is not None:
                    put(getattr(lp.attn, name), layers["attn"][name][i])
            for name in ("w_gate", "w_up", "w_down"):
                put(getattr(lp.ffn, name), layers["ffn"][name][i], True)
    return model
