"""Family-dispatching model API, for inference.

Port of ``repro.models.api``:

    init_params(cfg, seed, device)           -> model (nn.Module)
    prefill(params, cfg, batch, max_seq)     -> (last-token logits, cache)
    decode_step(params, cfg, cache, toks)    -> (logits, cache)
    init_cache(cfg, batch, max_seq, device)  -> zeroed cache dict

``init_params`` takes an integer seed where the JAX function takes a key.
The dense and ssm families are ported; ``moe`` and ``mla`` raise in
``transformer.Transformer``, ``rglru`` here, until their slices (ROADMAP
queue 1).  ``loss_fn`` waits for the training slice.  Entry
points run on the card unless the caller passes ``device="cpu"``; without
a card and without that request they raise.
"""
from __future__ import annotations

import torch

from . import ssm, transformer
from .config import ArchConfig

_FAMS = {"dense": transformer, "moe": transformer, "mla": transformer,
         "ssm": ssm}


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names another device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the model runs on the card; pass "
                "device='cpu' to run the kernels' plain versions")
        return torch.device("cuda")
    return torch.device(device)


def _mod(cfg: ArchConfig):
    if cfg.family not in _FAMS:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet "
            "(ROADMAP queue 1: rglru, with a windowed K6)")
    return _FAMS[cfg.family]


def init_params(cfg: ArchConfig, seed: int = 0, device=None):
    device = resolve_device(device)
    mod = _mod(cfg)
    generator = torch.Generator(device=device).manual_seed(seed)
    return mod.init_params(cfg, generator, device)


def prefill(params, cfg: ArchConfig, batch, max_seq: int):
    return _mod(cfg).prefill(params, cfg, batch, max_seq)


def decode_step(params, cfg: ArchConfig, cache, tokens, positions=None):
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: no decode step")
    return _mod(cfg).decode_step(params, cfg, cache, tokens, positions)


def init_cache(cfg: ArchConfig, batch_size: int, max_seq: int,
               dtype=torch.bfloat16, device=None):
    return _mod(cfg).init_cache(cfg, batch_size, max_seq, dtype,
                                resolve_device(device))
