"""Architecture registry: ``--arch <id>`` resolution.

Port of ``repro.configs``: the ten arch modules are copied as data, so the
port never imports the JAX package's registry.  Every assigned
architecture is a module with ``config()`` (the exact published dims) and
``reduced()`` (a small same-family config for CPU smoke tests).  The
dry-run's per-cell skip rules (``applicable``, ``all_cells``) come with
the dry-run's port (ROADMAP queue 1).
"""
from __future__ import annotations

from ..models.config import ArchConfig

from . import (
    command_r_plus_104b, deepseek_v2_236b, hubert_xlarge, mamba2_2_7b,
    qwen1_5_110b, qwen2_5_3b, qwen2_vl_72b, qwen3_moe_235b,
    recurrentgemma_9b, stablelm_12b,
)

_MODULES = (
    hubert_xlarge, qwen1_5_110b, stablelm_12b, command_r_plus_104b,
    qwen2_5_3b, recurrentgemma_9b, deepseek_v2_236b, qwen3_moe_235b,
    qwen2_vl_72b, mamba2_2_7b,
)

ARCHS = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(ARCHS)


def get_config(arch_id: str) -> ArchConfig:
    return ARCHS[arch_id].config()


def get_reduced(arch_id: str) -> ArchConfig:
    return ARCHS[arch_id].reduced()
