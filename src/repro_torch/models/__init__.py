"""Model zoo, for inference: the dense and ssm families so far.

Port of ``repro.models`` (see ``api`` for what is ported).
"""
from . import api  # noqa: F401
from .config import (  # noqa: F401
    ArchConfig, MLAConfig, MoEConfig, RGLRUConfig, SSMConfig,
)
