"""mamba2-2.7b [ssm]: 64L d=2560 (attention-free) vocab=50280;
SSD with state=128, head_dim=64, expand=2.  [arXiv:2405.21060]"""
from ..models.config import ArchConfig, SSMConfig

ARCH_ID = "mamba2-2.7b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256))


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="ssm", n_layers=3, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=128,
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, chunk=32),
        loss_chunk=64)
