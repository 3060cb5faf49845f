"""recurrentgemma-9b [hybrid]: 38L d=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + 2048-window local attention, 2:1 pattern.
[arXiv:2402.19427]"""
from ..models.config import ArchConfig, RGLRUConfig

ARCH_ID = "recurrentgemma-9b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="rglru", n_layers=38, d_model=4096,
        n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000,
        rglru=RGLRUConfig(window=2048), rope_theta=1e4)


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="rglru", n_layers=5, d_model=64,
        n_heads=4, n_kv_heads=1, d_ff=160, vocab=128,
        rglru=RGLRUConfig(window=32, lru_width=64), rope_theta=1e4,
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
