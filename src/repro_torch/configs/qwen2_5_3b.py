"""qwen2.5-3b [dense]: 36L d=2048 16H (GQA kv=2) d_ff=11008 vocab=151936,
QKV bias.  [hf:Qwen/Qwen2.5-0.5B (family); scaled per assignment]"""
from ..models.config import ArchConfig

ARCH_ID = "qwen2.5-3b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936, qkv_bias=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=176, vocab=128, qkv_bias=True,
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
