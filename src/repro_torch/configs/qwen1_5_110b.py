"""qwen1.5-110b [dense]: 80L d=8192 64H (GQA kv=8) d_ff=49152 vocab=152064,
QKV bias.  [hf:Qwen/Qwen1.5-0.5B (family); scaled per assignment]"""
from ..models.config import ArchConfig

ARCH_ID = "qwen1.5-110b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=49152, vocab=152064, qkv_bias=True)


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab=128, qkv_bias=True,
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
