"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064;
M-RoPE (t/h/w rotary sections), QKV bias.  The vision tower is a stub —
``input_specs`` feeds precomputed patch/text embeddings.  [arXiv:2409.12191]"""
from ..models.config import ArchConfig

ARCH_ID = "qwen2-vl-72b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=29568, vocab=152064,
        qkv_bias=True, mrope=True, inputs="embeddings")


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=160, vocab=128,
        qkv_bias=True, mrope=True, inputs="embeddings",
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
