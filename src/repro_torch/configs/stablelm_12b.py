"""stablelm-12b [dense]: 40L d=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.
[hf:stabilityai/stablelm-2-1_6b (family); scaled per assignment]"""
from ..models.config import ArchConfig

ARCH_ID = "stablelm-12b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, d_ff=13824, vocab=100352)


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=3, d_model=80,
        n_heads=4, n_kv_heads=2, d_ff=192, vocab=128,
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
