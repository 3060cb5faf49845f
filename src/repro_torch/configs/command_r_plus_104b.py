"""command-r-plus-104b [dense]: 64L d=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, no bias.  [hf:CohereForAI/c4ai-command-r-v01 (family)]"""
from ..models.config import ArchConfig

ARCH_ID = "command-r-plus-104b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=64, d_model=12288,
        n_heads=96, n_kv_heads=8, d_ff=33792, vocab=256000)


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=3, d_model=96,
        n_heads=6, n_kv_heads=2, d_ff=256, vocab=160,
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
