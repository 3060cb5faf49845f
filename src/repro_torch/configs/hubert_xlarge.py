"""hubert-xlarge [audio]: 48L d=1280 16H (kv=16) d_ff=5120 vocab=504.
Encoder-only; the conv waveform frontend is a stub — ``input_specs`` feeds
precomputed frame embeddings (B, S, d_model).  [arXiv:2106.07447]"""
from ..models.config import ArchConfig

ARCH_ID = "hubert-xlarge"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="dense", n_layers=48, d_model=1280,
        n_heads=16, n_kv_heads=16, d_ff=5120, vocab=504,
        encoder_only=True, inputs="embeddings", rope_theta=1e4)


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="dense", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=128, vocab=96,
        encoder_only=True, inputs="embeddings", rope_theta=1e4,
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
