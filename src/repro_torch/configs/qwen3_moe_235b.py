"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4, head_dim=128)
vocab=151936; 128 experts top-8, d_ff_expert=1536.
[hf:Qwen/Qwen3-30B-A3B (family); scaled per assignment]"""
from ..models.config import ArchConfig, MoEConfig

ARCH_ID = "qwen3-moe-235b-a22b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="moe", n_layers=94, d_model=4096,
        n_heads=64, n_kv_heads=4, d_ff=0, vocab=151936, head_dim=128,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536))


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="moe", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=0, vocab=128, head_dim=16,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, router_groups=4),
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
