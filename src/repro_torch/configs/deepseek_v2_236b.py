"""deepseek-v2-236b [moe]: 60L d=5120 128H MLA (kv_lora=512) vocab=102400;
MoE: 2 shared + 160 routed experts, top-6, d_ff_expert=1536; first layer is
a dense FFN (d_ff=12288).  [arXiv:2405.04434]"""
from ..models.config import ArchConfig, MLAConfig, MoEConfig

ARCH_ID = "deepseek-v2-236b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID, family="mla", n_layers=60, d_model=5120,
        n_heads=128, n_kv_heads=128, d_ff=0, vocab=102400, head_dim=128,
        mla=MLAConfig(kv_lora=512, q_lora=1536, d_nope=128, d_rope=64,
                      v_head_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2,
                      n_dense_layers=1, d_ff_dense=12288))


def reduced() -> ArchConfig:
    return ArchConfig(
        name=ARCH_ID + "-smoke", family="mla", n_layers=3, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=0, vocab=128, head_dim=16,
        mla=MLAConfig(kv_lora=32, q_lora=48, d_nope=16, d_rope=8,
                      v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                      n_dense_layers=1, d_ff_dense=128, router_groups=4),
        attn_q_chunk=32, attn_k_chunk=32, loss_chunk=64)
