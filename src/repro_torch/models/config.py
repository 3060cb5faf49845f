"""Architecture + shape configuration for every assigned model family.

Port of ``repro.models.config`` (``ArchConfig``, its sub-configs and
``param_count``), copied field for field (the tests compare the two).  The
XLA-only knobs (``remat``, ``attn_*_chunk``, ``exact_count``,
``scan_repeats``) are kept so that configs stay equal; the port reads none
of them.  The dry-run's ``ShapeConfig`` and ``active_param_count`` come
with the dry-run's port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    n_dense_layers: int = 0          # leading dense-FFN layers (deepseek-v2)
    d_ff_dense: int = 0              # their intermediate size
    router_groups: int = 64          # token groups for sorted dispatch
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora: int = 512
    q_lora: int = 1536
    d_nope: int = 128
    d_rope: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")  # Griffin 2:1
    conv_width: int = 4
    lru_width: int = 0               # 0 -> d_model
    window: int = 2048               # local-attention window


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64               # SSD P
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256                 # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | mla | rglru | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    encoder_only: bool = False       # bidirectional, no decode entry point
    inputs: str = "tokens"           # "tokens" | "embeddings" (audio/vlm stubs)
    mrope: bool = False              # Qwen2-VL multimodal rotary (3 sections)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    ssm: Optional[SSMConfig] = None
    # numerics / execution
    param_dtype: str = "bfloat16"
    remat: bool = True
    loss_chunk: int = 8192           # vocab-softmax token chunking
    attn_q_chunk: int = 512          # blockwise-attention tile sizes (XLA path)
    attn_k_chunk: int = 1024
    # --- dry-run accounting knobs (see launch/dryrun.py) -------------------
    # XLA cost_analysis counts a while-loop body once; exact_count unrolls
    # the *inner* scans (attention pairs, SSD chunks, loss chunks) so they
    # are counted fully, and scan_repeats=2 runs each layer stack twice so
    # the cost delta isolates exactly one layer body.
    exact_count: bool = False
    scan_repeats: int = 1

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, l = self.d_model, self.n_layers
        dh = self.head_dim_ if self.n_heads else 0
        emb = self.vocab_padded * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            nh = d_in // s.head_dim
            per = (d * (2 * d_in + 2 * s.d_state + nh)   # in_proj (z,x,B,C,dt)
                   + s.d_conv * (d_in + 2 * s.d_state)   # conv
                   + 2 * nh                              # A_log, D
                   + d_in                                # gated-norm scale
                   + d_in * d + d)                       # out_proj + norm
            return emb + l * per
        if self.family == "mla":
            m, q = self.mla, self.moe
            attn = (d * m.q_lora + m.q_lora * self.n_heads * (m.d_nope + m.d_rope)
                    + d * (m.kv_lora + m.d_rope)
                    + m.kv_lora * self.n_heads * (m.d_nope + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
            moe_ffn = 3 * d * q.d_ff_expert * (q.n_experts + q.n_shared) + d * q.n_experts
            dense_ffn = 3 * d * q.d_ff_dense
            per_moe = attn + moe_ffn + 2 * d
            per_dense = attn + dense_ffn + 2 * d
            return emb + q.n_dense_layers * per_dense + (l - q.n_dense_layers) * per_moe
        if self.family == "moe":
            q = self.moe
            attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                + self.n_heads * dh * d
            ffn = 3 * d * q.d_ff_expert * (q.n_experts + q.n_shared) + d * q.n_experts
            return emb + l * (attn + ffn + 2 * d)
        if self.family == "rglru":
            r = self.rglru
            w = r.lru_width or d
            n_attn = sum(1 for i in range(l) if r.pattern[i % len(r.pattern)] == "attn")
            n_rec = l - n_attn
            attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
                + self.n_heads * dh * d
            rec = 2 * d * w + r.conv_width * w + 3 * w + w * d  # in(x2), conv, gates, out
            ffn = 3 * d * self.d_ff
            return emb + n_attn * (attn + ffn + 2 * d) + n_rec * (rec + ffn + 2 * d)
        # dense
        attn = d * self.n_heads * dh + 2 * d * self.n_kv_heads * dh \
            + self.n_heads * dh * d
        ffn = 3 * d * self.d_ff
        return emb + l * (attn + ffn + 2 * d)
