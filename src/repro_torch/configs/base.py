"""Architecture config schema + the assigned input-shape set (a copy of
``repro.configs.base``; the port imports nothing of the JAX package).

Every assigned architecture gets one ``configs/<id>.py`` exporting CONFIG
(exact literature numbers) and SMOKE (reduced same-family config for CPU
tests). Shapes are global; the launcher maps them onto the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_norm_topk: bool = True
    every: int = 1              # MoE every k-th layer (jamba: 2)
    first_dense: int = 0        # leading dense layers (deepseek-v2: 1)
    impl: str = "dense"         # "dense" (einsum) | "ep" (shard_map all_to_all)
    chunks: int = 1             # pipelined dispatch slabs (paper §4.3.2)


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"
    qkv_bias: bool = False
    rope_base: float = 10000.0
    norm: str = "rms"           # rms | ln
    norm_plus_one: bool = False  # gemma RMSNorm (1 + w)
    embed_scale: bool = False    # gemma scales embeddings by sqrt(d)
    attn_kind: str = "gqa"      # gqa | mla
    mla: Optional[MLACfg] = None
    moe: Optional[MoECfg] = None
    mixer: str = "attn"         # attn | rwkv | hybrid(jamba)
    hybrid_period: int = 8      # jamba: 1 attn per 8 layers
    hybrid_attn_pos: int = 4
    mamba: Optional[MambaCfg] = None
    encdec: bool = False        # whisper
    enc_layers: int = 0
    embed_mode: str = "tokens"  # tokens | embeds (vlm) | frames (audio stub)
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: bool = True
    train_microbatches: int = 1   # gradient accumulation (memory-term knob)
    kv_quant: bool = False        # int8 KV cache for decode (uniform GQA path)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context? (SSM / hybrid only)"""
        return self.mixer in ("rwkv", "hybrid")

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Skip rules per the assignment: long_500k needs sub-quadratic attention;
    encoder-only archs would skip decode (none assigned are encoder-only)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skipped_full_attention"
    return True, "ok"


def count_params(cfg: ArchConfig) -> int:
    """Analytic parameter count (total, incl. all experts)."""
    d, v, hd = cfg.d_model, cfg.vocab, cfg.head_dim_
    n_attn_per_layer = d * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) + cfg.n_heads * hd * d
    if cfg.attn_kind == "mla":
        m = cfg.mla
        qd = m.qk_nope_dim + m.qk_rope_dim
        n_attn_per_layer = (d * cfg.n_heads * qd + d * m.kv_lora_rank
                            + d * m.qk_rope_dim
                            + m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
                            + cfg.n_heads * m.v_head_dim * d)
    glu = cfg.mlp_type in ("swiglu", "geglu")
    mlp = d * cfg.d_ff * (3 if glu else 2)
    total = 0
    if cfg.mixer == "rwkv":
        tm = 5 * d + d + 2 * 64 * d + d + 5 * d * d + 2 * d
        cm = 2 * d + 2 * d * cfg.d_ff + d * d
        total += cfg.n_layers * (tm + cm + 2 * d)
    elif cfg.mixer == "hybrid":
        # MambaDims (models/mamba.py) of the JAX package, inline
        di = cfg.mamba.expand * d
        dt_rank = max(1, -(-d // 16))
        d_state, d_conv = cfg.mamba.d_state, cfg.mamba.d_conv
        mam = (d * 2 * di + d_conv * di + di
               + di * (dt_rank + 2 * d_state) + dt_rank * di + di
               + di * d_state + di + di * d)
        n_attn = cfg.n_layers // cfg.hybrid_period
        n_mamba = cfg.n_layers - n_attn
        total += n_attn * n_attn_per_layer + n_mamba * mam
        n_moe = cfg.n_layers // (cfg.moe.every if cfg.moe else 1) if cfg.moe else 0
        n_dense = cfg.n_layers - n_moe
        moe_p = (d * cfg.moe.n_experts
                 + cfg.moe.n_experts * 3 * d * cfg.moe.d_ff_expert) if cfg.moe else 0
        total += n_moe * moe_p + n_dense * mlp + cfg.n_layers * 2 * d
    else:
        n_moe = 0
        if cfg.moe:
            n_moe = (cfg.n_layers - cfg.moe.first_dense) // cfg.moe.every
        n_dense = cfg.n_layers - n_moe
        moe_p = 0
        if cfg.moe:
            moe_p = (d * cfg.moe.n_experts
                     + cfg.moe.n_experts * 3 * d * cfg.moe.d_ff_expert)
            if cfg.moe.n_shared:
                moe_p += 3 * d * (cfg.moe.d_ff_shared or cfg.moe.n_shared * cfg.moe.d_ff_expert)
        total += (cfg.n_layers * (n_attn_per_layer + 2 * d)
                  + n_dense * mlp + n_moe * moe_p)
    if cfg.encdec:
        total += cfg.enc_layers * (n_attn_per_layer + mlp + 2 * d)
        total += cfg.n_layers * n_attn_per_layer  # cross attention
    total += v * d * (1 if cfg.tie_embeddings else 2) + d
    return total


def count_active_params(cfg: ArchConfig) -> int:
    """Active params per token (MoE: top_k + shared experts only)."""
    if not cfg.moe:
        return count_params(cfg)
    full = count_params(cfg)
    moe_all = cfg.moe.n_experts * 3 * cfg.d_model * cfg.moe.d_ff_expert
    moe_act = cfg.moe.top_k * 3 * cfg.d_model * cfg.moe.d_ff_expert
    if cfg.mixer == "hybrid":
        n_moe = cfg.n_layers // cfg.moe.every
    else:
        n_moe = (cfg.n_layers - cfg.moe.first_dense) // cfg.moe.every
    return full - n_moe * (moe_all - moe_act)
