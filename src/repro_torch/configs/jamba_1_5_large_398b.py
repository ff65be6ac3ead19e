"""jamba-1.5-large-398b — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf]. 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536; bf16 params + bf16 optimizer moments to fit 16 GB/chip HBM
(fit analysis in EXPERIMENTS.md §Dry-run)."""
from repro_torch.configs.base import ArchConfig, MambaCfg, MoECfg

CONFIG = ArchConfig(
    arch_id="jamba-1.5-large-398b", family="hybrid", mixer="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, hybrid_period=8, hybrid_attn_pos=4,
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24576, every=2,
               impl="ep", chunks=4),
    param_dtype="bfloat16", opt_state_dtype="bfloat16",
    train_microbatches=8)

SMOKE = ArchConfig(
    arch_id="jamba-1.5-large-398b-smoke", family="hybrid", mixer="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, hybrid_period=8, hybrid_attn_pos=4,
    mamba=MambaCfg(d_state=8, d_conv=4, expand=2),
    moe=MoECfg(capacity_factor=8.0, n_experts=4, top_k=2, d_ff_expert=128, every=2),
    compute_dtype="float32", remat=False)
