"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].
48L d_model=2048 32H (GQA kv=4) expert d_ff=768 vocab=151936; head_dim 128."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    arch_id="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=768, router_norm_topk=True,
               impl="ep", chunks=4),
    train_microbatches=4)

SMOKE = ArchConfig(
    arch_id="qwen3-moe-30b-a3b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
    vocab=512,
    moe=MoECfg(capacity_factor=8.0, n_experts=4, top_k=2, d_ff_expert=64, router_norm_topk=True),
    compute_dtype="float32", remat=False)
