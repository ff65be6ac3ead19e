"""deepseek-v2-lite-16b — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434; hf]. 27L d_model=2048 16H vocab=102400; expert d_ff=1408;
first layer dense (d_ff=10944)."""
from repro_torch.configs.base import ArchConfig, MLACfg, MoECfg

CONFIG = ArchConfig(
    arch_id="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=10944,
    vocab=102400, attn_kind="mla",
    mla=MLACfg(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoECfg(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
               d_ff_shared=2816, first_dense=1, router_norm_topk=False,
               impl="ep", chunks=4),
    train_microbatches=4)

SMOKE = ArchConfig(
    arch_id="deepseek-v2-lite-16b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
    attn_kind="mla",
    mla=MLACfg(kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
    moe=MoECfg(capacity_factor=8.0, n_experts=4, top_k=2, d_ff_expert=32, n_shared=1,
               d_ff_shared=64, first_dense=1, router_norm_topk=False),
    compute_dtype="float32", remat=False)
