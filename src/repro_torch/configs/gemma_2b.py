"""gemma-2b — GeGLU, head_dim=256, MQA [arXiv:2403.08295; hf].
18L d_model=2048 8H (kv=1) d_ff=16384 vocab=256000; RMSNorm(1+w), embeds
scaled by sqrt(d); tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, mlp_type="geglu", norm_plus_one=True,
    embed_scale=True, tie_embeddings=True)

SMOKE = ArchConfig(
    arch_id="gemma-2b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=160,
    vocab=512, mlp_type="geglu", norm_plus_one=True, embed_scale=True,
    tie_embeddings=True, compute_dtype="float32", remat=False)
