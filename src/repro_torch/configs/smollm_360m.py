"""smollm-360m — llama-arch small [hf:HuggingFaceTB/SmolLM; hf].
32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152; tied embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, d_ff=2560,
    vocab=49152, tie_embeddings=True)

SMOKE = ArchConfig(
    arch_id="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, d_ff=128, vocab=512,
    tie_embeddings=True, compute_dtype="float32", remat=False)
