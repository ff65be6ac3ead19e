"""deepseek-7b — llama-arch [arXiv:2401.02954; hf].
30L d_model=4096 32H (GQA kv=32) d_ff=11008 vocab=102400."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab=102400,
    train_microbatches=2)

SMOKE = ArchConfig(
    arch_id="deepseek-7b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
    compute_dtype="float32", remat=False)
