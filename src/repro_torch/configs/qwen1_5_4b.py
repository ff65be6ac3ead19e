"""qwen1.5-4b — QKV bias [hf:Qwen/Qwen1.5; hf].
40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab=151936, qkv_bias=True,
    train_microbatches=2)

SMOKE = ArchConfig(
    arch_id="qwen1.5-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
    qkv_bias=True, compute_dtype="float32", remat=False)
