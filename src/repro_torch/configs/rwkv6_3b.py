"""rwkv6-3b — Finch, data-dependent decay [arXiv:2404.05892; hf].
32L d_model=2560 (attn-free), d_ff=8960, vocab=65536; head_size 64 -> 40 heads."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="rwkv6-3b", family="ssm", mixer="rwkv",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab=65536, norm="ln",
    train_microbatches=2)

SMOKE = ArchConfig(
    arch_id="rwkv6-3b-smoke", family="ssm", mixer="rwkv",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
    norm="ln", compute_dtype="float32", remat=False)
