"""llava-next-34b — anyres tiling VLM [hf:llava-hf/llava-v1.6; unverified].
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. Backbone only; the
vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (assignment spec)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000, embed_mode="embeds",
    train_microbatches=4)

SMOKE = ArchConfig(
    arch_id="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
    vocab=512, embed_mode="embeds", compute_dtype="float32", remat=False)
