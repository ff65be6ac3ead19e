"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356].
12+12L d_model=768 12H d_ff=3072 vocab=51865; LayerNorm + GELU; the audio
frontend is a STUB: input_specs() provides precomputed frame embeddings."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-small", family="audio",
    n_layers=12, enc_layers=12, encdec=True, d_model=768, n_heads=12,
    n_kv_heads=12, d_ff=3072, vocab=51865, norm="ln", mlp_type="gelu",
    embed_mode="frames",
    train_microbatches=4)

SMOKE = ArchConfig(
    arch_id="whisper-small-smoke", family="audio",
    n_layers=2, enc_layers=2, encdec=True, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, norm="ln", mlp_type="gelu",
    embed_mode="frames", compute_dtype="float32", remat=False)
