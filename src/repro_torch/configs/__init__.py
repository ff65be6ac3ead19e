"""Assigned-architecture registry (--arch <id>): a copy of the registry of
``repro.configs`` and of its FFT problem table, ``fft_configs``."""

from repro_torch.configs.base import (ArchConfig, MLACfg, MambaCfg, MoECfg,
                                SHAPES, ShapeCfg, shape_applicable,
                                count_params, count_active_params)

__all__ = ["ArchConfig", "MLACfg", "MambaCfg", "MoECfg", "SHAPES",
           "ShapeCfg", "shape_applicable", "count_params",
           "count_active_params", "get_config", "REGISTRY",
           "SMOKE_REGISTRY", "ARCH_IDS"]

from repro_torch.configs import (rwkv6_3b, llava_next_34b, smollm_360m, deepseek_7b,
                           qwen1_5_4b, gemma_2b, deepseek_v2_lite_16b,
                           qwen3_moe_30b_a3b, whisper_small,
                           jamba_1_5_large_398b)

_MODULES = [rwkv6_3b, llava_next_34b, smollm_360m, deepseek_7b, qwen1_5_4b,
            gemma_2b, deepseek_v2_lite_16b, qwen3_moe_30b_a3b, whisper_small,
            jamba_1_5_large_398b]

REGISTRY = {m.CONFIG.arch_id: m.CONFIG for m in _MODULES}
SMOKE_REGISTRY = {m.CONFIG.arch_id: m.SMOKE for m in _MODULES}
ARCH_IDS = list(REGISTRY)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    reg = SMOKE_REGISTRY if smoke else REGISTRY
    if arch_id not in reg:
        raise KeyError(f"unknown arch '{arch_id}'; available: {sorted(reg)}")
    return reg[arch_id]
