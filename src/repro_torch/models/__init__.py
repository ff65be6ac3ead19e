"""The port's language models: the dense uniform decoder (prefill and
greedy decode), its layers, and the carrier of JAX parameters."""

from repro_torch.models.transformer import (RunCfg, decode_step, forward,
                                            init_cache, init_model, pad_cache,
                                            prefill)

__all__ = ["RunCfg", "init_model", "forward", "decode_step", "init_cache",
           "pad_cache", "prefill"]
