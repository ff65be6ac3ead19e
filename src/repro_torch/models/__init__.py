"""The port's language models: the dense uniform decoder (prefill, greedy
decode and the training loss), its layers, and the carrier of JAX
parameters."""

from repro_torch.models.transformer import (RunCfg, decode_step, forward,
                                            init_cache, init_model, lm_loss,
                                            pad_cache, prefill)

__all__ = ["RunCfg", "init_model", "forward", "lm_loss", "decode_step",
           "init_cache", "pad_cache", "prefill"]
