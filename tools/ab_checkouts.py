#!/usr/bin/env python3
"""One side of a comparison of two checkouts of the port on one card.

    python3 tools/ab_checkouts.py ROOT TAG

Imports ``repro_torch`` from ``ROOT/src`` (its kernels build into
``ROOT/build/kernels``) and prints one JSON line tagged ``TAG``:
smollm-360m serving at full width and depth (random weights from seed 0,
bf16, batch 8, prompt 2048, 32 greedy tokens; a short warm-up first, then
two timed calls: prefill ms and decode ms a step), and ``flash_attention``
at the prefill shape (8, 2048, 2048, 15, 5, 64, causal, bf16; CUDA events
over 30 calls).  Run the two checkouts alternately in one call, e.g.
parent, change, change, parent, to compare them on the same card.
"""

import json
import sys


def main() -> int:
    root, tag = sys.argv[1], sys.argv[2]
    sys.path.insert(0, f"{root}/src")
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    if not torch.cuda.is_available():
        print("ab_checkouts: no CUDA card", file=sys.stderr)
        return 1
    cfg = get_config("smollm-360m")
    run = T.RunCfg()
    model = T.init_model(cfg, seed=0, device="cuda")
    tokens = serve.prompt_tokens(cfg, 8, 2048, "cuda")
    serve.generate(cfg, run, model, tokens[:, :64], 2)
    timed = [serve.generate(cfg, run, model, tokens, 32) for _ in range(2)]
    del model
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(8, 2048, 15, 64, device="cuda", generator=g).bfloat16()
    k = torch.randn(8, 2048, 5, 64, device="cuda", generator=g).bfloat16()
    v = torch.randn(8, 2048, 5, 64, device="cuda", generator=g).bfloat16()
    for _ in range(3):
        attention.flash_attention(q, k, v, causal=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(30):
        attention.flash_attention(q, k, v, causal=True)
    end.record()
    torch.cuda.synchronize()
    print(json.dumps({"tag": tag, "device": torch.cuda.get_device_name(0),
                      "prefill_ms": [r["prefill_ms"] for r in timed],
                      "decode_ms_per_step": [r["decode_ms"] / 31 for r in timed],
                      "flash_ms": start.elapsed_time(end) / 30}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
