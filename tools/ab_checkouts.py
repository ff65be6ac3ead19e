#!/usr/bin/env python3
"""One side of a comparison of two checkouts of the port on one card.

    python3 tools/ab_checkouts.py ROOT TAG [--solver]

Imports ``repro_torch`` from ``ROOT/src`` (its kernels build into
``ROOT/build/kernels``) and prints one JSON line tagged ``TAG``.

Default (serving): smollm-360m at full width and depth (random weights
from seed 0, bf16, batch 8, prompt 2048, 32 greedy tokens; a short warm-up
first, then two timed calls: prefill ms and decode ms a step), and
``flash_attention`` at the prefill shape (8, 2048, 2048, 15, 5, 64, causal,
bf16; CUDA events over 30 calls).

``--solver``: the radix-2 engine and the step it carries, each value the
median of ``REPS`` CUDA-event timings: ``fft_radix2`` at N=512 f64 over
512·512 rows (each timing the mean of 20 calls); ``ring_payload`` forward,
inverse and roundtrip at 5462×512 f64 (run (a)'s chunk; 20 calls a
timing); ``heat`` at N=512 f64 on a 1×1 grid, backend ``"pallas"``, ms a
step (one warm-up step, then one step a timing).

Run the two checkouts alternately in one call, e.g. parent, change,
change, parent, to compare them on the same card.
"""

import json
import statistics
import sys

REPS = 7


def _events_ms(torch, fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _median_ms(torch, fn, iters: int, warmup: int = 3) -> dict:
    for _ in range(warmup):
        fn()
    times = [_events_ms(torch, fn, iters) for _ in range(REPS)]
    return {"median": statistics.median(times), "min": min(times), "max": max(times)}


def serving(torch, tag: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

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
    return {"tag": tag, "device": torch.cuda.get_device_name(0),
            "prefill_ms": [r["prefill_ms"] for r in timed],
            "decode_ms_per_step": [r["decode_ms"] / 31 for r in timed],
            "flash_ms": _events_ms(
                torch, lambda: attention.flash_attention(q, k, v, causal=True), 30)}


def solver(torch, tag: str) -> dict:
    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.kernels import fft_radix2, ring_rdma
    from repro_torch.solvers import make_solver

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": tag, "device": torch.cuda.get_device_name(0), "reps": REPS}
    xr, xi = (torch.randn(512 * 512, 512, dtype=torch.float64, device="cuda",
                          generator=g) for _ in range(2))
    out["fft_radix2_ms"] = _median_ms(torch, lambda: fft_radix2.fft1d_radix2(xr, xi), 20)
    del xr, xi
    pr, pi, dr, di = (torch.randn(5462, 512, dtype=torch.float64, device="cuda",
                                  generator=g) for _ in range(4))
    for mode, kw in (("forward", {}), ("inverse", {"inverse": True}),
                     ("roundtrip", {"diag": (dr, di)})):
        out[f"ring_payload_{mode}_ms"] = _median_ms(
            torch, lambda: ring_rdma.ring_payload(pr, pi, **kw), 20)
    del pr, pi, dr, di
    torch.cuda.empty_cache()
    s = make_solver("heat", PencilGrid.from_mesh(1, 1), 512, device="cuda",
                    plan_cfg={"backend": "pallas"})
    state = s.init_state()
    box = [s.step(state)]

    def step():
        box[0] = s.step(box[0])
    out["heat_ms_per_step"] = _median_ms(torch, step, 1, warmup=1)
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root, tag = args[0], args[1]
    sys.path.insert(0, f"{root}/src")
    import torch

    if not torch.cuda.is_available():
        print("ab_checkouts: no CUDA card", file=sys.stderr)
        return 1
    run = solver if "--solver" in sys.argv[1:] else serving
    print(json.dumps(run(torch, tag)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
