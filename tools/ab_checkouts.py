#!/usr/bin/env python3
"""One side of a comparison of two checkouts of the port on one card.

    python3 tools/ab_checkouts.py ROOT TAG [--solver | --multi | --adamw]

Imports ``repro_torch`` from ``ROOT/src`` (its kernels build into
``ROOT/build/kernels``) and prints one JSON line tagged ``TAG``.

Default (serving): smollm-360m at full width and depth (random weights
from seed 0, bf16, batch 8, prompt 2048, 32 greedy tokens; a short warm-up
first, then two timed calls: prefill ms and decode ms a step), and
``flash_attention`` at the prefill shape (8, 2048, 2048, 15, 5, 64, causal,
bf16; CUDA events over 30 calls).

``--solver``: the FFT kernels, the wire and the step they carry, each value
the median of ``REPS`` CUDA-event timings (kernels timed with the card's
queue filled first, steps as the host drives them): ``fft_radix2`` and ``fft_mxu``
at N=512 f64 over 512·512 rows (each timing the mean of 20 calls);
``ring_payload`` forward, inverse and roundtrip at 5462×512 f64 (run (a)'s
chunk; 20 calls a timing); ``ring_send`` and ``ring_land`` of two arrays'
block 1 of a (128, 128, 512) f64 slab cut in 4 along its last axis (run
(a)'s wire copy; 50 calls a timing); ``heat`` at N=512 f64 on a 1×1 grid,
backends ``"pallas"`` and ``"mxu"``, ms a step (one warm-up step, then one
step a timing).

``--multi``: the multi-rank runs (a)–(c) of ``chip_smoke.py``'s phase 7
(``MULTI_RANK``: nls 1×4 ``pallas_ring`` fused, nls 4×1 ``bidi_ring``,
heat 2×2 ``pallas_ring`` fused; N=512 f64, 4 rank processes on the one
card, one spawn), rank 0's ms a step on the host clock (one warm-up step,
then ``MULTI_STEPS`` steps, each ended by a synchronize).

``--adamw``: one AdamW step (``optim/adamw.py::update``: the global norm
and the update, in place) over the leaves of each training cell of
``chip_smoke.py`` that trains on one card through the launcher or its
step (``ADAMW_CELLS``: smollm-360m at 12 layers, qwen3-moe-30b-a3b and
deepseek-v2-lite-16b at 4, rwkv6-3b whole; the config's dtypes, seed 0,
random gradients), ms a step as the host drives it: the median of
``REPS`` steps after one.

Run the two checkouts alternately in one call, e.g. parent, change,
change, parent, to compare them on the same card.
"""

import json
import os
import statistics
import sys
import time

REPS = 7
MULTI_STEPS = 5


def _events_ms(torch, fn, iters: int, fill: bool = True) -> float:
    """CUDA-event ms a call of ``fn`` over ``iters`` calls; with ``fill``
    the card first sleeps ~10 ms while the host enqueues them, so that a
    launch path slower than a short kernel is not what is timed."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if fill:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _median_ms(torch, fn, iters: int, warmup: int = 3, fill: bool = True) -> dict:
    for _ in range(warmup):
        fn()
    times = [_events_ms(torch, fn, iters, fill) for _ in range(REPS)]
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


def _heat_ms(torch, backend: str) -> dict:
    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver

    s = make_solver("heat", PencilGrid.from_mesh(1, 1), 512, device="cuda",
                    plan_cfg={"backend": backend})
    state = s.init_state()
    box = [s.step(state)]

    def step():
        box[0] = s.step(box[0])
    ms = _median_ms(torch, step, 1, warmup=1, fill=False)  # host time counts
    del s, state, box
    torch.cuda.empty_cache()
    return ms


def solver(torch, tag: str) -> dict:
    from repro_torch.core import transpose as tr
    from repro_torch.kernels import fft_mxu, fft_radix2, ring_rdma

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"tag": tag, "device": torch.cuda.get_device_name(0), "reps": REPS}
    xr, xi = (torch.randn(512 * 512, 512, dtype=torch.float64, device="cuda",
                          generator=g) for _ in range(2))
    out["fft_radix2_ms"] = _median_ms(torch, lambda: fft_radix2.fft1d_radix2(xr, xi), 20)
    out["fft_mxu_ms"] = _median_ms(torch, lambda: fft_mxu.fft1d_mxu(xr, xi), 20)
    del xr, xi
    pr, pi, dr, di = (torch.randn(5462, 512, dtype=torch.float64, device="cuda",
                                  generator=g) for _ in range(4))
    for mode, kw in (("forward", {}), ("inverse", {"inverse": True}),
                     ("roundtrip", {"diag": (dr, di)})):
        out[f"ring_payload_{mode}_ms"] = _median_ms(
            torch, lambda: ring_rdma.ring_payload(pr, pi, **kw), 20)
    del pr, pi, dr, di
    xs = [torch.randn(128, 128, 512, dtype=torch.float64, device="cuda", generator=g)
          for _ in range(2)]
    slots = [torch.empty(128, 128, 128, dtype=torch.float64, device="cuda")
             for _ in range(2)]
    outs = [torch.empty(128, 512, 128, dtype=torch.float64, device="cuda")
            for _ in range(2)]
    out["ring_send_ms"] = _median_ms(
        torch, lambda: ring_rdma.ring_send(xs, 1, 4, 2, slots), 50)
    out["ring_land_ms"] = _median_ms(
        torch, lambda: ring_rdma.ring_land(slots, outs, 1, 4, 1), 50)
    assert all(torch.equal(tr.block(o, 1, 4, 1), s_) for o, s_ in zip(outs, slots))
    del xs, slots, outs
    torch.cuda.empty_cache()
    out["heat_ms_per_step"] = _heat_ms(torch, "pallas")
    out["heat_mxu_ms_per_step"] = _heat_ms(torch, "mxu")
    return out


def _multi_rank(ctx, runs):
    """In each of the 4 rank processes: every run's steps, timed."""
    import torch

    from repro_torch import dist
    from repro_torch.solvers import make_solver

    out = {}
    for tag, case, mesh, cfg in runs:
        c = dist.regrid(*mesh)
        s = make_solver(case, c.grid(), 512, device=c.device, plan_cfg=cfg)
        state = s.step(s.init_state())
        ms = []
        for _ in range(MULTI_STEPS):
            torch.cuda.synchronize(c.device)
            t0 = time.perf_counter()
            state = s.step(state)
            torch.cuda.synchronize(c.device)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[tag] = ms
        del s, state
        torch.cuda.empty_cache()
    return out


def multi(torch, tag: str) -> dict:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import MULTI_RANK
    from repro_torch import dist

    ranks = dist.run_ranks(_multi_rank, 4, 1, device="cuda", args=(MULTI_RANK,),
                           timeout=900)
    out = {"tag": tag, "device": torch.cuda.get_device_name(0), "steps": MULTI_STEPS}
    for run, ms in ranks[0].items():
        out[f"{run}_ms_per_step"] = {"median": statistics.median(ms), "min": min(ms),
                                     "max": max(ms)}
    return out


#: (arch, layers; 0: the config's) of the cells ``--adamw`` steps
ADAMW_CELLS = (("smollm-360m", 12), ("qwen3-moe-30b-a3b", 4),
               ("deepseek-v2-lite-16b", 4), ("rwkv6-3b", 0))


def adamw_steps(torch, tag: str) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    out = {"tag": tag, "device": torch.cuda.get_device_name(0), "reps": REPS}
    for arch, layers in ADAMW_CELLS:
        cfg = get_config(arch)
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        params = dict(T.init_model(cfg, seed=0, device="cuda").named_parameters())
        g = torch.Generator(device="cuda").manual_seed(0)
        grads = {n: torch.randn(p.shape, device="cuda", generator=g).to(p.dtype)
                 for n, p in params.items()}
        c = adamw.AdamWConfig(lr=1e-4, total_steps=100, warmup_steps=5,
                              moment_dtype=cfg.opt_state_dtype)
        state = adamw.init(c, params)
        ms = _median_ms(torch, lambda: adamw.update(c, grads, state, params), 1,
                        warmup=1, fill=False)  # host time counts
        out[arch] = dict(ms, params=sum(p.numel() for p in params.values()))
        del params, grads, state
        torch.cuda.empty_cache()
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root, tag = args[0], args[1]
    sys.path.insert(0, f"{root}/src")
    import torch

    if not torch.cuda.is_available():
        print("ab_checkouts: no CUDA card", file=sys.stderr)
        return 1
    run = (solver if "--solver" in sys.argv[1:]
           else multi if "--multi" in sys.argv[1:]
           else adamw_steps if "--adamw" in sys.argv[1:] else serving)
    print(json.dumps(run(torch, tag)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
