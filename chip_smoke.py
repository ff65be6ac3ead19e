#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; nothing of
JAX or of the JAX package ``repro``).  Phases, each fatal on failure:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build — every CUDA source of the main path, with ``nvcc``'s register,
   shared-memory and spill report;
3. kernel vs plain — the radix-2 FFT kernel against its plain PyTorch
   version on the same CUDA tensors, f64 and f32, forward and inverse, at
   the main path's shapes (N=512 with 512·512 and 257·512 rows) and the
   edges N=2 and N=8192.  Tolerance: max|Δ| ≤ 1e-12·max|y| in f64 and
   ≤ 1e-5·max|y| in f32 — same twiddles, same operation order, only the
   compiler's FMA contraction differs;
4. timing — kernel, plain version and ``torch.fft.fft`` (a yardstick the
   port never calls) at the main path's N=512 f64 shapes, CUDA events, and
   the bound (bytes moved over 3.35 TB/s, flops over the FP64 peak);
5. main path — ``heat`` (fused roundtrip off and on), ``poisson`` and
   ``nls`` at N=512 f64 and ``navier_stokes`` at N=256 f64 through
   ``make_solver(..., device="cuda", plan_cfg={"backend": "pallas"})`` on
   a 1×1 grid: each must pass ``validate()``, end with finite fields of the
   expected shapes, launch the kernel and never call the plain version;
   then the same runs with ``backend="ref"`` (the plain version), which
   must agree per step to ≤1e-10 relative (``observables_rel_err``);
6. breakdown — ``torch.profiler`` over one heat step at N=512: device time
   by kernel and the device's idle share (informational).

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Full results go to
``build/chip_smoke.json``.  Exits non-zero, with no result line, when
CUDA is unavailable or the port's sources are not beside this script.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")
OUT = os.path.join(HERE, "build", "chip_smoke.json")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP64_FLOPS = 34e12            # H100 SXM data sheet, FP64 without tensor cores
TOL = {"float64": 1e-12, "float32": 1e-5}

# (case, N, steps, extra plan knobs): the main path at the paper's
# fft512_p1 size; Navier–Stokes at N=256 for memory and time
MAIN_PATH = (
    ("heat", 512, 3, {}),
    ("heat", 512, 3, {"fused_roundtrip": True}),
    ("poisson", 512, 2, {}),
    ("nls", 512, 3, {}),
    ("navier_stokes", 256, 2, {}),
)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no GPU to run on")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no port package at {SRC}/repro_torch: run from a checkout")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    say(smi[0])  # name, power limit: as nvidia-smi prints them
    name = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device: {name} "
        f"(count {torch.cuda.device_count()})")
    return name, smi[0]


def build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all(["fft_radix2"])
    say(f"build: fft_radix2 in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log("fft_radix2").splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            say(f"  ptxas: {line.strip()}")


def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, dtype=dtype, device="cuda", generator=gen)


def kernel_vs_plain(gen):
    """Phase 3: returns the max abs error at the main path's f64 shapes."""
    import torch

    from repro_torch.kernels import fft_radix2, ref

    shapes = ((512 * 512, 512), (257 * 512, 512), (4096, 2), (1024, 8192))
    main_abs = 0.0
    for dtype in (torch.float64, torch.float32):
        for rows, n in shapes:
            xr, xi = _rand((rows, n), dtype, gen), _rand((rows, n), dtype, gen)
            for inverse in (False, True):
                kr, ki = fft_radix2.fft1d_radix2(xr, xi, inverse=inverse)
                plain = ref.ifft_dif_planar if inverse else ref.fft_dif_planar
                pr, pi = plain(xr, xi)
                torch.cuda.synchronize()
                scale = max(pr.abs().max().item(), pi.abs().max().item())
                err = max((kr - pr).abs().max().item(),
                          (ki - pi).abs().max().item())
                tol = TOL[str(dtype).removeprefix("torch.")]
                ok = err <= tol * scale
                say(f"kernel vs plain: {str(dtype)[6:]} rows={rows} N={n} "
                    f"{'inverse' if inverse else 'forward'}: max|d| {err:.3e} "
                    f"= {err / scale:.3e} max|y| (tol {tol:g}) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"fft_radix2 disagrees with its plain version at "
                         f"rows={rows} N={n} {dtype} inverse={inverse}")
                if dtype == torch.float64 and n == 512:
                    main_abs = max(main_abs, err)
                del kr, ki, pr, pi
            del xr, xi
            torch.cuda.empty_cache()
    return main_abs


def _time_ms(fn, iters: int, warmup: int) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timing(gen):
    """Phase 4: the kernel at the main path's N=512 f64 shapes — 512·512
    rows (the kernels line), 256·512 rows (one X-phase slab of the heat
    and poisson steps) and 257·512 rows (the Y and Z phases)."""
    import math

    import torch

    from repro_torch.kernels import fft_radix2, ref

    n, item, out = 512, 8, []
    for rows in (512 * 512, 256 * 512, 257 * 512):
        xr = _rand((rows, n), torch.float64, gen)
        xi = _rand((rows, n), torch.float64, gen)
        z = torch.complex(xr, xi)
        ms = _time_ms(lambda: fft_radix2.fft1d_radix2(xr, xi), iters=20,
                      warmup=3)
        plain_ms = _time_ms(lambda: ref.fft_dif_planar(xr, xi), iters=3,
                            warmup=1)
        library_ms = _time_ms(lambda: torch.fft.fft(z), iters=20, warmup=3)
        stages = int(math.log2(n))
        moved = 4 * rows * n * item + 2 * stages * (n // 2) * item
        flops = 5 * n * stages * rows
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP64_FLOPS * 1e3
        t = {"rows": rows, "n": n, "dtype": "float64", "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms,
             "bytes": moved, "flops": flops,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        say(f"timing fft_radix2 rows={rows} N={n} f64: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, torch.fft {library_ms:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {moved} B, {flops} "
            f"flop), {t['bound_ms'] / ms:.1%} of the bound")
        out.append(t)
        del xr, xi, z
        torch.cuda.empty_cache()
    return out


def _run_case(case, n, steps, knobs, backend):
    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver

    solver = make_solver(case, PencilGrid.from_mesh(1, 1), n, device="cuda",
                         plan_cfg={"backend": backend, **knobs})
    torch.cuda.reset_peak_memory_stats()
    state = solver.init_state()
    history = [solver.observables(state)]
    step_ms = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = solver.step(state)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(solver.observables(state))
    ok, lines = solver.validate(history)
    fields_ok = all(bool(torch.isfinite(f).all()) for f in state.fields)
    shapes = [tuple(f.shape) for f in state.fields]
    peak = torch.cuda.max_memory_allocated()
    del solver, state
    torch.cuda.empty_cache()
    return {"case": case, "n": n, "backend": backend, **knobs,
            "steps": steps, "step_ms": step_ms, "validate": bool(ok),
            "validate_lines": lines, "finite": fields_ok, "shapes": shapes,
            "history": history, "peak_bytes": peak}


def _expected_shapes(case, n):
    kx = n // 2 + 1
    return {"heat": [(n, n, n)], "poisson": [(n, n, n)] * 3,
            "nls": [(n, n, n)] * 2,
            "navier_stokes": [(3, kx, n, n)] * 2}[case]


def main_path():
    """Phase 5: the pallas runs are the main path (counts zeroed just
    before, read just after); the ref runs follow for the comparison."""
    from repro_torch.kernels import fft_radix2, ref
    from repro_torch.solvers.base import observables_rel_err

    runs = []
    fft_radix2.launches = 0
    ref.calls = 0
    for case, n, steps, knobs in MAIN_PATH:
        before = fft_radix2.launches
        r = _run_case(case, n, steps, knobs, "pallas")
        r["launches"] = fft_radix2.launches - before
        runs.append(r)
    launches, plain_calls = fft_radix2.launches, ref.calls
    say(f"main path: fft_radix2.launches={launches}, plain-version calls="
        f"{plain_calls}")
    if launches == 0:
        fail("the main path never launched the fft_radix2 kernel")
    if plain_calls:
        fail(f"the main path called the plain version {plain_calls} times")

    for r, (case, n, steps, knobs) in zip(runs, MAIN_PATH):
        plain = _run_case(case, n, steps, knobs, "ref")
        r["ref_step_ms"] = plain["step_ms"]
        r["obs_rel_err"] = max(observables_rel_err(a, b) for a, b in
                               zip(r["history"], plain["history"]))
        tag = f"{case} N={n}" + (" fused" if knobs else "")
        say(f"{tag}: {r['launches']} launches ({r['launches'] // steps}/step), "
            f"ms/step {[round(t, 3) for t in r['step_ms']]} "
            f"(ref {[round(t, 3) for t in plain['step_ms']]}), peak "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, obs vs ref "
            f"{r['obs_rel_err']:.2e}, validate {r['validate']}: "
            f"{'; '.join(r['validate_lines'])}")
        if not (r["validate"] and plain["validate"]):
            fail(f"{tag}: validate() failed: {r['validate_lines']} / "
                 f"ref {plain['validate_lines']}")
        if not r["finite"] or r["shapes"] != _expected_shapes(case, n):
            fail(f"{tag}: fields finite={r['finite']} shapes={r['shapes']}")
        if r["obs_rel_err"] > 1e-10:
            fail(f"{tag}: observables differ from the ref run by "
                 f"{r['obs_rel_err']:.3e} > 1e-10")
    return runs, launches


def breakdown():
    """Phase 6: where one heat step at N=512 (backend pallas) spends the
    card's time, by kernel name, from ``torch.profiler``; device busy time
    over the step's host-clock time gives the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver

    solver = make_solver("heat", PencilGrid.from_mesh(1, 1), 512,
                         device="cuda", plan_cfg={"backend": "pallas"})
    state = solver.step(solver.init_state())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = solver.step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    out = {"case": "heat", "n": 512, "wall_ms": wall_ms, "busy_ms": busy_ms,
           "kernels": [{"ms": ms, "count": c, "name": k[:120]}
                       for ms, c, k in rows]}
    if not rows:
        say("breakdown: the profiler saw no device time (not measured)")
        return out
    say(f"breakdown heat N=512 step: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.1%}")
    for ms, c, k in rows[:8]:
        say(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{c:<4d} {k[:90]}")
    del solver, state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    name, smi = card()
    sys.path.insert(0, SRC)
    import torch

    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs = kernel_vs_plain(gen)
    times = timing(gen)
    runs, launches = main_path()
    prof = breakdown()

    t = times[0]
    kernels = [{
        "name": "fft_radix2", "route": "cuda",
        "source": "src/repro_torch/csrc/fft_radix2.cu",
        "replaces": "src/repro/kernels/fft_radix2.py:90",
        "launches": launches, "max_abs_err": max_abs, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]}]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": smi, "device": name, "timing": times,
                   "kernels": kernels, "runs": runs, "breakdown": prof},
                  f, indent=1)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
