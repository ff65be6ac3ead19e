#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; nothing of
JAX or of the JAX package ``repro``).  It covers the two FFT kernels of the
main path: ``fft_radix2`` (backend ``"pallas"``) and ``fft_mxu`` (backend
``"mxu"``, the four-step FFT on the FP64 tensor cores).  Phases, each fatal
on failure:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build — both CUDA sources, ``nvcc`` processes started together, with
   each one's register, shared-memory and spill report;
3. kernel vs plain — each kernel against its plain PyTorch version on the
   same CUDA tensors, f64 and f32, forward and inverse, at the main path's
   shapes (N=512 with 512·512 and 257·512 rows; for ``fft_mxu`` also N=256
   with 512·256 rows) and the edges (N=2 and 8192 for ``fft_radix2``, N=4,
   16 and 8192 for ``fft_mxu``).  Tolerance: max|Δ| ≤ 1e-12·max|y| in f64
   and ≤ 1e-5·max|y| in f32.  ``fft_radix2`` has the same twiddles and
   operation order as its plain version, only the compiler's FMA
   contraction differs; ``fft_mxu`` sums in another order inside its
   tensor-core tiles than cuBLAS does in the plain version's products
   (which run with TF32 off);
4. timing — each kernel, its plain version and ``torch.fft.fft`` (a
   yardstick the port never calls) at the main path's N=512 f64 shapes,
   CUDA events, and the bound: the larger of the bytes moved over
   3.35 TB/s and the flops over the peak of the units the kernel runs on
   (FP64 CUDA cores, 34 TFLOP/s, for ``fft_radix2``; FP64 tensor cores,
   67 TFLOP/s, for ``fft_mxu``);
5. main path — ``heat`` (fused roundtrip off and on), ``poisson`` and
   ``nls`` at N=512 f64 and ``navier_stokes`` at N=256 f64 through
   ``make_solver(..., device="cuda", plan_cfg={"backend": ...})`` on a 1×1
   grid, once on ``"pallas"`` and once on ``"mxu"``, every launch and call
   count set to 0 just before each backend's runs and read just after:
   each run must pass ``validate()`` and end with finite fields of the
   expected shapes, its own kernel must have launched, and neither the
   other kernel nor any plain version may have run; then the same runs
   with ``backend="ref"`` (the plain version), which both must agree with
   per step to ≤1e-10 relative (``observables_rel_err``);
6. breakdown — ``torch.profiler`` over one heat step at N=512 on each
   kernel backend: device time by kernel and the device's idle share
   (informational).

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
FP64_TC_FLOPS = 67e12         # H100 SXM data sheet, FP64 tensor cores
FP32_FLOPS = 67e12            # H100 SXM data sheet, FP32 without tensor cores
TOL = {"float64": 1e-12, "float32": 1e-5}
KERNELS = ("fft_radix2", "fft_mxu")
BACKEND = {"fft_radix2": "pallas", "fft_mxu": "mxu"}

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
    _build.build_all(KERNELS)
    say(f"build: {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                say(f"  ptxas {name}: {line.strip()[:150]}")


def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, dtype=dtype, device="cuda", generator=gen)


def _pair(name):
    """(kernel wrapper, plain version), both taking ``inverse=``."""
    from repro_torch.kernels import fft_mxu, fft_radix2, ref

    if name == "fft_mxu":
        return fft_mxu.fft1d_mxu, fft_mxu.four_step_planar

    def plain(xr, xi, inverse=False):
        return (ref.ifft_dif_planar if inverse else ref.fft_dif_planar)(xr, xi)
    return fft_radix2.fft1d_radix2, plain


# (rows, N) held against the plain version: the main path's shapes first
CHECK_SHAPES = {
    "fft_radix2": ((512 * 512, 512), (257 * 512, 512), (4096, 2), (1024, 8192)),
    "fft_mxu": ((512 * 512, 512), (257 * 512, 512), (512 * 256, 256),
                (4096, 4), (4096, 16), (1024, 8192)),
}
MAIN_N = (512, 256)


def kernel_vs_plain(gen):
    """Phase 3: returns, per kernel, the max abs error at the main path's
    f64 shapes."""
    import torch

    main_abs = {}
    for name in KERNELS:
        kernel, plain = _pair(name)
        main_abs[name] = 0.0
        for dtype in (torch.float64, torch.float32):
            for rows, n in CHECK_SHAPES[name]:
                xr, xi = _rand((rows, n), dtype, gen), _rand((rows, n), dtype, gen)
                for inverse in (False, True):
                    kr, ki = kernel(xr, xi, inverse=inverse)
                    pr, pi = plain(xr, xi, inverse=inverse)
                    torch.cuda.synchronize()
                    scale = max(pr.abs().max().item(), pi.abs().max().item())
                    err = max((kr - pr).abs().max().item(),
                              (ki - pi).abs().max().item())
                    tol = TOL[str(dtype).removeprefix("torch.")]
                    ok = err <= tol * scale
                    say(f"kernel vs plain: {name} {str(dtype)[6:]} rows={rows} "
                        f"N={n} {'inverse' if inverse else 'forward'}: max|d| "
                        f"{err:.3e} = {err / scale:.3e} max|y| (tol {tol:g}) "
                        f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        fail(f"{name} disagrees with its plain version at "
                             f"rows={rows} N={n} {dtype} inverse={inverse}")
                    if dtype == torch.float64 and n in MAIN_N:
                        main_abs[name] = max(main_abs[name], err)
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


def _work(name, rows, n, item):
    """(bytes, flops, peak flop/s) of one call: input and output read or
    written once, plus the tables; the flops the algorithm needs."""
    import math

    from repro_torch.kernels import fft_mxu

    if name == "fft_mxu":
        p = fft_mxu.plan_np(n, "float64")
        tables = 2 * (p.n1 * p.n1 + p.n1 * p.n2 + p.n2 * p.n2) * item
        return (4 * rows * n * item + tables, fft_mxu.fft_mxu_flops(n) * rows,
                FP64_TC_FLOPS if item == 8 else FP32_FLOPS)
    stages = int(math.log2(n))
    return (4 * rows * n * item + 2 * stages * (n // 2) * item,
            5 * n * stages * rows, FP64_FLOPS if item == 8 else FP32_FLOPS)


def timing(gen):
    """Phase 4: each kernel at the main path's N=512 f64 shapes — 512·512
    rows (the kernels line), 256·512 rows (one X-phase slab of the heat
    and poisson steps) and 257·512 rows (the Y and Z phases)."""
    import torch

    n, item, out = 512, 8, []
    for rows in (512 * 512, 256 * 512, 257 * 512):
        xr = _rand((rows, n), torch.float64, gen)
        xi = _rand((rows, n), torch.float64, gen)
        z = torch.complex(xr, xi)
        library_ms = _time_ms(lambda: torch.fft.fft(z), iters=20, warmup=3)
        for name in KERNELS:
            kernel, plain = _pair(name)
            ms = _time_ms(lambda: kernel(xr, xi), iters=20, warmup=3)
            plain_ms = _time_ms(lambda: plain(xr, xi), iters=3, warmup=1)
            moved, flops, peak = _work(name, rows, n, item)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / peak * 1e3
            t = {"kernel": name, "rows": rows, "n": n, "dtype": "float64",
                 "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                 "bytes": moved, "flops": flops,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            say(f"timing {name} rows={rows} N={n} f64: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.3f} ms, torch.fft {library_ms:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {moved} B "
                f"{bytes_ms:.4f} ms, {flops:.0f} flop {ops_ms:.4f} ms), "
                f"{t['bound_ms'] / ms:.1%} of the bound")
            out.append(t)
            torch.cuda.empty_cache()
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


def _counts():
    from repro_torch.kernels import fft_mxu, fft_radix2, ref
    return {"fft_radix2": fft_radix2.launches, "fft_mxu": fft_mxu.launches,
            "ref.calls": ref.calls, "fft_mxu.plain_calls": fft_mxu.plain_calls}


def _drive(name):
    """One kernel's main path: every count set to 0 just before its runs
    and read just after; its kernel must have launched, and neither the
    other kernel nor a plain version may have run."""
    from repro_torch.kernels import fft_mxu, fft_radix2, ref

    fft_radix2.launches = fft_mxu.launches = 0
    ref.calls = fft_mxu.plain_calls = 0
    runs = []
    for case, n, steps, knobs in MAIN_PATH:
        before = _counts()[name]
        r = _run_case(case, n, steps, knobs, BACKEND[name])
        r["launches"] = _counts()[name] - before
        runs.append(r)
    counts = _counts()
    say(f"main path {BACKEND[name]!r}: counts {counts}")
    if counts[name] == 0:
        fail(f"the {BACKEND[name]!r} main path never launched {name}")
    others = {k: v for k, v in counts.items() if k != name and v}
    if others:
        fail(f"the {BACKEND[name]!r} main path ran {others}")
    return runs, counts[name]


def main_path():
    """Phase 5: each kernel backend's runs are its main path; the ref
    runs follow once, for the comparison of both."""
    from repro_torch.solvers.base import observables_rel_err

    driven = {name: _drive(name) for name in KERNELS}
    for i, (case, n, steps, knobs) in enumerate(MAIN_PATH):
        plain = _run_case(case, n, steps, knobs, "ref")
        tag = f"{case} N={n}" + (" fused" if knobs else "")
        if not plain["validate"]:
            fail(f"{tag}: validate() failed on ref: {plain['validate_lines']}")
        for name in KERNELS:
            r = driven[name][0][i]
            r["ref_step_ms"] = plain["step_ms"]
            r["obs_rel_err"] = max(observables_rel_err(a, b) for a, b in
                                   zip(r["history"], plain["history"]))
            say(f"{tag} {r['backend']}: {r['launches']} launches "
                f"({r['launches'] // steps}/step), ms/step "
                f"{[round(t, 3) for t in r['step_ms']]} (ref "
                f"{[round(t, 3) for t in plain['step_ms']]}), peak "
                f"{r['peak_bytes'] / 2**30:.2f} GiB, obs vs ref "
                f"{r['obs_rel_err']:.2e}, validate {r['validate']}: "
                f"{'; '.join(r['validate_lines'])}")
            if not r["validate"]:
                fail(f"{tag} {r['backend']}: validate() failed: "
                     f"{r['validate_lines']}")
            if not r["finite"] or r["shapes"] != _expected_shapes(case, n):
                fail(f"{tag} {r['backend']}: fields finite={r['finite']} "
                     f"shapes={r['shapes']}")
            if r["obs_rel_err"] > 1e-10:
                fail(f"{tag} {r['backend']}: observables differ from the ref "
                     f"run by {r['obs_rel_err']:.3e} > 1e-10")
    return ({name: runs for name, (runs, _) in driven.items()},
            {name: launches for name, (_, launches) in driven.items()})


def breakdown(backend):
    """Phase 6: where one heat step at N=512 spends the card's time, by
    kernel name, from ``torch.profiler``; device busy time over the step's
    host-clock time gives the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver

    solver = make_solver("heat", PencilGrid.from_mesh(1, 1), 512,
                         device="cuda", plan_cfg={"backend": backend})
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
    out = {"case": "heat", "n": 512, "backend": backend, "wall_ms": wall_ms,
           "busy_ms": busy_ms,
           "kernels": [{"ms": ms, "count": c, "name": k[:120]}
                       for ms, c, k in rows]}
    if not rows:
        say(f"breakdown {backend}: the profiler saw no device time "
            "(not measured)")
        return out
    say(f"breakdown heat N=512 step, backend {backend!r}: wall {wall_ms:.3f} "
        f"ms, device busy {busy_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.1%}")
    for ms, c, k in rows[:8]:
        say(f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{c:<4d} {k[:90]}")
    del solver, state
    torch.cuda.empty_cache()
    return out


REPLACES = {"fft_radix2": "src/repro/kernels/fft_radix2.py:90",
            "fft_mxu": "src/repro/kernels/fft_mxu.py:80"}


def main() -> int:
    name, smi = card()
    sys.path.insert(0, SRC)
    import torch

    # the plain versions' products go through cuBLAS: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs = kernel_vs_plain(gen)
    times = timing(gen)
    runs, launches = main_path()
    prof = [breakdown(BACKEND[k]) for k in KERNELS]

    kernels = []
    for k in KERNELS:
        t = next(t for t in times if t["kernel"] == k)  # 512·512 rows
        kernels.append({
            "name": k, "route": "cuda", "source": f"src/repro_torch/csrc/{k}.cu",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": max_abs[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
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
