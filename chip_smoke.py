#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; nothing of
JAX or of the JAX package ``repro``).  It covers the six kernels of the
port's two main paths.  The solver step: ``fft_radix2`` (backend
``"pallas"``), ``fft_mxu`` (backend ``"mxu"``, the four-step FFT on the
FP64 tensor cores), and the NIC engine's ``ring_payload``, ``ring_send``
and ``ring_land`` (``csrc/ring_rdma.cu``, engines
``pallas_ring``/``bidi_ring`` on a grid of more than one rank).  LM
serving: ``flash_attention`` (``csrc/flash_attention.cu``), the attention
of every layer of the prefill.  Phases, each fatal on failure:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build — the four CUDA sources, ``nvcc`` processes started together,
   with each one's register, shared-memory and spill report (for the
   radix-2 row engine, one line of registers / spill bytes / static shared
   memory for each instantiation of ``fft_radix2_kernel<T, L>`` and
   ``ring_payload_kernel<T, L, diag>``, fatal on any spill or a missing
   log2 N); then the
   flash-attention library's SASS (``cuobjdump --dump-sass``): each bf16
   instantiation's ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) counts and
   its registers and spill bytes from ptxas — fatal if one has no
   ``HGMMA``, no ``UTMALDG`` or any spill;
3. kernel vs plain — each FFT kernel against its plain PyTorch version on
   the same CUDA tensors, f64 and f32, forward and inverse, at the main
   path's shapes (N=512 with 512·512 and 257·512 rows; for ``fft_mxu``
   also N=256 with 512·256 rows) and the edges (for ``fft_radix2`` every
   N its instantiations cover, 2..8192 in f64 and 2..16384 in f32, each
   with one row and with an odd number of rows, not a multiple of the
   rows a block; N=2, 4, 16 and 8192 for ``fft_mxu``).  Tolerance: max|Δ| ≤
   1e-12·max|y| in f64 and ≤ 1e-5·max|y| in f32.  ``fft_radix2`` has the
   same twiddles and butterflies as its plain version, grouped into
   passes, only the compiler's FMA contraction differs; ``fft_mxu`` sums
   in another order
   inside its tensor-core tiles than cuBLAS does in the plain version's
   products (which run with TF32 off).  Then ``ring_payload`` in its three
   modes (forward, inverse, roundtrip) against ``payload_plain``, f64 and
   f32, N=16, 512 and 8192 and every N of ``fft_radix2``'s edges, the
   same tolerances; ``ring_send`` and
   ``ring_land`` against plain indexing, bit for bit (the "peer" slot a
   second buffer of this process); ``flash_attention`` against
   ``flash_attention_plain`` at the LM prefill's shapes (B=8, S=T=2048,
   15 heads, 5 kv heads, D=64, bf16; S=512 in f32) and at edges (D 20 to
   256, groups 1 to 8, S 1 to 2048, causal and full): in f32 allclose
   with rtol = atol = 2e-5; in bf16 each element within 2 units in the
   last place of the plain value plus 1e-3·rms(plain), and at most 2% of
   the elements (or 8) different (``attention.bf16_gap``), a check that must
   accept an unblocked f32 attention at the prefill shape and refuse it
   with p rounded to bf16 before P·V and with one key tile dropped; the
   bf16 wrapper copies operands into padded buffers (``pad_copies``) only
   where TMA cannot read them (D=20), nowhere else;
4. timing — each kernel, its plain version and PyTorch's own call where
   one computes the same function (``torch.fft.fft``; a yardstick the port
   never calls) at the main path's shapes, CUDA events (the FFT and ring
   kernels' and library calls' times the median of 7 timings, the
   kernels' spread beside them), and the bound:
   the larger of the bytes moved over 3.35 TB/s (for the wire kernels
   2·bytes: on one card a copy reads and writes the same memory) and the
   flops over the peak of the units the kernel runs on (FP64 CUDA cores,
   34 TFLOP/s; FP64 tensor cores, 67 TFLOP/s, for ``fft_mxu``); for
   ``flash_attention`` also the served head dimensions 128 (qwen1.5-4b's
   heads) and 256 (gemma-2b's) at B=8, S=T=2048, bf16, causal, against
   SDPA, and the f32 kernel at the f32 prefill shape against f32 SDPA
   (TF32 off);
5. main path — ``heat`` (fused roundtrip off and on), ``poisson`` and
   ``nls`` at N=512 f64 and ``navier_stokes`` at N=256 f64 through
   ``make_solver(..., device="cuda", plan_cfg={"backend": ...})`` on a 1×1
   grid, once on ``"pallas"`` and once on ``"mxu"``, every launch and call
   count set to 0 just before each backend's runs and read just after:
   each run must pass ``validate()`` and end with finite fields of the
   expected shapes, its own kernel must have launched, and neither the
   other kernel nor any plain version may have run; then the same runs
   with ``backend="ref"`` (the plain version), which both must agree with
   per step to ≤1e-10 relative (``observables_rel_err``).  The ``"pallas"``
   heat (fused) and nls runs keep their fields in ``build/chip_smoke_ref/``;
6. breakdown — ``torch.profiler`` over one heat step at N=512 on each
   FFT kernel backend: device time by kernel and the device's idle share
   (informational);
7. multi-rank — one spawn of 4 rank processes on the one card
   (``repro_torch.dist.run_ranks``): ``pallas_ring`` and ``bidi_ring``
   fold and unfold N=64 blocks on 4×1, 2×2 and 1×4 over the peer-mapped
   wire and over gloo, twice in a row with different data, bit for bit;
   then the multi-rank main path at N=512 f64, 3 steps each — (a) nls 1×4
   ``pallas_ring`` fused, chunks=4; (b) nls 4×1 ``bidi_ring`` composed;
   (c) heat 2×2 ``pallas_ring`` fused, chunks=3 — each held to the 1×1
   ``"pallas"`` run of phase 5: per-step observables and the final fields
   (gathered to rank 0) within 1e-10, heat's initial fields equal to the
   1×1 blocks; per rank, counts set to 0 just before the steps and read
   just after: ``ring_payload``, ``ring_send``, ``ring_land`` and
   ``fft_radix2`` launched, no plain version, and ``exchange_rounds``
   equal to the round model summed over the wires;
8. LM serving — ``smollm-360m`` at full width and depth (random weights
   from seed 0, bf16 as configured) through ``repro_torch.launch.serve``:
   batch 8, prompt 2048, 32 greedy tokens; the ``flash_attention`` counts
   set to 0 just before and read just after (one launch a layer, no
   plain call, no pad copy); prefill ms, decode ms a step, tok/s, peak
   memory.  Then
   the same prompts with the plain attention (``RunCfg(plain_attention=
   True)``), teacher-forced with the kernel run's tokens: every step's
   logits within 3e-2·max|logit| (the drift of 32 bf16 layers, about
   3× the gap measured on the H100); and both
   attentions in f32 at prompt 512, free-running: identical greedy tokens,
   logits within 1e-4·max|logit|.  One ``torch.profiler`` trace of a
   prefill and of a decode step (informational).

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
SOURCES = KERNELS + ("ring_rdma", "flash_attention")
RADIX2_SOURCES = ("fft_radix2", "ring_rdma")  # the radix-2 row engine's users
RING_KERNELS = ("ring_payload", "ring_send", "ring_land")
BF16_TC_FLOPS = 989e12        # H100 SXM data sheet, dense bf16 tensor cores
REF_DIR = os.path.join(HERE, "build", "chip_smoke_ref")

# (case, N, steps, extra plan knobs): the main path at the paper's
# fft512_p1 size; Navier–Stokes at N=256 for memory and time
MAIN_PATH = (
    ("heat", 512, 3, {}),
    ("heat", 512, 3, {"fused_roundtrip": True}),
    ("poisson", 512, 2, {}),
    ("nls", 512, 3, {}),
    ("navier_stokes", 256, 2, {}),
)
#: the 1×1 radix-2 run (index in MAIN_PATH) each multi-rank case holds to
REFERENCE = {"heat": 1, "nls": 3}

# the multi-rank main path, 4 rank processes: (tag, case, mesh, plan)
MULTI_RANK = (
    # forward payloads, 3 roundtrip payloads with diag a step, 3 rounds
    ("a", "nls", (1, 4), {"comm_engine": "pallas_ring", "backend": "pallas",
                          "fused_roundtrip": True, "chunks": 4}),
    # forward and inverse payloads, 2 bidi rounds (the even-P farthest block)
    ("b", "nls", (4, 1), {"comm_engine": "bidi_ring", "backend": "pallas"}),
    # kx padded to 258: 129 = 3·43 rows a slab axis, so chunks=3 fuses the
    # Y<->Z roundtrip; the X<->Y step is not c2c and rides unfused
    ("c", "heat", (2, 2), {"comm_engine": "pallas_ring", "backend": "pallas",
                           "fused_roundtrip": True, "chunks": 3}),
)
MULTI_STEPS = 3
WIRE_MESHES = ((4, 1), (2, 2), (1, 4))
# ring kernels at the shapes of run (a): one round's chunk of a 128-row
# slab (16384 rows of N=512 in 3 chunks) for the payload, one block of a
# (128, 128, 512) Y-pencil slab cut in 4 along its last axis for the wire
PAYLOAD_N = (16, 512, 8192)
PAYLOAD_ROWS = {16: 4096, 512: 5462, 8192: 64}
SLAB = (128, 128, 512)

# flash attention: (B, S, T, H, Hkv, D, causal) held against the plain
# version, the LM prefill's shapes first (smollm-360m: 15 heads, 5 kv
# heads, head_dim 64; bf16 at prompt 2048, f32 at prompt 512), then the
# edges of tests/test_torch_gpu.py (D 20..256, groups 1, 3, 8, S 1..2048)
FLASH_MAIN = (8, 2048, 2048, 15, 5, 64, True)
FLASH_CHECKS = {
    "bfloat16": (FLASH_MAIN, (1, 1, 1, 8, 1, 256, True), (1, 17, 17, 6, 2, 20, True),
                 (2, 64, 77, 24, 3, 128, False), (1, 2048, 2048, 6, 2, 256, True),
                 (1, 17, 30, 3, 3, 64, False), (2, 129, 142, 8, 1, 256, False)),
    "float32": ((8, 512, 512, 15, 5, 64, True), (1, 1, 1, 8, 1, 256, True),
                (1, 17, 17, 6, 2, 20, True), (2, 64, 77, 24, 3, 128, False),
                (1, 2048, 2048, 6, 2, 256, True)),
}
# f32: |kernel - plain| <= tol + tol·|plain| (the JAX kernel test's f32
# tolerance, tests/test_flash_kernel.py); bf16: attention.bf16_gap, each
# element within 2 units in the last place and at most 2% of the elements
# (or 8) different at all, a check that must also refuse two broken
# controls at the prefill shape (p rounded to bf16 before P·V; a key tile
# dropped)
FLASH_TOL_F32 = 2e-5
# phase 4: the heads of two more served models, head dimensions 128 and 256
FLASH_ARCHS = ("qwen1.5-4b", "gemma-2b")

# phase 8, the LM serving main path: smollm-360m at full width and depth
LM_ARCH = "smollm-360m"
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 32
LM_PROMPT_F32 = 512
# kernel vs plain attention through the whole bf16 model, each step's
# logits: max|d| <= LM_TOL_BF16 · max|logit|.  This bounds the model's
# drift, not the kernel's error (phase 3 holds that to a few bf16 units in
# the last place): one-unit differences of the attention output grow
# through 32 bf16 layers, to 9.4e-3 of max|logit| on the H100.  f32:
# identical greedy tokens and max|d| <= 1e-4 · max|logit|
LM_TOL_BF16 = 3e-2
LM_TOL_F32 = 1e-4


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
    libs = _build.build_all(SOURCES)
    say(f"build: {', '.join(SOURCES)} in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        engine = False  # the radix-2 row engine's entries: one line each, below
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line:
                engine = "fft_radix2_kernel" in line or "ring_payload_kernel" in line
            if not engine and ("registers" in line or "spill" in line
                               or "smem" in line or "Compiling entry" in line):
                say(f"  ptxas {name}: {line.strip()[:150]}")
    radix2 = radix2_ptxas({name: _build.build_log(name) for name in RADIX2_SOURCES})
    return flash_sass(libs["flash_attention"], _build.build_log("flash_attention"),
                      _build.nvcc()), radix2


def _radix2_log2ns(dtype: str) -> list:
    """Every log2 N the radix-2 wrappers admit in ``dtype`` (shared memory
    bounds the top): the instantiations the row engine must have."""
    import torch

    from repro_torch.kernels import fft_radix2

    return list(range(1, fft_radix2.max_n(getattr(torch, dtype)).bit_length()))


def radix2_ptxas(logs: dict) -> list:
    """Phase 2, the radix-2 row engine: per instantiation of
    ``fft_radix2_kernel<T, L>`` and ``ring_payload_kernel<T, L, diag>``,
    ptxas's registers, spill bytes and static shared memory a block (the
    rows and twiddles are dynamic shared memory); fatal on any spill or on
    a log N the wrapper admits without an instantiation."""
    import re

    out = []
    for source, log in logs.items():
        cur = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '\S*?(fft_radix2_kernel|"
                          r"ring_payload_kernel)I([df])Li(\d+)E(?:Lb([01])E)?", line)
            if m:
                cur = {"source": source, "kernel": m.group(1),
                       "dtype": {"d": "float64", "f": "float32"}[m.group(2)],
                       "log2n": int(m.group(3)), "diag": m.group(4) == "1",
                       "registers": None, "spill_bytes": None, "smem": 0}
                out.append(cur)
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                m = re.search(r"(\d+) bytes smem", line)
                cur["smem"] = int(m.group(1)) if m else 0
                cur = None
    for (kernel, diag), label in (
            (("fft_radix2_kernel", False), "fft_radix2_kernel"),
            (("ring_payload_kernel", False), "ring_payload_kernel (forward, inverse)"),
            (("ring_payload_kernel", True), "ring_payload_kernel (roundtrip)")):
        for dtype in ("float64", "float32"):
            ks = sorted((k for k in out if (k["kernel"], k["diag"], k["dtype"])
                         == (kernel, diag, dtype)), key=lambda k: k["log2n"])
            say(f"  ptxas {label} {dtype}, log2 N: registers / spill bytes / static "
                "smem: " + ", ".join(f"{k['log2n']}: {k['registers']}/{k['spill_bytes']}/"
                                     f"{k['smem']}" for k in ks))
            want = _radix2_log2ns(dtype)
            if [k["log2n"] for k in ks] != want:
                fail(f"{label} {dtype}: instantiations {[k['log2n'] for k in ks]}, "
                     f"want log2 N {want}")
            spilled = [k for k in ks if k["spill_bytes"] != 0]
            if spilled:
                fail(f"{label} {dtype} spills: {spilled}")
    return out


def _short(mangled: str) -> str:
    """``flash_fwd_bf16<64>`` from the mangled name of an instantiation."""
    import re
    m = re.search(r"(flash_fwd_\w+?)(?:ILi(\d+)E|E)", mangled)
    return (f"{m.group(1)}<{m.group(2)}>" if m.group(2) else m.group(1)) if m else mangled


def flash_sass(lib, log: str, nvcc: str) -> list:
    """Phase 2, the redesign's proof: per flash-attention instantiation, the
    ``HGMMA`` and ``UTMALDG`` instructions in its SASS and ptxas's register
    and spill report; fatal if a bf16 one lacks either instruction or
    spills."""
    import re

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    kernels, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _short(m.group(1))
            kernels[fn] = {"name": fn, "HGMMA": 0, "UTMALDG": 0}
        elif fn:
            for op in ("HGMMA", "UTMALDG"):
                kernels[fn][op] += bool(re.search(rf"\b{op}\b", line))
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = _short(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn in kernels:
            kernels[fn]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn in kernels:
            kernels[fn]["registers"] = int(m.group(1))
    out = sorted(kernels.values(), key=lambda k: k["name"])
    for k in out:
        say(f"  sass {k['name']}: {k['HGMMA']} HGMMA, {k['UTMALDG']} UTMALDG, "
            f"{k.get('registers')} registers, {k.get('spill_bytes')} spill bytes")
    bf16 = [k for k in out if "bf16" in k["name"]]
    if len(bf16) != 4:
        fail(f"expected 4 bf16 flash-attention instantiations, found {bf16}")
    for k in bf16:
        if not k["HGMMA"] or not k["UTMALDG"] or k.get("spill_bytes", 1):
            fail(f"{k['name']}: {k['HGMMA']} HGMMA, {k['UTMALDG']} UTMALDG, "
                 f"{k.get('spill_bytes')} spill bytes (want wgmma, TMA, no spill)")
    return out


def flash_vs_plain(gen):
    """Phase 3, flash attention: the kernel against
    ``flash_attention_plain`` on the same CUDA tensors at ``FLASH_CHECKS``,
    bf16 by ``attention.bf16_gap`` and f32 by allclose; at the prefill shape
    the bf16 check must accept an unblocked f32 attention and refuse it
    with p rounded to bf16 and with a key tile dropped.  Returns the max
    abs error at the prefill shape (bf16), the largest error relative to
    max|plain| over the bf16 shapes, and the bf16 gaps."""
    import torch

    from repro_torch.kernels import attention

    main_abs, rel_bf16, gaps = 0.0, 0.0, []
    for name, shapes in FLASH_CHECKS.items():
        dtype = getattr(torch, name)
        for shape in shapes:
            b, s, t, h, hkv, d, causal = shape
            q = _rand((b, s, h, d), torch.float32, gen).to(dtype)
            k = _rand((b, t, hkv, d), torch.float32, gen).to(dtype)
            v = _rand((b, t, hkv, d), torch.float32, gen).to(dtype)
            pads = attention.pad_copies
            got = attention.flash_attention(q, k, v, causal=causal)
            pads = attention.pad_copies - pads
            want_pads = int(name == "bfloat16" and d % 8 != 0)
            want = attention.flash_attention_plain(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            where = (f"flash_attention {name} B={b} S={s} T={t} H={h} Hkv={hkv} "
                     f"D={d} {'causal' if causal else 'full'}")
            if name == "bfloat16":
                gap = attention.bf16_gap(got, want)
                ok = gap["ok"]
                gaps.append({"shape": list(shape), **gap})
                how = (f"{gap['worst']:.3f} of the element bound, "
                       f"{gap['mismatch']:.3%} of elements differ")
            else:
                ok = bool((((got - want).abs()) <= FLASH_TOL_F32
                           + FLASH_TOL_F32 * want.abs()).all()) \
                    and bool(torch.isfinite(got).all())
                how = f"allclose tol {FLASH_TOL_F32:g}"
            say(f"kernel vs plain: {where}: max|d| {err:.3e} = {err / scale:.3e} "
                f"max|o| ({how}), {pads} pad copies {'ok' if ok else 'FAIL'}")
            if pads != want_pads:
                fail(f"flash_attention made {pads} pad copies at {shape} {name} "
                     f"(want {want_pads})")
            if not ok:
                fail(f"flash_attention disagrees with its plain version at "
                     f"{shape} {name}")
            if shape == FLASH_MAIN and name == "bfloat16":
                main_abs = err
                for control, kw, want_ok in (
                        ("unblocked f32", {}, True),
                        ("p rounded to bf16", {"round_p": True}, False),
                        ("key tile dropped", {"drop_tile": True}, False)):
                    c = attention.bf16_gap(attention.bf16_control(q, k, v, **kw), want)
                    gaps.append({"control": control, **c})
                    say(f"  bf16 check, control {control}: {c['worst']:.3f} of the "
                        f"element bound, {c['mismatch']:.3%} of elements differ: "
                        f"{'accepted' if c['ok'] else 'refused'}")
                    if c["ok"] != want_ok:
                        fail(f"the bf16 check {'refused' if want_ok else 'accepted'} "
                             f"the control '{control}'")
            if name == "bfloat16":
                rel_bf16 = max(rel_bf16, err / scale)
            del q, k, v, got, want
        torch.cuda.empty_cache()
    return main_abs, rel_bf16, gaps


def flash_timing(gen):
    """Phase 4, flash attention, bf16 and causal at B=8, S=T=2048: at the
    prefill shape (smollm-360m's heads) and with the heads of
    ``FLASH_ARCHS`` (head dimensions 128 and 256); then the f32 kernel at
    phase 3's f32 prefill shape.  Each against ``scaled_dot_product_attention``
    on (B, H, S, D) views with ``enable_gqa`` (a yardstick the port never
    calls; f32 with TF32 off, as ``main`` sets), CUDA events; the plain
    version at the prefill shape only.  The bound is the larger of q, k, v
    and o's bytes over 3.35 TB/s and the kept pairs' flops over the peak of
    the units the kernel runs on (bf16 tensor cores; f32 CUDA cores).
    Returns one record a shape, the prefill shape's first."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention

    shapes = [("smollm-360m", FLASH_MAIN, torch.bfloat16, BF16_TC_FLOPS)]
    for arch in FLASH_ARCHS:
        cfg = get_config(arch)
        shapes.append((arch, (8, 2048, 2048, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_,
                              True), torch.bfloat16, BF16_TC_FLOPS))
    shapes.append(("smollm-360m f32", FLASH_CHECKS["float32"][0], torch.float32,
                   FP32_FLOPS))
    out = []
    for label, shape, dtype, peak in shapes:
        b, s, t, h, hkv, d, causal = shape
        q = _rand((b, s, h, d), torch.float32, gen).to(dtype)
        k = _rand((b, t, hkv, d), torch.float32, gen).to(dtype)
        v = _rand((b, t, hkv, d), torch.float32, gen).to(dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = _time_ms(lambda: attention.flash_attention(q, k, v, causal=causal), 20, 3)
        plain_ms = (_time_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=causal), 3, 1) if shape == FLASH_MAIN else None)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20, 3)
        moved = q.element_size() * (2 * b * s * h * d + 2 * b * t * hkv * d)
        flops = attention.attention_flops(b, s, t, h, d, causal)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        r = {"kernel": "flash_attention", "label": label, "shape": list(shape),
             "dtype": str(dtype).removeprefix("torch."), "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms, "bytes": moved,
             "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        plain = f"plain {plain_ms:.3f} ms, " if plain_ms is not None else ""
        say(f"timing flash_attention ({label}) B={b} S={s} H={h} Hkv={hkv} D={d} "
            f"{r['dtype']} {'causal' if causal else 'full'}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), {plain}sdpa {library_ms:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {moved} B "
            f"{bytes_ms:.4f} ms, {flops:.4g} flop {ops_ms:.4f} ms), "
            f"{r['bound_ms'] / ms:.1%} of the bound")
        out.append(r)
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def _logit_gaps(a, b):
    """Per step: max|a - b| over max|a|."""
    return [(x.float() - y.float()).abs().max().item() / x.float().abs().max().item()
            for x, y in zip(a, b)]


def lm_serving(flash_rel_bf16):
    """Phase 8: the LM serving main path.  ``smollm-360m`` at full width
    and depth, bf16 as configured, random weights from seed 0, batch 8,
    prompt 2048, 32 greedy tokens through ``repro_torch.launch.serve``;
    the flash-attention counts set to 0 just before and read just after
    (one launch a layer, no plain call).  Then the same prompts with the
    plain attention (``RunCfg(plain_attention=True)``), teacher-forced
    with the kernel run's tokens, every step's logits within
    ``LM_TOL_BF16``; and both at f32 (prompt 512), free-running: identical
    tokens, logits within ``LM_TOL_F32``.  One ``torch.profiler`` trace of
    a prefill and of a decode step (informational)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg = get_config(LM_ARCH)
    run, plain_run = T.RunCfg(), T.RunCfg(plain_attention=True)
    model = T.init_model(cfg, seed=0, device="cuda")
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, "cuda")
    serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention.plain_calls = attention.pad_copies = 0
    r = serve.generate(cfg, run, model, tokens, LM_GEN, keep_logits=True)
    counts = {"flash_attention": attention.launches,
              "flash_attention_plain": attention.plain_calls,
              "pad_copies": attention.pad_copies}
    peak = torch.cuda.max_memory_allocated()
    steps = LM_GEN - 1
    out = {"arch": LM_ARCH, "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
           "dtype": cfg.compute_dtype, "counts": counts,
           "prefill_ms": r["prefill_ms"], "decode_ms": r["decode_ms"],
           "decode_ms_per_step": r["decode_ms"] / steps,
           "tok_per_s": steps * LM_BATCH / (r["decode_ms"] / 1e3),
           "peak_bytes": peak, "sample": r["tokens"][0, :16].tolist()}
    say(f"LM serving {LM_ARCH} bf16 B={LM_BATCH} prompt={LM_PROMPT} gen={LM_GEN}: "
        f"prefill {out['prefill_ms']:.3f} ms, decode {r['decode_ms']:.3f} ms "
        f"({out['decode_ms_per_step']:.3f} ms/step, {out['tok_per_s']:.1f} tok/s), "
        f"peak {peak / 2**30:.2f} GiB, counts {counts}, sample {out['sample']}")
    if counts["flash_attention"] != cfg.n_layers or counts["flash_attention_plain"] \
            or counts["pad_copies"]:
        fail(f"the LM prefill launched flash_attention {counts['flash_attention']} "
             f"times (want {cfg.n_layers}, one a layer) with "
             f"{counts['flash_attention_plain']} plain calls and "
             f"{counts['pad_copies']} pad copies")
    if tuple(r["tokens"].shape) != (LM_BATCH, LM_GEN) or not all(
            bool(torch.isfinite(x).all()) for x in r["logits"]):
        fail(f"LM serving: tokens {tuple(r['tokens'].shape)}, non-finite logits")
    if tuple(r["logits"][0].shape) != (LM_BATCH, 1, cfg.vocab):
        fail(f"LM serving: prefill logits {tuple(r['logits'][0].shape)}")

    p = serve.generate(cfg, plain_run, model, tokens, LM_GEN, forced=r["tokens"],
                       keep_logits=True)
    gaps = _logit_gaps(r["logits"], p["logits"])
    out.update(plain_prefill_ms=p["prefill_ms"], plain_decode_ms=p["decode_ms"],
               gap_prefill=gaps[0], gap_decode_max=max(gaps[1:]),
               plain_agrees=float((p["tokens"] == r["tokens"]).float().mean()),
               tol=LM_TOL_BF16, flash_rel_bf16=flash_rel_bf16)
    say(f"LM kernel vs plain attention (bf16, teacher-forced): logits gap "
        f"prefill {gaps[0]:.3e}, decode steps max {max(gaps[1:]):.3e} of max|logit| "
        f"(tol {LM_TOL_BF16:g}; phase 3's bf16 kernel error {flash_rel_bf16:.3e} "
        f"of max|o|); plain's own greedy choice agrees on "
        f"{out['plain_agrees']:.1%} of the tokens; plain prefill "
        f"{p['prefill_ms']:.3f} ms")
    if max(gaps) > LM_TOL_BF16:
        fail(f"LM bf16: kernel and plain attention logits differ by "
             f"{max(gaps):.3e} > {LM_TOL_BF16} of max|logit|")
    prof_prefill = _profile(lambda: T.prefill(cfg, run, model, {"tokens": tokens},
                                              t_max=LM_PROMPT + LM_GEN),
                            f"LM prefill {LM_ARCH} B={LM_BATCH} S={LM_PROMPT}")
    cache, tok = r["cache"], r["tokens"][:, -1:]
    prof_decode = _profile(lambda: T.decode_step(cfg, run, model, cache, tok),
                           f"LM decode step {LM_ARCH} B={LM_BATCH} at T={cache['len']}")
    for line in prof_prefill["lines"] + prof_decode["lines"]:
        say(line)
    out["breakdown"] = [prof_prefill, prof_decode]
    del r, p, cache
    torch.cuda.empty_cache()

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    t32 = tokens[:, :LM_PROMPT_F32]
    attention.launches = attention.plain_calls = 0
    k32 = serve.generate(cfg32, run, model, t32, LM_GEN, keep_logits=True)
    n32 = attention.launches
    p32 = serve.generate(cfg32, plain_run, model, t32, LM_GEN, keep_logits=True)
    gaps32 = _logit_gaps(k32["logits"], p32["logits"])
    same = bool(torch.equal(k32["tokens"], p32["tokens"]))
    out["f32"] = {"prompt": LM_PROMPT_F32, "prefill_ms": k32["prefill_ms"],
                  "decode_ms": k32["decode_ms"], "plain_prefill_ms": p32["prefill_ms"],
                  "same_tokens": same, "gap_max": max(gaps32), "launches": n32,
                  "tol": LM_TOL_F32}
    say(f"LM f32 (prompt {LM_PROMPT_F32}): kernel prefill {k32['prefill_ms']:.3f} ms "
        f"({n32} launches), plain {p32['prefill_ms']:.3f} ms; greedy tokens "
        f"{'identical' if same else 'DIFFER'}, logits gap max {max(gaps32):.3e} of "
        f"max|logit| (tol {LM_TOL_F32:g})")
    if n32 != cfg.n_layers or not same or max(gaps32) > LM_TOL_F32:
        fail(f"LM f32: launches {n32}, same tokens {same}, gap {max(gaps32):.3e}")
    del model, k32, p32
    torch.cuda.empty_cache()
    return out


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


# (rows, N) held against the plain version: the main path's shapes first;
# fft_radix2 then takes every N its instantiations cover (radix2_shapes)
CHECK_SHAPES = {
    "fft_radix2": ((512 * 512, 512), (257 * 512, 512)),
    "fft_mxu": ((512 * 512, 512), (257 * 512, 512), (512 * 256, 256),
                (4096, 2), (4096, 4), (4096, 16), (1024, 8192)),
}
MAIN_N = (512, 256)
#: values a row count of radix2_shapes aims at (re or im, one dtype)
RADIX2_ELEMENTS = 2 ** 21


def radix2_shapes(dtype: str):
    """(rows, N) for every log2 N the radix-2 row engine instantiates in
    ``dtype``: about ``RADIX2_ELEMENTS`` values in an odd number of rows
    (not a multiple of the rows a block, which are a power of two), and
    one row."""
    return [(rows, 1 << l) for l in _radix2_log2ns(dtype)
            for rows in (RADIX2_ELEMENTS // (1 << l) + 1, 1)]


def _rel_err(got, want):
    """(max abs error, its ratio to max|want|) over a planar pair."""
    scale = max(want[0].abs().max().item(), want[1].abs().max().item())
    err = max((got[0] - want[0]).abs().max().item(),
              (got[1] - want[1]).abs().max().item())
    return err, err / scale


def kernel_vs_plain(gen):
    """Phase 3: returns, per kernel, the max abs error at the main path's
    f64 shapes.  One line a kernel, dtype and direction (the worst shape);
    a failing shape is named."""
    import torch

    main_abs = {}
    for name in KERNELS:
        kernel, plain = _pair(name)
        main_abs[name] = 0.0
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            tol = TOL[dname]
            shapes = list(CHECK_SHAPES[name])
            if name == "fft_radix2":
                shapes += radix2_shapes(dname)
            worst = {False: (0.0, None), True: (0.0, None)}
            for rows, n in shapes:
                xr, xi = _rand((rows, n), dtype, gen), _rand((rows, n), dtype, gen)
                for inverse in (False, True):
                    got = kernel(xr, xi, inverse=inverse)
                    want = plain(xr, xi, inverse=inverse)
                    torch.cuda.synchronize()
                    err, rel = _rel_err(got, want)
                    if rel > tol:
                        fail(f"{name} disagrees with its plain version at rows={rows} "
                             f"N={n} {dname} inverse={inverse}: max|d| {err:.3e} = "
                             f"{rel:.3e} max|y| > {tol:g}")
                    if rel >= worst[inverse][0]:
                        worst[inverse] = (rel, (rows, n))
                    if dtype == torch.float64 and n in MAIN_N and rows > 1:
                        main_abs[name] = max(main_abs[name], err)
                    del got, want
                del xr, xi
                torch.cuda.empty_cache()
            for inverse, (rel, where) in worst.items():
                say(f"kernel vs plain: {name} {dname} {'inverse' if inverse else 'forward'}"
                    f", {len(shapes)} shapes (N {min(n for _, n in shapes)}.."
                    f"{max(n for _, n in shapes)}): worst {rel:.3e} max|y| at rows, N = "
                    f"{where} (tol {tol:g}) ok")
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


def _median_ms(fn, iters: int, warmup: int, reps: int = 7) -> tuple:
    """(median, min, max) of ``reps`` timings of ``_time_ms(fn, iters)``."""
    import statistics
    times = [_time_ms(fn, iters, warmup if i == 0 else 0) for i in range(reps)]
    return statistics.median(times), min(times), max(times)


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
        library_ms = _median_ms(lambda: torch.fft.fft(z), iters=20, warmup=3)[0]
        for name in KERNELS:
            kernel, plain = _pair(name)
            ms, lo, hi = _median_ms(lambda: kernel(xr, xi), iters=20, warmup=3)
            plain_ms = _time_ms(lambda: plain(xr, xi), iters=3, warmup=1)
            moved, flops, peak = _work(name, rows, n, item)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / peak * 1e3
            t = {"kernel": name, "rows": rows, "n": n, "dtype": "float64",
                 "ms": ms, "ms_spread": [lo, hi], "plain_ms": plain_ms,
                 "library_ms": library_ms,
                 "bytes": moved, "flops": flops,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            say(f"timing {name} rows={rows} N={n} f64: kernel {ms:.4f} ms "
                f"(median of 7; {lo:.4f}..{hi:.4f}), "
                f"plain {plain_ms:.3f} ms, torch.fft {library_ms:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {moved} B "
                f"{bytes_ms:.4f} ms, {flops:.0f} flop {ops_ms:.4f} ms), "
                f"{t['bound_ms'] / ms:.1%} of the bound")
            out.append(t)
            torch.cuda.empty_cache()
        del xr, xi, z
        torch.cuda.empty_cache()
    return out


def _save(path, fields):
    import numpy as np
    for i, f in enumerate(fields):
        np.save(f"{path}_{i}.npy", f.cpu().numpy())


def _run_case(case, n, steps, knobs, backend, save=None):
    """One 1×1 run; ``save`` names where its initial and final fields go
    (``.npy``), as the reference of the multi-rank runs."""
    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver

    solver = make_solver(case, PencilGrid.from_mesh(1, 1), n, device="cuda",
                         plan_cfg={"backend": backend, **knobs})
    torch.cuda.reset_peak_memory_stats()
    state = solver.init_state()
    if save:
        _save(f"{save}_init", state.fields)
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
    if save:
        _save(save, state.fields)
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
    for i, (case, n, steps, knobs) in enumerate(MAIN_PATH):
        before = _counts()[name]
        # the radix-2 runs of REFERENCE are what the multi-rank runs hold to
        save = (os.path.join(REF_DIR, case) if name == "fft_radix2"
                and REFERENCE.get(case) == i else None)
        r = _run_case(case, n, steps, knobs, BACKEND[name], save=save)
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


def _profile(step, label: str) -> dict:
    """Device time by kernel name over one call of ``step()`` from
    ``torch.profiler`` (this process's kernels), and the host-clock wall
    time around it; busy over wall gives the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    lines = [f"breakdown {label}: the profiler saw no device time (not measured)"]
    if rows:
        lines = [f"breakdown {label}: wall {wall_ms:.3f} ms, device busy "
                 f"{busy_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.1%}"]
        lines += [f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{c:<4d} {k[:90]}"
                  for ms, c, k in rows[:8]]
    return {"label": label, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "kernels": [{"ms": ms, "count": c, "name": k[:120]}
                        for ms, c, k in rows], "lines": lines}


def breakdown(backend):
    """Phase 6: where one heat step at N=512 spends the card's time."""
    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver

    solver = make_solver("heat", PencilGrid.from_mesh(1, 1), 512,
                         device="cuda", plan_cfg={"backend": backend})
    state = solver.step(solver.init_state())
    out = _profile(lambda: solver.step(state),
                   f"heat N=512 step, backend {backend!r}")
    for line in out["lines"]:
        say(line)
    del solver, state
    torch.cuda.empty_cache()
    return out


def ring_vs_plain(gen):
    """Phase 3, the ring kernels: ``ring_payload`` in its three modes against
    ``payload_plain`` (f64 and f32, N=16, 512, 8192, tolerance ``TOL``);
    ``ring_send``/``ring_land`` against plain indexing, bit for bit, the
    "peer" slot a second buffer of this process.  Returns each kernel's
    max abs error at the main path's shape (N=512 f64)."""
    import torch

    from repro_torch.kernels import fft_radix2, ring_rdma

    err512 = 0.0
    for mode in ("forward", "inverse", "roundtrip"):
        for dtype in (torch.float64, torch.float32):
            dname = str(dtype).removeprefix("torch.")
            tol = TOL[dname]
            shapes = [(PAYLOAD_ROWS[n], n) for n in PAYLOAD_N] + radix2_shapes(dname)
            worst = (0.0, None)
            for rows, n in shapes:
                xr, xi, dr, di = (_rand((rows, n), dtype, gen) for _ in range(4))
                diag = (dr, di) if mode == "roundtrip" else None
                got = ring_rdma.ring_payload(xr, xi, diag=diag, inverse=mode == "inverse")
                twr, twi = fft_radix2.twiddles(n, dtype, xr.device)
                want = ring_rdma.payload_plain(xr, xi, twr, twi, diag, mode == "inverse")
                torch.cuda.synchronize()
                err, rel = _rel_err(got, want)
                if rel > tol:
                    fail(f"ring_payload {mode} disagrees with its plain version at "
                         f"rows={rows} N={n} {dname}: max|d| {err:.3e} = {rel:.3e} "
                         f"max|y| > {tol:g}")
                if rel >= worst[0]:
                    worst = (rel, (rows, n))
                if dtype == torch.float64 and (rows, n) == (PAYLOAD_ROWS[512], 512):
                    err512 = max(err512, err)
                del xr, xi, dr, di, got, want
            torch.cuda.empty_cache()
            say(f"kernel vs plain: ring_payload {mode} {dname}, {len(shapes)} shapes "
                f"(N {min(n for _, n in shapes)}..{max(n for _, n in shapes)}): worst "
                f"{worst[0]:.3e} max|y| at rows, N = {worst[1]} (tol {tol:g}) ok")
    p, blk = 4, SLAB[2] // 4
    for dtype in (torch.float64, torch.float32):
        xs = [_rand(SLAB, dtype, gen) for _ in range(2)]
        slots = [torch.empty(SLAB[:2] + (blk,), dtype=dtype, device="cuda")
                 for _ in range(2)]
        ring_rdma.ring_send(xs, 1, p, 2, slots)
        outs = [torch.empty((SLAB[0], p * SLAB[1], blk), dtype=dtype,
                            device="cuda") for _ in range(2)]
        ring_rdma.ring_land(slots, outs, 2, p, 1)
        ring_rdma.ring_land([x[..., :blk] for x in xs], outs, 0, p, 1)
        torch.cuda.synchronize()
        send_ok = all(torch.equal(s_, x[..., blk:2 * blk]) for s_, x in zip(slots, xs))
        land_ok = all(torch.equal(o[:, 2 * SLAB[1]:3 * SLAB[1]], s_)
                      and torch.equal(o[:, :SLAB[1]], x[..., :blk])
                      for o, s_, x in zip(outs, slots, xs))
        say(f"kernel vs plain: ring_send {str(dtype)[6:]} {SLAB} block 1 of "
            f"{p}: {'bit for bit' if send_ok else 'FAIL'}; ring_land (a "
            f"slot, and the own block strided): "
            f"{'bit for bit' if land_ok else 'FAIL'}")
        if not (send_ok and land_ok):
            fail("ring_send/ring_land disagree with plain indexing")
    return {"ring_payload": err512, "ring_send": 0.0, "ring_land": 0.0}


def ring_timing(gen):
    """Phase 4, the ring kernels at run (a)'s shapes, f64, CUDA events:
    each kernel, its plain version, PyTorch's own call where one computes
    the same function (``torch._foreach_copy_`` of both arrays' blocks for
    the wire kernels), and the bound.  The roundtrip mode has no one
    PyTorch call; ``torch.fft.fft`` + multiply + ``torch.fft.ifft`` are
    timed apart and reported as their sum (``library_sum_ms``)."""
    import math

    import torch

    from repro_torch.kernels import fft_radix2, ring_rdma

    n, item, rows = 512, 8, PAYLOAD_ROWS[512]
    stages = int(math.log2(n))
    twr, twi = fft_radix2.twiddles(n, torch.float64, torch.device("cuda"))
    xr, xi, dr, di = (_rand((rows, n), torch.float64, gen) for _ in range(4))
    z, d = torch.complex(xr, xi), torch.complex(dr, di)
    lib = {"fft": _median_ms(lambda: torch.fft.fft(z), 20, 3)[0],
           "ifft": _median_ms(lambda: torch.fft.ifft(z), 20, 3)[0],
           "mul": _median_ms(lambda: z * d, 20, 3)[0]}
    out = []
    for mode in ("forward", "inverse", "roundtrip"):
        diag = (dr, di) if mode == "roundtrip" else None
        inv = mode == "inverse"
        ms, lo, hi = _median_ms(lambda: ring_rdma.ring_payload(
            xr, xi, diag=diag, inverse=inv), 20, 3)
        plain_ms = _time_ms(lambda: ring_rdma.payload_plain(
            xr, xi, twr, twi, diag, inv), 3, 1)
        arrays = 6 if diag else 4
        moved = arrays * rows * n * item + 2 * stages * (n // 2) * item
        flops = rows * (5 * n * stages * (2 if diag else 1)
                        + (6 * n if diag else 0))
        t = {"kernel": "ring_payload", "mode": mode, "rows": rows, "n": n,
             "ms": ms, "ms_spread": [lo, hi], "plain_ms": plain_ms,
             "bytes": moved, "flops": flops,
             "library_ms": {"forward": lib["fft"], "inverse": lib["ifft"]}.get(mode),
             "library_sum_ms": (lib["fft"] + lib["mul"] + lib["ifft"]
                                if diag else None)}
        out.append(t)
    blk = SLAB[2] // 4
    xs = [_rand(SLAB, torch.float64, gen) for _ in range(2)]
    slots = [torch.empty(SLAB[:2] + (blk,), dtype=torch.float64, device="cuda")
             for _ in range(2)]
    outs = [torch.empty((SLAB[0], 4 * SLAB[1], blk), dtype=torch.float64,
                        device="cuda") for _ in range(2)]

    blocks = [x[..., blk:2 * blk] for x in xs]
    places = [o[:, SLAB[1]:2 * SLAB[1]] for o in outs]

    def send_plain():
        for s_, b in zip(slots, blocks):
            s_.copy_(b)

    def land_plain():
        for o, s_ in zip(places, slots):
            o.copy_(s_)
    moved = 2 * SLAB[0] * SLAB[1] * blk * item  # both arrays' block
    for name, kernel, plain, library in (
            ("ring_send", lambda: ring_rdma.ring_send(xs, 1, 4, 2, slots),
             send_plain, lambda: torch._foreach_copy_(slots, blocks)),
            ("ring_land", lambda: ring_rdma.ring_land(slots, outs, 1, 4, 1),
             land_plain, lambda: torch._foreach_copy_(places, slots))):
        # on one card a copy reads and writes HBM: 2 * bytes; medians of 7
        # timings, their spread beside them (these copies spread from call
        # to call)
        ms, lo, hi = _median_ms(kernel, 50, 5)
        out.append({"kernel": name, "mode": "2 arrays",
                    "shape": SLAB[:2] + (blk,), "ms": ms, "ms_spread": [lo, hi],
                    "plain_ms": _median_ms(plain, 50, 5)[0], "bytes": 2 * moved,
                    "flops": 0, "library_ms": _median_ms(library, 50, 5)[0],
                    "library_sum_ms": None})
    for t in out:
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["flops"] / FP64_FLOPS * 1e3
        t["bound_ms"] = max(bytes_ms, ops_ms)
        t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        lib = (f"torch {t['library_ms']:.4f} ms" if t["library_ms"] is not None
               else (f"fft+mul+ifft (a sum of 3 calls) {t['library_sum_ms']:.4f} ms"
                     if t["library_sum_ms"] is not None else "no one torch call"))
        lo, hi = t["ms_spread"]
        say(f"timing {t['kernel']} {t['mode']} f64: kernel {t['ms']:.4f} ms (median "
            f"of 7; {lo:.4f}..{hi:.4f}), "
            f"plain {t['plain_ms']:.4f} ms, {lib}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} B), {t['bound_ms'] / t['ms']:.1%} "
            "of the bound")
    del xr, xi, dr, di, z, d, xs, slots, outs, blocks, places
    torch.cuda.empty_cache()
    return out


def _ring_counts():
    from repro_torch.kernels import fft_radix2, ref, ring_rdma
    return {"ring_payload": ring_rdma.payload_launches,
            "ring_send": ring_rdma.send_launches,
            "ring_land": ring_rdma.land_launches,
            "fft_radix2": fft_radix2.launches, "ref.calls": ref.calls,
            "payload_plain": ring_rdma.plain_calls}


def _zero_ring_counts():
    from repro_torch.kernels import fft_radix2, ref, ring_rdma
    ring_rdma.payload_launches = ring_rdma.send_launches = 0
    ring_rdma.land_launches = ring_rdma.plain_calls = 0
    fft_radix2.launches = ref.calls = 0


def _wire_vs_plain(ctx):
    """Phase 7, in each rank: both NIC engines' fold and unfold of N=64
    blocks on the peer-mapped wire and on the gloo wire (the same random
    blocks, on the card and on the host), twice in a row with different
    data; True where they match bit for bit."""
    import torch

    from repro_torch import dist
    from repro_torch.core import comm
    from repro_torch.core.decomposition import XY_STEP, YZ_STEP
    from repro_torch.core.engine_spec import EngineSpec

    same = {}
    for pu, pv in WIRE_MESHES:
        c = dist.regrid(pu, pv)
        grid = c.grid()
        for engine in ("pallas_ring", "bidi_ring"):
            eng = comm.build_engine(EngineSpec(engine=engine), grid)
            ok = True
            for seed in (1, 2):
                g = torch.Generator().manual_seed(1000 * seed + ctx.rank)
                x = torch.randn(64 // pu, 64 // pv, 64, dtype=torch.float64,
                                generator=g)
                for step in (XY_STEP, YZ_STEP):
                    a = eng.fold_step(step, x.to(c.device))
                    b = eng.fold_step(step, x)
                    ua, ub = eng.unfold_step(step, a), eng.unfold_step(step, b)
                    ok = ok and torch.equal(a.cpu(), b) \
                        and torch.equal(ua.cpu(), ub) and torch.equal(ub, x)
            same[f"{pu}x{pv}/{engine}"] = ok
    return same


def _multi_rank_run(ctx, tag, case, mesh, cfg, ref_hist, n):
    """Phase 7, in each rank: one multi-rank run of the main path at N=n,
    its counts set to 0 just before its steps and read just after."""
    import numpy as np
    import torch

    from repro_torch import dist
    from repro_torch.core import transpose as tr
    from repro_torch.core.fft3d import gather_pencil
    from repro_torch.solvers import make_solver
    from repro_torch.solvers.base import observables_rel_err

    c = dist.regrid(*mesh)
    grid = c.grid()
    dev = c.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    solver = make_solver(case, grid, n, device=dev, plan_cfg=cfg)
    state = solver.init_state()
    r = {"tag": tag, "case": case, "mesh": list(mesh), **cfg}
    if case == "heat":  # block for block the 1x1 initial field
        u, v = grid.coords
        whole = np.load(os.path.join(REF_DIR, "heat_init_0.npy"), mmap_mode="r")
        a, b = whole.shape[0] // grid.pu, whole.shape[1] // grid.pv
        block = torch.from_numpy(np.array(whole[u * a:(u + 1) * a, v * b:(v + 1) * b]))
        r["init_blocks"] = bool(torch.equal(state.fields[0].cpu(), block))
    before = {k: (w.exchanges, w.rounds) for k, w in c.wires().items()}
    history = [solver.observables(state)]
    step_ms = []
    if cuda:
        torch.cuda.synchronize(dev)
    _zero_ring_counts()
    for _ in range(MULTI_STEPS):
        t0 = time.perf_counter()
        state = solver.step(state)
        if cuda:
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(solver.observables(state))
    r["counts"] = _ring_counts()
    model = tr.bidi_rounds if cfg["comm_engine"] == "bidi_ring" else tr.ring_rounds
    r["wires"] = {}
    for (dim, kind), w in c.wires().items():
        if kind == dev.type:
            ex0, ro0 = before.get((dim, kind), (0, 0))
            r["wires"][dim] = {"p": w.p, "exchanges": w.exchanges - ex0,
                               "rounds": w.rounds - ro0,
                               "model_rounds": (w.exchanges - ex0) * model(w.p)}
    r["exchange_rounds"] = solver.plan.engine().exchange_rounds
    r["step_ms"] = step_ms
    r["obs_rel_err"] = max(observables_rel_err(a, b)
                           for a, b in zip(history, ref_hist))
    r["history"] = history
    r["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    fields = [gather_pencil(f, grid) for f in state.fields]
    if cuda:  # one more step, every rank; rank 0 traces its own kernels
        step = (lambda: solver.step(state))
        if ctx.rank == 0:
            r["breakdown"] = _profile(step, f"({tag}) {case} {mesh[0]}x{mesh[1]} "
                                            "step, rank 0's kernels")
        else:
            step()
    if ctx.rank == 0:
        errs = []
        for i, f in enumerate(fields):
            want = np.load(os.path.join(REF_DIR, f"{case}_{i}.npy"), mmap_mode="r")
            got = f.numpy()
            errs.append(float(np.abs(got - want).max() / np.abs(want).max())
                        if got.shape == want.shape else float("inf"))
        r["field_rel_err"] = max(errs)
        r["finite"] = all(bool(torch.isfinite(f).all()) for f in fields)
        r["shapes"] = [list(f.shape) for f in fields]
    del solver, state, fields
    if cuda:
        torch.cuda.empty_cache()
    return r


def _ranks_main(ctx, ref_hists, n=512):
    """Everything the 4 rank processes do: the wire against its plain
    version, then the three runs of the multi-rank main path."""
    return {"rank": ctx.rank, "wire": _wire_vs_plain(ctx),
            "runs": [_multi_rank_run(ctx, tag, case, mesh, cfg, ref_hists[case], n)
                     for tag, case, mesh, cfg in MULTI_RANK]}


def multi_rank(runs):
    """Phase 7: one spawn of 4 rank processes on the one card (the parent's
    cache freed first): the wire against its plain version, then the
    multi-rank main path held against the 1×1 radix-2 runs of phase 5 —
    per-step observables and final fields within 1e-10, counts of every
    kernel the run's mode uses above 0, no plain version, and
    ``exchange_rounds`` equal to the round model summed over the wires."""
    import torch

    from repro_torch import dist

    ref_hists = {case: runs["fft_radix2"][i]["history"]
                 for case, i in REFERENCE.items()}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.run_ranks(_ranks_main, 4, 1, device="cuda", args=(ref_hists,),
                           timeout=900)
    say(f"multi-rank: 4 rank processes on one card in "
        f"{time.perf_counter() - t0:.1f} s")
    for key in ranks[0]["wire"]:
        same = all(r["wire"][key] for r in ranks)
        say(f"wire vs plain {key} N=64, two exchanges a fold: "
            f"{'bit for bit' if same else 'FAIL'} on every rank")
        if not same:
            fail(f"the peer-mapped wire disagrees with gloo: {key}")
    launches = dict.fromkeys(RING_KERNELS, 0)
    for i, (tag, case, mesh, cfg) in enumerate(MULTI_RANK):
        rs = [r["runs"][i] for r in ranks]
        r0 = rs[0]
        name = f"({tag}) {case} {mesh[0]}x{mesh[1]} {cfg['comm_engine']}"
        for rank, r in enumerate(rs):
            c = r["counts"]
            say(f"{name} rank {rank}: ms/step {[round(t, 3) for t in r['step_ms']]}, counts {c}, "
                f"exchange_rounds {r['exchange_rounds']}, wires {r['wires']}, "
                f"peak {r['peak_bytes'] / 2**30:.2f} GiB, obs vs 1x1 "
                f"{r['obs_rel_err']:.2e}")
            for k in ("ring_payload", "ring_send", "ring_land", "fft_radix2"):
                if c[k] == 0:
                    fail(f"{name}: {k} never launched")
            if c["ref.calls"] or c["payload_plain"]:
                fail(f"{name}: a plain version ran: {c}")
            wire_rounds = sum(w["rounds"] for w in r["wires"].values())
            if r["exchange_rounds"] != wire_rounds or any(
                    w["rounds"] != w["model_rounds"] for w in r["wires"].values()):
                fail(f"{name}: exchange_rounds {r['exchange_rounds']} vs the "
                     f"wires {r['wires']}")
            if r["obs_rel_err"] > 1e-10:
                fail(f"{name}: observables differ from the 1x1 run by "
                     f"{r['obs_rel_err']:.3e} > 1e-10")
            if r.get("init_blocks") is False:
                fail(f"{name}: initial fields differ from the 1x1 blocks")
            for k in RING_KERNELS:
                launches[k] += c[k]
        for line in r0.get("breakdown", {}).get("lines", []):
            say(line)
        say(f"{name}: final fields vs 1x1 {r0['field_rel_err']:.2e} max|y|, "
            f"finite {r0['finite']}, shapes {r0['shapes']}"
            + (f", initial fields = 1x1 blocks on every rank" if "init_blocks" in r0 else ""))
        if not r0["finite"] or r0["field_rel_err"] > 1e-10:
            fail(f"{name}: final fields differ from the 1x1 run by "
                 f"{r0['field_rel_err']:.3e} (finite {r0['finite']})")
    return ranks, launches


REPLACES = {"flash_attention": "src/repro/kernels/attention.py:68",
            "fft_radix2": "src/repro/kernels/fft_radix2.py:90",
            "fft_mxu": "src/repro/kernels/fft_mxu.py:80",
            "ring_payload": "src/repro/kernels/ring_rdma.py:153",
            "ring_send": "src/repro/kernels/ring_rdma.py:88",
            "ring_land": "src/repro/kernels/ring_rdma.py:101"}


def main() -> int:
    name, smi = card()
    sys.path.insert(0, SRC)
    import torch

    # the plain versions' products go through cuBLAS: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    flash_sass_counts, radix2_build = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs = kernel_vs_plain(gen)
    max_abs.update(ring_vs_plain(gen))
    max_abs["flash_attention"], flash_rel, flash_gaps = flash_vs_plain(gen)
    times = timing(gen)
    ring_times = ring_timing(gen)
    flash_times = flash_timing(gen)
    flash_time = flash_times[0]
    os.makedirs(REF_DIR, exist_ok=True)
    runs, launches = main_path()
    prof = [breakdown(BACKEND[k]) for k in KERNELS]
    ranks, ring_launches = multi_rank(runs)
    launches.update(ring_launches)
    lm = lm_serving(flash_rel)
    launches["flash_attention"] = lm["counts"]["flash_attention"]

    kernels = []
    for k in KERNELS:
        t = next(t for t in times if t["kernel"] == k)  # 512·512 rows
        kernels.append({
            "name": k, "route": "cuda", "source": f"src/repro_torch/csrc/{k}.cu",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": max_abs[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    for k in RING_KERNELS:
        t = next(t for t in ring_times if t["kernel"] == k)  # payload: forward
        kernels.append({
            "name": k, "route": "cuda", "source": "src/repro_torch/csrc/ring_rdma.cu",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": max_abs[k], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    t = flash_time
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": REPLACES["flash_attention"], "launches": launches["flash_attention"],
        "max_abs_err": max_abs["flash_attention"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"]})
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump({"card": smi, "device": name,
                   "timing": times + ring_times + flash_times,
                   "flash_sass": flash_sass_counts, "radix2_ptxas": radix2_build,
                   "kernels": kernels, "runs": runs, "breakdown": prof,
                   "multi_rank": ranks, "flash_bf16_gaps": flash_gaps, "lm": lm},
                  f, indent=1)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
