#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; nothing of
JAX or of the JAX package ``repro``).  It covers the six kernels of the
port's three main paths.  The solver step: ``fft_radix2`` (backend
``"pallas"``), ``fft_mxu`` (backend ``"mxu"``, the four-step FFT on the
FP64 tensor cores), and the NIC engine's ``ring_payload``, ``ring_send``
and ``ring_land`` (``csrc/ring_rdma.cu``, engines
``pallas_ring``/``bidi_ring`` on a grid of more than one rank).  LM
serving and training: ``flash_attention`` (``csrc/flash_attention.cu``),
the attention of every layer of the prefill and of every forward of a
training step; sharded over a mesh of rank processes, the LM's
collectives run on ``ring_send`` and ``ring_land`` too.  Phases, each
fatal on failure:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build — the four CUDA sources, ``nvcc`` processes started together,
   with each one's register, shared-memory and spill report (for the
   radix-2 row engine, one line of registers / spill bytes / static shared
   memory for each instantiation of ``fft_radix2_kernel<T, L>`` and
   ``ring_payload_kernel<T, L, diag>``; for ``fft_mxu``, registers and
   spill bytes of ``fft_mxu_tc_kernel<L>`` at every log2 N 6..13 and of
   the CUDA-core kernel in f32 and f64; for the wire copies, each
   element width; fatal on any spill or a missing instantiation); then the
   flash-attention library's SASS (``cuobjdump --dump-sass``): each bf16
   instantiation's ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) counts and
   its registers and spill bytes from ptxas — fatal if one has no
   ``HGMMA``, no ``UTMALDG`` or any spill;
3. kernel vs plain — each FFT kernel against its plain PyTorch version on
   the same CUDA tensors, f64 and f32, forward and inverse, at the main
   path's shapes (N=512 with 512·512 and 257·512 rows; for ``fft_mxu``
   also N=256 with 512·256 rows) and the edges (every N the kernel's
   instantiations cover -- ``fft_radix2`` 2..8192 in f64 and 2..16384 in
   f32, ``fft_mxu`` 2..8192 in both -- each with one row and with an odd
   number of rows, not a multiple of the rows a block).  Tolerance: max|Δ| ≤
   1e-12·max|y| in f64 and ≤ 1e-5·max|y| in f32.  ``fft_radix2`` has the
   same twiddles and butterflies as its plain version, grouped into
   passes, only the compiler's FMA contraction differs; ``fft_mxu`` sums
   in another order
   inside its tensor-core tiles than cuBLAS does in the plain version's
   products (which run with TF32 off).  Then ``ring_payload`` in its three
   modes (forward, inverse, roundtrip) against ``payload_plain``, f64 and
   f32, N=16, 512 and 8192 and every N of ``fft_radix2``'s edges, the
   same tolerances, and in its lane mode (the serving batch's payload: 3
   lanes of a slab narrowed out of a lane stack, read in place, the
   multiplier shared by the lanes, a lane-strided output; each lane also
   bitwise a launch on its own rows); ``ring_send`` and
   ``ring_land`` against plain indexing, bit for bit (the "peer" slot a
   second buffer of this process), at run (a)'s slab and over the layouts
   of ``tests/test_torch_copy_plan.py`` (splits and concats along every
   axis, p 2 and 4, f64 and f32, bases aligned and one element off: the
   element case there, fatal otherwise); ``flash_attention`` against
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
4. timing — first the f64 ``mma.sync`` shapes' TFLOP/s on this card
   (``fft_mxu.mma_rates``, the measurement behind ``fft_mxu``'s m16n8k16);
   then each kernel, its plain version and PyTorch's own call where
   one computes the same function (``torch.fft.fft``; a yardstick the port
   never calls) at the main path's shapes, ``fft_mxu`` also at N=256 f64
   (navier_stokes) and in f32 at N=512, and one rank's copies of one
   bidi exchange at run (b)'s shapes (PERF.md's row 4, against one
   ``torch._foreach_copy_`` of the same copies), CUDA events after a ~10 ms
   sleep of the card that lets the host enqueue the timed calls (device
   time; the copies also as the host issues them, their launch path
   slower than the kernel; the FFT and ring kernels' and library calls'
   times the median of 7 timings, the kernels' spread beside them), and
   the bound:
   the larger of the bytes moved over 3.35 TB/s (for the wire kernels
   2·bytes: on one card a copy reads and writes the same memory) and the
   flops over the peak of the units the kernel runs on (FP64 CUDA cores,
   34 TFLOP/s; FP64 tensor cores, 67 TFLOP/s, for ``fft_mxu``); for
   ``flash_attention`` also the served head dimensions 128 (qwen1.5-4b's
   heads) and 256 (gemma-2b's) at B=8, S=T=2048, bf16, causal, against
   SDPA, the f32 kernel at the f32 prefill shape against f32 SDPA
   (TF32 off), and the bf16 kernel at the training step's shape (B=8,
   S=T=512) against SDPA and its plain version;
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
   equal to the round model summed over the wires (the copies' launches
   by element width shown beside them);
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
   prefill and of a decode step (informational);
9. tuning — the perf model's calibration and the plan autotuner
   (``repro_torch.tuning``) on the solver step.  (a) Calibration: each FFT
   backend's 1D c2c transform in f64 at N=512 with 512·512 rows, its time
   over ``torch.fft``'s (this process, before phase 7's spawn), and each
   engine's X<->Y fold on 4x1 at N=128 and 256 in lockstep, the zero-payload
   intercept per message and the slope's wire rate (the first thing phase
   7's 4 ranks do); the document must validate, the ranks agree, and it is
   written to ``build/chip_smoke_calibration.json``.  (b) Under it,
   ``autotune_solver_step`` for heat N=512 f64 on 1x1 with 6 candidates
   and 3 timed steps each, into a cold cache under ``build/``, counts set
   to 0 just before and read just after: every kept candidate timed in the
   model's order, none dropped, the default among them, each timed
   backend's kernel launched and no plain version; a second call a cache
   hit that launches nothing; the winner's plan 3 steps that pass
   ``validate()`` within 1e-10 of phase 5's ``backend="ref"`` heat run,
   its backend's kernel launched and no plain version.  (c) The same on
   2x2 with 4 candidates, the last thing phase 7's ranks do: every rank
   the same rows and winner, and the winner's steps launch ``ring_send``
   and ``ring_land``.  (d) ``predict_step_us()`` under the model's H100
   priors and under (a)'s calibration against the measured ms/step: heat
   1x1 on ``"pallas"`` and ``"mxu"`` (phase 5), runs (a)–(c) of phase 7
   (rank 0, steps 2–3) and the winners of (b) and (c) (informational);
10. serving — ``repro_torch.serving`` on the card, each run's counts set
   to 0 just before it and read just after.  (a) 1x1, heat N=512 f64
   (``fft512_p1``'s problem) on ``"pallas"`` and on ``"mxu"``: a solo
   step's memory first (``max_batch`` 4, cut where 4 lanes would take more
   than 70 GiB), then a burst through ``run_load`` of 200 heat requests
   (scale 1 + 0.25·(i mod 8), 3 steps: 50 batches of 4) and 2 nls N=256
   requests (another fingerprint); (b) the heat requests paced at 16
   requests/s (above what one-lane batches serve) through the scheduler
   thread, on ``"pallas"``; (c) 4 rank processes on 2x2, heat N=512 on run
   (c)'s plan (``pallas_ring``, fused, chunks=3), 200 requests,
   ``max_batch`` 2, rank 0 scheduling.  Gates: no request rejected or
   failed; every lane's streamed history bitwise (exact float equality,
   ``t`` included) a solo run of a request of its case and scale on the
   same grid, and ``validate()`` passing; the backend's kernel launched (on
   2x2 ``ring_payload`` with the multiplier shared by the lanes,
   ``ring_send`` and ``ring_land``) and no plain version; one batched step
   launching each kernel as often as one solo step; every rank the same
   batches; in (b) a batch of more than one lane.  Printed beside the
   card's name and power limit: requests/s, latency p50/p95/p99, the
   batches by lane count, ms of a batched step against B × a solo step's, launches
   a step, the slab and payload copies a step, the peak GiB at B and at 1,
   a ``torch.profiler`` breakdown of one batched step at B=4 on 1x1 and of
   rank 0's on 2x2 (busy and idle share);
11. fleet — ``repro_torch.fleet``'s kill-and-resume proof on the card,
   through ``FleetController`` with this script as its worker
   (``chip_smoke.py --fleet-worker --spec S --attempt A``: the port's
   ``fleet.worker.main`` under ``torch.profiler``, which writes the kernel
   wrappers' counts, the kernels the profiler saw and the time of the
   attempt's first progress line beside the attempt's spec).  (a)
   ``fft512_p1``'s problem, heat N=512 f64 on 1x1 ``"pallas"``, 2 jobs of 4
   steps at scales 1.0 and 1.25, a snapshot every 2 steps, run clean and
   then with ``kill-at-step:3``: every job completes; each chaos job in 2
   attempts with one crash of exit code 13; ``fleet.jobs.retried`` 2,
   ``quarantined`` 0; the histories bitwise the clean ones (``t``
   included), the clean ones bitwise a solo in-process run of the same job;
   ``restore_latency_us`` > 0; every finished worker launched
   ``fft_radix2`` as often a step as the solo step and no plain version.
   (b) one job at nls N=512 f64 on 2x1 ``pallas_ring``, fused (nls: all
   its transforms are c2c, so the payload rides both grids; heat's would
   ride neither), run clean and then killed at step 3 and retried on 1x2
   (``reshape_on_retry``): it completes on 1x2, every step within 1e-10 of
   a solo in-process 1x1 run by ``observables_rel_err`` (the steps before
   the kill bitwise the clean 2x1 run's), and ``validate()`` passes; the
   worker's ranks run its rank function under ``torch.profiler`` and
   write their counts too: every rank of the clean 2x1 attempt and of the
   1x2 retry launched ``ring_payload``, ``ring_send``, ``ring_land`` and
   ``fft_radix2``, no plain version.  Printed beside the card's name and
   power limit: each campaign's wall time, the time to recover (chaos
   wall time less clean), ``restore_latency_us`` per job,
   ``fleet.checkpoint.bytes``, each worker's startup (spawn to its first
   progress line) and the phase's seconds.  ``chip_smoke.py --fleet-only``
   runs phases 1 and 11 alone (in a fresh ``build/``, the two workers of
   (a) build the kernel library at once);
12. training — ``smollm-360m`` at full width and depth through
   ``repro_torch.launch.train`` (bf16 compute, f32 params and moments,
   two-level remat, B=8, S=512, random weights from seed 0).  (a) Step
   0's loss and gradients through the kernel path against the plain
   attention's (``RunCfg(plain_attention=True)``), in bf16 and in f32: the
   kernel launched once a block forward (``models.transformer.
   block_forwards``: 92 a step, 32 layers in groups of 8) and no plain
   call; every ``wq``/``wk``/``wv`` gradient nonzero; per gradient leaf
   ``||d|| <= tol·||g_plain||`` (bf16 5e-2, f32 1e-5); the losses within
   3e-2 relative; and the same gate must refuse a control whose kernel
   output is detached from q, k and v (the fault this slice repaired).
   (b) 12 steps through ``launch/train.py``'s ``main``, counts set to 0
   just before and read just after: every loss finite, ``flash_attention``
   launched 12 × 92 times, no plain call, no pad copy.  (c) The run halted
   after step 6 (checkpoints of ≈4.34 GB at steps 0 and 6, under
   ``build/``), the latest restored onto the card on the clock, then
   resumed in a fresh process (``python -m repro_torch.launch.train``):
   the losses of steps 8-11 within 1e-4 of (b)'s (the lines print 4
   decimals; whether they equal (b)'s as printed, and the halted run's
   bitwise, is shown); its step-6 checkpoint kept for phase 13.
   (d) ms/step (host clock around each synchronised step, the first
   apart), tokens/s, peak GiB, the checkpoint's bytes, snapshot, write and
   restore seconds, one step under ``torch.profiler``, and the attention's
   forward and backward at the training shape (kernel + ``attention_grad``
   against SDPA).  ``chip_smoke.py --train-only`` runs phases 1 and 12
   alone;
13. the sharded LM — one spawn of 4 rank processes on the one card
   (``repro_torch.launch.mesh``; every collective on the peer-mapped wire,
   ``ring_send``/``ring_land``: no NCCL, no gloo for a CUDA tensor), the
   counts set to 0 just before each part and read just after.  (a)
   Phase 12's model, seed and data on 2x2 (FSDP over ``data``, the mlp and
   vocab over ``model``, the 15 heads replicated): 6 steps, each loss
   within 3e-2 of phase 12 (d)'s 1x1 step (the gaps and gnorms' printed),
   ms/step on rank 0, one step under ``torch.profiler`` on rank 0 (its
   idle share), every rank's peak below phase 12's, per step and rank 92
   ``flash_attention`` launches and no plain call, the wire copies and
   bytes.  (b) ``launch/train.py`` on 2x2 saves at steps 0 and 3 and
   halts (its checkpoint resumed on 1x1 here for steps 4-5), and phase
   12's step-6 checkpoint resumed on 2x2 for steps 7-8; each loss within
   3e-2 of phase 12 (b)'s.  (c) Re-cut to (pod 2, data 1, model 2): 3
   steps with the int8 pod sync, the losses against (a)'s and the largest
   residual.  (d) Re-cut to 2x2: phase 8's serving (B=8, prompt 2048, 32
   tokens), teacher-forced with phase 8's tokens, every step's logits
   within 3e-2·max|logit| of phase 8's, one launch a layer a rank; prefill
   ms and decode ms/step on rank 0.  ``chip_smoke.py --lm-only`` runs
   phases 1, 8, 12 and 13.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``.  Full results go to
``build/chip_smoke.json``.  Exits non-zero, with no result line, when
CUDA is unavailable or the port's sources are not beside this script.
"""

from __future__ import annotations

import collections
import json
import os
import shutil
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
MULTI_RANK_CFG = {tag: cfg for tag, _, _, cfg in MULTI_RANK}
WIRE_MESHES = ((4, 1), (2, 2), (1, 4))
# run (c) saves a checkpoint at step 2, restored onto each of these grids
# for 2 more steps: bitwise on its own 2x2, within 1e-10 elsewhere
CKPT_RUN, CKPT_STEP = "c", 2
RESTORE_GRIDS = ((2, 2), (4, 1), (1, 4))
CKPT_DIR = os.path.join(HERE, "build", "chip_smoke_ckpt")
# the 3-axis mesh: 8 rank processes, ("pod", "data", "model") of 2x2x2 with
# u over ("pod", "data"); the 3D FFT at N=512 f64 on "pallas" through
# make_fft3d, forward, inverse and a roundtrip with a heat diagonal
# exp(-STAGED_DECAY·k²): (engine, fused roundtrip)
STAGED_SIZES, STAGED_PV, STAGED_N = (2, 2), 2, 512
STAGED_RUNS = (("pallas_ring", True), ("bidi_ring", False))
STAGED_DECAY = 1e-5
STAGED_SEED = 512
STAGED_TRANSFORMS = ("fwd", "inv", "roundtrip")
# ring kernels at the shapes of run (a): one round's chunk of a 128-row
# slab (16384 rows of N=512 in 3 chunks) for the payload, one block of a
# (128, 128, 512) Y-pencil slab cut in 4 along its last axis for the wire
PAYLOAD_N = (16, 512, 8192)
PAYLOAD_ROWS = {16: 4096, 512: 5462, 8192: 64}
SLAB = (128, 128, 512)

# ring_payload's lanes (the serving batch's payload): PAYLOAD_LANES lanes of
# a slab narrowed out of a lane stack (LANE_STACK, rows [2, 6) of axis 1),
# the multiplier shared by the lanes, at N=16 and the main path's 512
PAYLOAD_LANES, LANE_STACK = 3, (8, 43)

# phase 10, serving (repro_torch.serving): (a) 1x1, fft512_p1's problem
# (heat N=512 f64, real) on "pallas" and on "mxu": SERVE_REQUESTS requests of
# scale 1 + 0.25·(i mod SERVE_SCALES) and SERVE_STEPS steps, max_batch
# SERVE_BATCH, burst, with SERVE_NLS nls requests (another fingerprint)
# riding along; (b) the same heat requests paced at SERVE_RATE requests/s
# through the scheduler thread, above the rate at which one-lane batches are
# served (~12.5/s), so that batches of several lanes form; (c) 4 ranks on
# 2x2, heat N=512 on run (c)'s plan, SERVE_GRID_REQUESTS requests, max_batch
# SERVE_GRID_BATCH.  Every lane bitwise a solo run of a request of its case
# and scale (the same run as its own: the scale is the one input that varies);
# B is cut where SERVE_BATCH lanes' step would take more than SERVE_MEM_GIB
SERVE_N, SERVE_REQUESTS, SERVE_STEPS, SERVE_BATCH = 512, 200, 3, 4
SERVE_SCALES = 8
SERVE_NLS = (256, 2)    # (N, requests)
SERVE_RATE = 16.0
SERVE_GRID_REQUESTS, SERVE_GRID_BATCH = 200, 2
SERVE_MEM_GIB = 70.0
SERVE_BACKENDS = ("pallas", "mxu")

# flash attention: (B, S, T, H, Hkv, D, causal) held against the plain
# version, the LM prefill's shapes first (smollm-360m: 15 heads, 5 kv
# heads, head_dim 64; bf16 at prompt 2048, f32 at prompt 512), then the
# edges of tests/test_torch_gpu.py (D 20..256, groups 1, 3, 8, S 1..2048)
FLASH_MAIN = (8, 2048, 2048, 15, 5, 64, True)
# phase 4 also times the training step's shape (phase 12: B=8, S=512)
FLASH_TRAIN = (8, 512, 512, 15, 5, 64, True)
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

# phase 9, tuning: the calibration at the main path's shapes (the backends
# at repro_torch.tuning.calibrate.CARD_BACKEND_SHAPE, the folds on 4x1 at
# CARD_FOLD_SIZES), then heat N=512 f64's whole step tuned on 1x1 and on
# 2x2 (TUNE_GRIDS: mesh -> max_candidates), the winners run TUNE_STEPS steps
TUNE_CASE, TUNE_N, TUNE_ITERS, TUNE_STEPS = "heat", 512, 3, 3
TUNE_GRIDS = {(1, 1): 6, (2, 2): 4}
CALIBRATION_ITERS = 5
TUNE_CACHE = os.path.join(HERE, "build", "chip_smoke_plans.json")
CALIBRATION_OUT = os.path.join(HERE, "build", "chip_smoke_calibration.json")


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
        # the radix-2 row engine's and fft_mxu's entries: one line each,
        # below; the mma probe's are not part of a path
        own = False
        for line in _build.build_log(name).splitlines():
            if "Compiling entry" in line:
                own = name == "fft_mxu" or "fft_radix2_kernel" in line \
                    or "ring_payload_kernel" in line
            if not own and ("registers" in line or "spill" in line
                            or "smem" in line or "Compiling entry" in line):
                say(f"  ptxas {name}: {line.strip()[:150]}")
    radix2 = radix2_ptxas({name: _build.build_log(name) for name in RADIX2_SOURCES})
    mxu = mxu_ptxas(_build.build_log("fft_mxu"))
    copies = copy_ptxas(_build.build_log("ring_rdma"))
    return flash_sass(libs["flash_attention"], _build.build_log("flash_attention"),
                      _build.nvcc()), radix2 + mxu + copies


def _radix2_log2ns(dtype: str) -> list:
    """Every log2 N the radix-2 wrappers admit in ``dtype`` (shared memory
    bounds the top): the instantiations the row engine must have."""
    import torch

    from repro_torch.kernels import fft_radix2

    return list(range(1, fft_radix2.max_n(getattr(torch, dtype)).bit_length()))


def radix2_ptxas(logs: dict) -> list:
    """Phase 2, the radix-2 row engine: per instantiation of
    ``fft_radix2_kernel<T, L>`` and ``ring_payload_kernel<T, L, diag, Map>``
    (``Map`` the row map: ``Packed`` for one lane, ``Lanes``), ptxas's
    registers, spill bytes and static shared memory a block (the rows and
    twiddles are dynamic shared memory); fatal on any spill or on a log N
    the wrapper admits without an instantiation."""
    out = []
    for source, log in logs.items():
        for k in _ptxas_entries(log, r"(fft_radix2_kernel|ring_payload_kernel)I([df])"
                                     r"Li(\d+)E(?:Lb([01])E\S*?(Packed|Lanes))?"):
            kernel, t, log2n, diag, row_map = k["groups"]
            out.append({"source": source, "kernel": kernel,
                        "dtype": {"d": "float64", "f": "float32"}[t],
                        "log2n": int(log2n), "diag": diag == "1", "map": row_map,
                        "registers": k["registers"], "spill_bytes": k["spill_bytes"],
                        "smem": k["smem"]})
    for (kernel, diag, row_map), label in (
            (("fft_radix2_kernel", False, None), "fft_radix2_kernel"),
            (("ring_payload_kernel", False, "Packed"),
             "ring_payload_kernel (forward, inverse; one lane)"),
            (("ring_payload_kernel", False, "Lanes"),
             "ring_payload_kernel (forward, inverse; lanes)"),
            (("ring_payload_kernel", True, "Packed"),
             "ring_payload_kernel (roundtrip; one lane)"),
            (("ring_payload_kernel", True, "Lanes"),
             "ring_payload_kernel (roundtrip; lanes)")):
        for dtype in ("float64", "float32"):
            ks = sorted((k for k in out if (k["kernel"], k["diag"], k["map"], k["dtype"])
                         == (kernel, diag, row_map, dtype)), key=lambda k: k["log2n"])
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


def _ptxas_entries(log: str, pattern: str) -> list:
    """ptxas's registers, spill bytes and static shared memory of each entry
    whose mangled name matches ``pattern`` (its groups kept as ``groups``)."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(pattern, m.group(1))
            cur = ({"entry": m.group(1), "groups": list(k.groups()), "registers": None,
                    "spill_bytes": None, "smem": 0} if k else None)
            if cur:
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
    return out


def mxu_ptxas(log: str) -> list:
    """Phase 2, ``fft_mxu``: registers and spill bytes of each
    instantiation -- ``fft_mxu_tc_kernel<L>`` for every log2 N of the f64
    tensor-core path (6..13) and the CUDA-core ``fft_mxu_fma_kernel`` in f32
    and f64; fatal on a spill or a missing log2 N."""
    tc = _ptxas_entries(log, r"fft_mxu_tc_kernelILi(\d+)EE")
    fma = _ptxas_entries(log, r"fft_mxu_fma_kernelI([df])E")
    tc.sort(key=lambda k: int(k["groups"][0]))
    say("  ptxas fft_mxu_tc_kernel float64, log2 N: registers / spill bytes: "
        + ", ".join(f"{k['groups'][0]}: {k['registers']}/{k['spill_bytes']}" for k in tc))
    say("  ptxas fft_mxu_fma_kernel: " + ", ".join(
        f"{ {'d': 'float64', 'f': 'float32'}[k['groups'][0]]}: {k['registers']} "
        f"registers / {k['spill_bytes']} spill bytes" for k in fma))
    if [int(k["groups"][0]) for k in tc] != list(MXU_TC_LOG2N) or len(fma) != 2:
        fail(f"fft_mxu instantiations: tensor-core log2 N "
             f"{[k['groups'][0] for k in tc]}, want {list(MXU_TC_LOG2N)}; "
             f"{len(fma)} CUDA-core (want 2)")
    spilled = [k for k in tc + fma if k["spill_bytes"] != 0]
    if spilled:
        fail(f"fft_mxu spills: {spilled}")
    return [{"source": "fft_mxu", "kernel": "fft_mxu_tc_kernel", "dtype": "float64",
             "log2n": int(k["groups"][0]), "registers": k["registers"],
             "spill_bytes": k["spill_bytes"]} for k in tc] + \
        [{"source": "fft_mxu", "kernel": "fft_mxu_fma_kernel",
          "dtype": {"d": "float64", "f": "float32"}[k["groups"][0]],
          "registers": k["registers"], "spill_bytes": k["spill_bytes"]} for k in fma]


def copy_ptxas(log: str) -> list:
    """Phase 2, the wire copies: ``ring_send_kernel``/``ring_land_kernel``
    for each element width (16-byte vectors, 8 and 4 bytes); fatal on a
    spill or a missing width."""
    ks = _ptxas_entries(log, r"(ring_send_kernel|ring_land_kernel)I(5uint4|y|j)E")
    width = {"5uint4": 16, "y": 8, "j": 4}
    say("  ptxas wire copies, registers / spill bytes: " + ", ".join(
        f"{k['groups'][0]}<{width[k['groups'][1]]} B>: {k['registers']}/"
        f"{k['spill_bytes']}" for k in ks))
    if len(ks) != 6 or any(k["spill_bytes"] != 0 for k in ks):
        fail(f"wire copy instantiations: {ks}")
    return [{"source": "ring_rdma", "kernel": k["groups"][0],
             "width": width[k["groups"][1]], "registers": k["registers"],
             "spill_bytes": k["spill_bytes"]} for k in ks]


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
    phase 3's f32 prefill shape, and bf16 at the training step's shape
    (B=8, S=T=512).  Each against ``scaled_dot_product_attention`` on (B,
    H, S, D) views with ``enable_gqa`` (a yardstick the port never calls;
    f32 with TF32 off, as ``main`` sets), CUDA events; the plain version at
    the prefill and training shapes only.  The bound is the larger of q, k, v
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
    shapes.append(("smollm-360m training", FLASH_TRAIN, torch.bfloat16, BF16_TC_FLOPS))
    out = []
    for label, shape, dtype, peak in shapes:
        b, s, t, h, hkv, d, causal = shape
        q = _rand((b, s, h, d), torch.float32, gen).to(dtype)
        k = _rand((b, t, hkv, d), torch.float32, gen).to(dtype)
        v = _rand((b, t, hkv, d), torch.float32, gen).to(dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        ms = _time_ms(lambda: attention.flash_attention(q, k, v, causal=causal), 20, 3)
        plain_ms = (_time_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=causal), 3, 1) if shape in (FLASH_MAIN, FLASH_TRAIN)
            else None)
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

    kept = {"tokens": r["tokens"].cpu(), "logits": [x.cpu() for x in r["logits"]]}
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
    return out, kept


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
# then every N of each kernel's instantiations (radix2_shapes, mxu_shapes)
CHECK_SHAPES = {
    "fft_radix2": ((512 * 512, 512), (257 * 512, 512)),
    "fft_mxu": ((512 * 512, 512), (257 * 512, 512), (512 * 256, 256)),
}
#: log2 N of fft_mxu's f64 tensor-core path (below: the CUDA-core path)
MXU_TC_LOG2N = range(6, 14)
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


def mxu_shapes():
    """(rows, N) for every log2 N of ``fft_mxu`` (1..13, both dtypes): about
    ``RADIX2_ELEMENTS`` values in an odd number of rows (a ragged last set,
    and at N = 64 and 128 a row without its pair), and one row."""
    return [(rows, 1 << l) for l in range(1, 14)
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
            shapes += radix2_shapes(dname) if name == "fft_radix2" else mxu_shapes()
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


#: cycles the card sleeps before a timing's start event, ~10 ms at the
#: H100's clock: the host enqueues the timed calls meanwhile, so the events
#: see device time, not a launch path slower than a short kernel
FILL_CYCLES = 20_000_000


def _time_ms(fn, iters: int, warmup: int, fill: bool = True) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if fill:
        torch.cuda._sleep(FILL_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _median_ms(fn, iters: int, warmup: int, reps: int = 7, fill: bool = True) -> tuple:
    """(median, min, max) of ``reps`` timings of ``_time_ms(fn, iters)``."""
    import statistics
    times = [_time_ms(fn, iters, warmup if i == 0 else 0, fill) for i in range(reps)]
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


def mma_probe():
    """Phase 4, first: the f64 ``mma.sync`` shapes' throughput on this card
    (``fft_mxu.mma_rates``: 16 warps an SM, independent products on
    register operands), the measurement ``fft_mxu`` chose its shape by."""
    from repro_torch.kernels import fft_mxu

    rows = fft_mxu.mma_rates()
    for r in rows:
        say(f"mma f64 {r['shape']}, {r['chains']} independent products a warp: "
            f"{r['tflops']:.2f} TFLOP/s ({r['ms']:.4f} ms)")
    best = max(rows, key=lambda r: r["tflops"])
    say(f"mma f64: fastest shape {best['shape']} at {best['tflops']:.2f} TFLOP/s "
        f"(fft_mxu runs m16n8k16; data sheet peak {FP64_TC_FLOPS / 1e12:.0f})")
    return rows


def timing(gen):
    """Phase 4: each kernel at the main path's N=512 f64 shapes — 512·512
    rows (the kernels line), 256·512 rows (one X-phase slab of the heat
    and poisson steps) and 257·512 rows (the Y and Z phases); then
    ``fft_mxu`` at N=256 f64 (navier_stokes' transforms; 512·256 rows) and
    in f32 at N=512 (512·512 rows, the CUDA-core path)."""
    import torch

    item, out = 8, []
    runs = [(rows, 512, torch.float64, KERNELS)
            for rows in (512 * 512, 256 * 512, 257 * 512)]
    runs += [(512 * 256, 256, torch.float64, ("fft_mxu",)),
             (512 * 512, 512, torch.float32, ("fft_mxu",))]
    for rows, n, dtype, names in runs:
        item = torch.finfo(dtype).bits // 8
        dname = str(dtype).removeprefix("torch.")
        xr = _rand((rows, n), dtype, gen)
        xi = _rand((rows, n), dtype, gen)
        z = torch.complex(xr, xi)
        library_ms = _median_ms(lambda: torch.fft.fft(z), iters=20, warmup=3)[0]
        for name in names:
            kernel, plain = _pair(name)
            ms, lo, hi = _median_ms(lambda: kernel(xr, xi), iters=20, warmup=3)
            plain_ms = _time_ms(lambda: plain(xr, xi), iters=3, warmup=1)
            moved, flops, peak = _work(name, rows, n, item)
            bytes_ms = moved / HBM_BYTES_PER_S * 1e3
            ops_ms = flops / peak * 1e3
            t = {"kernel": name, "rows": rows, "n": n, "dtype": dname,
                 "ms": ms, "ms_spread": [lo, hi], "plain_ms": plain_ms,
                 "library_ms": library_ms,
                 "bytes": moved, "flops": flops,
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            say(f"timing {name} rows={rows} N={n} {dname}: kernel {ms:.4f} ms "
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
            r["ref_history"] = plain["history"]
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


def _kernel_rows(prof) -> list:
    """``(device ms, launches, name)`` of every kernel a profile saw."""
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    return rows


def _profile(step, label: str, top: int = 8) -> dict:
    """Device time by kernel name over one call of ``step()`` from
    ``torch.profiler`` (this process's kernels), and the host-clock wall
    time around it; busy over wall gives the idle share.  Prints the
    ``top`` kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = _kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    lines = [f"breakdown {label}: the profiler saw no device time (not measured)"]
    if rows:
        lines = [f"breakdown {label}: wall {wall_ms:.3f} ms, device busy "
                 f"{busy_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.1%}, "
                 f"{sum(r[1] for r in rows)} kernels"]
        lines += [f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{c:<4d} {k[:90]}"
                  for ms, c, k in rows[:top]]
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
    payload_lanes_vs_plain(gen)
    copy_layouts(gen)
    return {"ring_payload": err512, "ring_send": 0.0, "ring_land": 0.0}


def payload_lanes_vs_plain(gen):
    """Phase 3, ``ring_payload``'s lanes: ``PAYLOAD_LANES`` lanes of a slab
    narrowed out of a lane stack (read in place), a multiplier shared by
    the lanes, into a lane-strided output, in each mode, f64 and f32, N=16
    and 512: against ``payload_plain`` (tolerance ``TOL``), each lane
    bitwise a launch on that lane's rows alone, nothing written outside the
    output's lanes, and the roundtrip launch counted as a shared one."""
    import torch

    from repro_torch.kernels import fft_radix2, ring_rdma

    rows, cols = LANE_STACK
    for dtype in (torch.float64, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for n in (16, 512):
            for mode in ("forward", "inverse", "roundtrip"):
                inv = mode == "inverse"
                stack = [_rand((PAYLOAD_LANES, rows, cols, n), dtype, gen)
                         for _ in range(2)]
                xr, xi = (t[:, 2:6] for t in stack)
                diag = (tuple(_rand((4, cols, n), dtype, gen) for _ in range(2))
                        if mode == "roundtrip" else None)
                outs = [torch.full((PAYLOAD_LANES, 6, cols, n), 7.0, dtype=dtype,
                                   device="cuda") for _ in range(2)]
                shared = ring_rdma.shared_diag_launches
                got = ring_rdma.ring_payload(xr, xi, diag=diag, inverse=inv,
                                             out=tuple(o[:, 1:5] for o in outs))
                shared = ring_rdma.shared_diag_launches - shared
                twr, twi = fft_radix2.twiddles(n, dtype, xr.device)
                want = ring_rdma.payload_plain(xr, xi, twr, twi, diag, inv)
                solo = [ring_rdma.ring_payload(xr[b].contiguous(), xi[b].contiguous(),
                                               diag=diag, inverse=inv)
                        for b in range(PAYLOAD_LANES)]
                torch.cuda.synchronize()
                err, rel = _rel_err(got, want)
                lanes_ok = all(torch.equal(sr, got[0][b]) and torch.equal(si, got[1][b])
                               for b, (sr, si) in enumerate(solo))
                untouched = all(bool((o[:, 0] == 7).all() and (o[:, 5] == 7).all())
                                for o in outs)
                if rel > TOL[dname] or not lanes_ok or not untouched or (
                        shared != (mode == "roundtrip")):
                    fail(f"ring_payload lanes {mode} N={n} {dname}: max|d| {err:.3e} "
                         f"= {rel:.3e} max|y| (tol {TOL[dname]:g}), each lane a solo "
                         f"launch's bits {lanes_ok}, outside untouched {untouched}, "
                         f"shared-multiplier launches {shared}")
        say(f"kernel vs plain: ring_payload lanes {dname}: {PAYLOAD_LANES} lanes of "
            f"(4, {cols}) rows narrowed out of {(PAYLOAD_LANES, rows, cols)}, N 16 "
            f"and 512, forward / inverse / roundtrip with the multiplier shared: "
            f"within {TOL[dname]:g} of payload_plain, each lane bitwise a solo "
            f"launch, nothing written outside the output's lanes: ok")


# the layouts of tests/test_torch_copy_plan.py: (shape, p), each cut along
# every axis it divides, landed along every axis; bases 16-byte aligned and
# one element off
COPY_SHAPES = (((8, 12, 16), 2), ((8, 12, 16), 4), ((3, 8, 20), 2), ((3, 8, 20), 4),
               ((4, 6, 64), 2), ((4, 6, 64), 4))


def copy_layouts(gen):
    """Phase 3, the wire copies over every layout of the CPU test: a send
    along each split axis into slots, a landing of the slots and of the own
    block (strided) along each concat axis, p = 2 and 4, f64 and f32, bases
    aligned and one element off; bit for bit against plain indexing, and
    the plan's widths counted: 16-byte vectors wherever every run and
    stride allows, the element case at a misaligned base."""
    import torch

    from repro_torch.core import transpose as tr
    from repro_torch.kernels import ring_rdma

    cases = 0
    widths = dict.fromkeys(ring_rdma.COPY_WIDTHS, 0)
    for shape, p in COPY_SHAPES:
        n = shape[0] * shape[1] * shape[2]
        for dtype in (torch.float64, torch.float32):
            for off in (0, 1):
                xs = [_rand((n + 1,), dtype, gen)[off:n + off].view(shape)
                      for _ in range(2)]
                for axis in range(3):
                    if shape[axis] % p:
                        continue
                    before = dict(ring_rdma.copy_widths)
                    slots = [torch.empty(tr.block(xs[0], 0, p, axis).shape,
                                         dtype=dtype, device="cuda") for _ in range(2)]
                    ring_rdma.ring_send(xs, p - 1, p, axis, slots)
                    ok = all(torch.equal(s_, tr.block(x, p - 1, p, axis))
                             for s_, x in zip(slots, xs))
                    send_width = [w for w in widths
                                  if ring_rdma.copy_widths[w] > before[w]]
                    for concat in range(3):
                        outs = [torch.zeros(tr.merged_shape(shape, p, axis, concat),
                                            dtype=dtype, device="cuda")
                                for _ in range(2)]
                        ring_rdma.ring_land(slots, outs, 1, p, concat)
                        ring_rdma.ring_land([tr.block(x, 0, p, axis) for x in xs],
                                            outs, 0, p, concat)
                        ok = ok and all(
                            torch.equal(tr.block(o, 1, p, concat), s_)
                            and torch.equal(tr.block(o, 0, p, concat),
                                            tr.block(x, 0, p, axis))
                            for o, s_, x in zip(outs, slots, xs))
                        cases += 2
                    cases += 1
                    if off and send_width != [8 if dtype == torch.float64 else 4]:
                        fail(f"ring_send of a misaligned {shape} {dtype} block took "
                             f"widths {send_width} (want the element case)")
                    if not ok:
                        fail(f"ring_send/ring_land disagree with plain indexing: "
                             f"{shape} p={p} split={axis} {dtype} offset {off}")
                    for w in widths:
                        widths[w] += ring_rdma.copy_widths[w] - before[w]
    torch.cuda.synchronize()
    say(f"kernel vs plain: ring_send/ring_land over {cases} layouts (splits and "
        f"concats along axes 0-2, p 2 and 4, f64 and f32, aligned and misaligned "
        f"bases): bit for bit; launches by width (bytes) {widths}")


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
                    # the same calls timed as the host issues them (what
                    # PRs 13-16 recorded): the launch path, not the card
                    "host_bound_ms": _median_ms(kernel, 50, 5, fill=False)[0],
                    "plain_ms": _median_ms(plain, 50, 5)[0], "bytes": 2 * moved,
                    "flops": 0, "library_ms": _median_ms(library, 50, 5)[0],
                    "library_sum_ms": None})
    del xs, slots, outs, blocks, places
    torch.cuda.empty_cache()
    out.append(bidi_exchange_timing(gen))
    for t in out:
        bytes_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = t["flops"] / FP64_FLOPS * 1e3
        t["bound_ms"] = max(bytes_ms, ops_ms)
        t["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        lib = (f"torch {t['library_ms']:.4f} ms" if t["library_ms"] is not None
               else (f"fft+mul+ifft (a sum of 3 calls) {t['library_sum_ms']:.4f} ms"
                     if t["library_sum_ms"] is not None else "no one torch call"))
        lo, hi = t["ms_spread"]
        host = (f", {t['host_bound_ms']:.4f} ms as the host issues them"
                if "host_bound_ms" in t else "")
        say(f"timing {t['kernel']} {t['mode']} f64: kernel {t['ms']:.4f} ms (median "
            f"of 7; {lo:.4f}..{hi:.4f}{host}), "
            f"plain {t['plain_ms']:.4f} ms, {lib}, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} B), {t['bound_ms'] / t['ms']:.1%} "
            "of the bound")
    del xr, xi, dr, di, z, d
    torch.cuda.empty_cache()
    return out


# run (b)'s exchange on one rank: nls 4x1 bidi_ring at N=512 cuts each of
# its two (128, 256, 512) f64 arrays in 4 along the last axis and merges
# along the first
BIDI_SHAPE, BIDI_P, BIDI_SPLIT, BIDI_CONCAT = (128, 256, 512), 4, 2, 0


def bidi_exchange_timing(gen):
    """Phase 4, row 4 of PERF.md's kernel table (``_rdma_bidi_kernel``,
    ported as the wire's kernels over ``bidi_schedule``): one rank's copies
    of one exchange of run (b), in one process -- its own block landed,
    P-1 blocks sent into slots and P-1 slots landed, both arrays -- against
    plain ``copy_`` and one ``torch._foreach_copy_`` of the same 2·(2P-1)
    copies.  Bound: 2·bytes over 3.35 TB/s (on one card a copy reads and
    writes the same memory); the payload's transform is row 3's."""
    import torch

    from repro_torch.core import transpose as tr
    from repro_torch.kernels import ring_rdma

    p, ax, cat = BIDI_P, BIDI_SPLIT, BIDI_CONCAT
    xs = [_rand(BIDI_SHAPE, torch.float64, gen) for _ in range(2)]
    blk = tr.block(xs[0], 0, p, ax).shape
    slots = {d: [torch.empty(blk, dtype=torch.float64, device="cuda") for _ in xs]
             for d in range(1, p)}
    outs = [torch.empty(tr.merged_shape(BIDI_SHAPE, p, ax, cat), dtype=torch.float64,
                        device="cuda") for _ in xs]

    def kernels():
        ring_rdma.ring_land([tr.block(x, 0, p, ax) for x in xs], outs, 0, p, cat)
        for d in range(1, p):
            ring_rdma.ring_send(xs, d, p, ax, slots[d])
        for d in range(1, p):
            ring_rdma.ring_land(slots[d], outs, d, p, cat)

    pairs = [(tr.block(o, 0, p, cat), tr.block(x, 0, p, ax)) for o, x in zip(outs, xs)]
    pairs += [(s_, tr.block(x, d, p, ax)) for d in range(1, p) for s_, x in zip(slots[d], xs)]
    pairs += [(tr.block(o, d, p, cat), s_) for d in range(1, p) for o, s_ in zip(outs, slots[d])]

    def plain():
        for a, b in pairs:
            a.copy_(b)
    dsts, srcs = [a for a, _ in pairs], [b for _, b in pairs]
    kernels()
    torch.cuda.synchronize()
    want = [o.clone() for o in outs]
    plain()
    if not all(torch.equal(o, w) for o, w in zip(outs, want)):
        fail("the bidi exchange's copies disagree with plain indexing")
    ms, lo, hi = _median_ms(kernels, 20, 3)
    moved = len(pairs) * dsts[0].numel() * 8  # every copy's bytes, once
    t = {"kernel": "bidi_exchange", "mode": f"{p - 1} sends + {p} landings, 2 arrays",
         "shape": list(BIDI_SHAPE), "ms": ms, "ms_spread": [lo, hi],
         "plain_ms": _median_ms(plain, 20, 3)[0], "bytes": 2 * moved, "flops": 0,
         "library_ms": _median_ms(lambda: torch._foreach_copy_(dsts, srcs), 20, 3)[0],
         "library_sum_ms": None}
    del xs, slots, outs, pairs, dsts, srcs, want
    torch.cuda.empty_cache()
    return t


def _ring_counts():
    from repro_torch.kernels import fft_radix2, ref, ring_rdma
    return {"ring_payload": ring_rdma.payload_launches,
            "ring_send": ring_rdma.send_launches,
            "ring_land": ring_rdma.land_launches,
            "fft_radix2": fft_radix2.launches, "ref.calls": ref.calls,
            "payload_plain": ring_rdma.plain_calls,
            **{f"copy_{w}B": n for w, n in ring_rdma.copy_widths.items()}}


def _zero_ring_counts():
    from repro_torch.kernels import fft_radix2, ref, ring_rdma
    ring_rdma.payload_launches = ring_rdma.send_launches = 0
    ring_rdma.land_launches = ring_rdma.plain_calls = 0
    fft_radix2.launches = ref.calls = 0
    ring_rdma.copy_widths.update(dict.fromkeys(ring_rdma.copy_widths, 0))


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


def _wire_rounds(c, dev, before, model):
    """Each wire's exchanges and rounds on ``dev`` since ``before`` (keyed
    ``dim/label``: a grid dimension's own wire, or one of its mesh axes),
    with the rounds the model gives them."""
    out = {}
    for (dim, label, kind), w in c.wires().items():
        if kind == dev.type:
            ex0, ro0 = before.get((dim, label, kind), (0, 0))
            out[f"{dim}/{label}"] = {"p": w.p, "exchanges": w.exchanges - ex0,
                                     "rounds": w.rounds - ro0,
                                     "model_rounds": (w.exchanges - ex0) * model(w.p)}
    return out


def _save_checkpoint(solver, state, step):
    """Run (c)'s checkpoint at ``step``: the fields gathered to rank 0
    (collective), written by rank 0 under ``CKPT_DIR``, every rank waiting
    for it to land.  Rank 0 returns the snapshot and write seconds and the
    bytes."""
    import torch.distributed as tdist

    from repro_torch.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    tree = solver.state_tree(state)
    out = {"gather_s": time.perf_counter() - t0}
    if tree is not None:
        mgr = CheckpointManager(CKPT_DIR, keep=1)
        grid = solver.plan.grid
        mgr.save(step, tree, meta={"mesh": [grid.pu, grid.pv]}, block=True)
        out.update(snapshot_s=mgr.last_snapshot_s, write_s=mgr.last_write_s,
                   bytes=mgr.last_save_bytes)
    tdist.barrier()
    return out


def _multi_rank_run(ctx, tag, case, mesh, cfg, ref_hist, n, doc, save_at=None):
    """Phase 7, in each rank: one multi-rank run of the main path at N=n,
    its counts set to 0 just before its steps and read just after, and its
    ``predict_step_us()`` under the priors and the calibration ``doc``;
    with ``save_at``, a checkpoint at that step (outside the step times)
    and the observables of one step more (``history_full``)."""
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
    for i in range(MULTI_STEPS):
        t0 = time.perf_counter()
        state = solver.step(state)
        if cuda:
            torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(solver.observables(state))
        if save_at == i + 1:
            r["checkpoint"] = _save_checkpoint(solver, state, i + 1)
    r["counts"] = _ring_counts()
    model = tr.bidi_rounds if cfg["comm_engine"] == "bidi_ring" else tr.ring_rounds
    r["wires"] = _wire_rounds(c, dev, before, model)
    r["exchange_rounds"] = solver.plan.engine().exchange_rounds
    r["step_ms"] = step_ms
    r["predict_us"] = _predictions(solver, doc)
    r["obs_rel_err"] = max(observables_rel_err(a, b)
                           for a, b in zip(history, ref_hist))
    r["history"] = history
    r["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else 0
    fields = [gather_pencil(f, grid) for f in state.fields]
    more = []  # one more step, every rank; rank 0 traces its own kernels

    def step():
        more.append(solver.step(state))
    if cuda and ctx.rank == 0:
        r["breakdown"] = _profile(step, f"({tag}) {case} {mesh[0]}x{mesh[1]} "
                                        "step, rank 0's kernels")
    else:
        step()
    if save_at is not None:
        r["history_full"] = history + [solver.observables(more[0])]
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
    del solver, state, fields, more
    if cuda:
        torch.cuda.empty_cache()
    return r


def _restores(ctx, case, cfg, history_full, n):
    """Phase 7, in each rank: run (c)'s checkpoint restored onto each grid
    of ``RESTORE_GRIDS`` (``regrid``), then 2 steps; their observables
    beside the uninterrupted run's, and the restore's time (the gauge
    ``checkpoint.restore_us``, obs on around the restore only)."""
    import torch

    from repro_torch import dist, obs
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.solvers import make_solver

    out = {}
    for grid in RESTORE_GRIDS:
        c = dist.regrid(*grid)
        solver = make_solver(case, c.grid(), n, device=c.device, plan_cfg=cfg)
        with obs.capture() as (_, met):
            state, meta = solver.restore_state(CheckpointManager(CKPT_DIR))
        hist = []
        for _ in range(2):
            state = solver.step(state)
            hist.append(solver.observables(state))
        out[f"{grid[0]}x{grid[1]}"] = {
            "n_steps": state.n_steps, "saved_on": meta["mesh"], "history": hist,
            "want": history_full[3:5], "restore_us": met.get("checkpoint.restore_us")}
        del solver, state
        torch.cuda.empty_cache()
    return out


def _ranks_main(ctx, ref_hists, tune, n=512):
    """Everything the 4 rank processes do: phase 9's fold calibration on
    4x1, the wire against its plain version, the three runs of the
    multi-rank main path (run (c) with its checkpoint), the restores, and
    phase 9's 2x2 sweep."""
    out = {"rank": ctx.rank, "calibration": _calibrate_folds(ctx, tune["weights"])}
    out["wire"] = _wire_vs_plain(ctx)
    out["runs"] = []
    for tag, case, mesh, cfg in MULTI_RANK:
        save_at = CKPT_STEP if tag == CKPT_RUN else None
        out["runs"].append(_multi_rank_run(ctx, tag, case, mesh, cfg, ref_hists[case],
                                           n, out["calibration"]["doc"],
                                           save_at=save_at))
    run = next(r for r in out["runs"] if r["tag"] == CKPT_RUN)
    out["restores"] = _restores(ctx, run["case"], dict(MULTI_RANK_CFG[CKPT_RUN]),
                                run["history_full"], n)
    out["tuned"] = _tune_and_run(ctx, (2, 2), tune["ref_history"],
                                 out["calibration"]["doc"])
    return out


def multi_rank(runs, tune):
    """Phase 7: one spawn of 4 rank processes on the one card (the parent's
    cache freed first): the wire against its plain version, then the
    multi-rank main path held against the 1×1 radix-2 runs of phase 5 —
    per-step observables and final fields within 1e-10, counts of every
    kernel the run's mode uses above 0, no plain version, and
    ``exchange_rounds`` equal to the round model summed over the wires.
    The same spawn runs phase 9's folds on 4x1 first and its 2x2 sweep
    last (``tune``: the backend weights of (a))."""
    import torch

    from repro_torch import dist

    ref_hists = {case: runs["fft_radix2"][i]["history"]
                 for case, i in REFERENCE.items()}
    torch.cuda.empty_cache()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    tune = {**tune, "ref_history": runs["fft_radix2"][0]["ref_history"]}
    ranks = dist.run_ranks(_ranks_main, 4, 1, device="cuda",
                           args=(ref_hists, tune), timeout=900)
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
    checkpoint_restores(ranks)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return ranks, launches


def checkpoint_restores(ranks):
    """Phase 7: run (c)'s checkpoint, restored on each grid, against the
    uninterrupted run: bitwise on the 2x2 it was saved from, within 1e-10
    by ``observables_rel_err`` on the others (``mean`` is roundoff)."""
    from repro_torch.solvers.base import observables_rel_err

    i = next(k for k, run in enumerate(MULTI_RANK) if run[0] == CKPT_RUN)
    ck = ranks[0]["runs"][i]["checkpoint"]
    say(f"checkpoint of run ({CKPT_RUN}) at step {CKPT_STEP}: gather to rank 0 "
        f"{ck['gather_s']:.3f} s, host snapshot {ck['snapshot_s']:.3f} s, write "
        f"{ck['write_s']:.3f} s, {ck['bytes']} bytes")
    for grid in RESTORE_GRIDS:
        key = f"{grid[0]}x{grid[1]}"
        exact = grid == MULTI_RANK[i][2]
        worst = 0.0
        for rank, r in enumerate(ranks):
            got = r["restores"][key]
            if got["n_steps"] != CKPT_STEP + 2 or got["saved_on"] != list(MULTI_RANK[i][2]):
                fail(f"restore onto {key}, rank {rank}: {got['n_steps']} steps, "
                     f"saved on {got['saved_on']}")
            if exact and got["history"] != got["want"]:
                fail(f"restore onto {key}, rank {rank}: not bitwise: "
                     f"{got['history']} vs {got['want']}")
            worst = max([worst] + [observables_rel_err(a, b)
                                   for a, b in zip(got["history"], got["want"])])
        if worst > 1e-10:
            fail(f"restore onto {key}: observables differ from the uninterrupted "
                 f"run by {worst:.3e} > 1e-10")
        us = [r["restores"][key]["restore_us"] for r in ranks]
        say(f"restore onto {key} + 2 steps: {'bitwise' if exact else f'{worst:.2e}'} "
            f"against the uninterrupted run; checkpoint.restore_us per rank "
            f"{[round(u) for u in us]}")


def _staged_input(n, grid, dev):
    """This rank's block of the 3-axis runs' input, a planar pair: the same
    seeded draw on every rank (and in the parent), cut by ``grid``."""
    import torch

    from repro_torch.core.fft3d import scatter_pencil

    g = torch.Generator(device=dev).manual_seed(STAGED_SEED)
    x = torch.randn((2, n, n, n), generator=g, dtype=torch.float64, device=dev)
    block = scatter_pencil(x, grid).contiguous()
    del x
    return block[0], block[1]


def _staged_transforms(plan, fwd, inv, xr, xi):
    """The three transforms of a 3-axis run as thunks: forward, inverse of
    the forward, and the roundtrip with the heat diagonal (fused when the
    plan is)."""
    import torch

    from repro_torch.core import spectral as sp
    from repro_torch.core.fft3d import DiagonalKernel, spectral_roundtrip_local

    kern = DiagonalKernel(dr=torch.exp(-STAGED_DECAY * sp.k_squared(
        plan, xr.dtype, device=xr.device)))
    return {"fwd": lambda: fwd(xr, xi), "inv": lambda: inv(*fwd(xr, xi)),
            "roundtrip": lambda: spectral_roundtrip_local(plan, kern, xr, xi)}


def staged_reference(device="cuda", n=STAGED_N):
    """Phase 7: the 1x1 "pallas" transforms the 3-axis runs are held to,
    computed here and kept under ``REF_DIR``; returns each one's max|y|."""
    import numpy as np
    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.core.engine_spec import EngineSpec
    from repro_torch.core.fft3d import make_fft3d

    grid = PencilGrid.from_mesh(1, 1)
    xr, xi = _staged_input(n, grid, device)
    fwd, inv, plan = make_fft3d(grid, n, spec=EngineSpec(backend="pallas"),
                                device=device)
    scales = {}
    for name, run in _staged_transforms(plan, fwd, inv, xr, xi).items():
        yr, yi = run()
        scales[name] = max(float(yr.abs().max()), float(yi.abs().max()))
        for part, y in (("re", yr), ("im", yi)):
            np.save(os.path.join(REF_DIR, f"staged_{name}_{part}.npy"), y.cpu().numpy())
        del yr, yi
    del xr, xi
    torch.cuda.empty_cache()
    return scales


def _staged_main(ctx, n, scales):
    """Phase 7, in each of the 8 rank processes: each run of ``STAGED_RUNS``
    -- counts set to 0 just before its transforms and read just after, obs
    on for the forward's counters -- held per rank and gathered on rank 0
    to the 1x1 transforms; then ms per forward and per roundtrip with obs
    off, and rank 0's breakdown of one forward."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import transpose as tr
    from repro_torch.core.engine_spec import EngineSpec
    from repro_torch.core.fft3d import gather_pencil, make_fft3d

    grid, dev = ctx.grid(), ctx.device
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
    u, v = grid.coords
    xr, xi = _staged_input(n, grid, dev)
    out = {"rank": ctx.rank, "runs": []}
    for engine, fused in STAGED_RUNS:
        fwd, inv, plan = make_fft3d(grid, n, device=dev, spec=EngineSpec(
            engine=engine, backend="pallas", fused_roundtrip=fused))
        runs = _staged_transforms(plan, fwd, inv, xr, xi)
        model = tr.bidi_rounds if engine == "bidi_ring" else tr.ring_rounds
        before = {k: (w.exchanges, w.rounds) for k, w in ctx.wires().items()}
        sync()
        _zero_ring_counts()
        results = {}
        with obs.capture() as (_, met):
            results["fwd"] = runs["fwd"]()
            counters = met.counters()  # one forward transform's
            results["inv"] = inv(*results["fwd"])
            results["roundtrip"] = runs["roundtrip"]()
            sync()
        r = {"engine": engine, "fused": fused, "counts": _ring_counts(),
             "wires": _wire_rounds(ctx, dev, before, model),
             "exchange_rounds": plan.engine().exchange_rounds, "metrics": counters,
             "err": {}, "gathered_err": {}}
        for name, (yr, yi) in results.items():
            err = 0.0
            for part, y in (("re", yr), ("im", yi)):
                want = np.load(os.path.join(REF_DIR, f"staged_{name}_{part}.npy"),
                               mmap_mode="r")
                a, b = y.shape[0], y.shape[1]
                block = np.asarray(want[u * a:(u + 1) * a, v * b:(v + 1) * b])
                err = max(err, float(np.abs(y.cpu().numpy() - block).max()))
                whole = gather_pencil(y, grid)
                if whole is not None:
                    r["gathered_err"][name] = max(
                        r["gathered_err"].get(name, 0.0),
                        float(np.abs(whole.numpy() - want).max()) / scales[name])
                del whole
            r["err"][name] = err / scales[name]
        del results
        times = {}
        for name in ("fwd", "roundtrip"):
            ms = []
            for _ in range(3):
                sync()
                t0 = time.perf_counter()
                runs[name]()
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            times[name] = ms
        r["ms"] = times
        if cuda and ctx.rank == 0:
            r["breakdown"] = _profile(runs["fwd"], f"2x2x2 {engine} forward N={n}, "
                                                   "rank 0's kernels")
        else:
            runs["fwd"]()
        out["runs"].append(r)
        del fwd, inv, plan, runs
        torch.cuda.empty_cache()
    return out


def staged_mesh():
    """Phase 7, the 3-axis mesh: one spawn of 8 rank processes on the one
    card, the 3D FFT of ``STAGED_RUNS`` held to the 1x1 "pallas" one within
    1e-10·max|y| (per rank, and gathered to rank 0); per rank
    ``ring_payload``, ``ring_send``, ``ring_land`` and ``fft_radix2``
    launched, no plain version, each mesh axis' wire at the staged model's
    rounds, and rank 0's wire counters in the model's relation."""
    import torch

    from repro_torch import dist

    scales = staged_reference()
    t0 = time.perf_counter()
    ranks = dist.run_ranks(_staged_main, 2 * STAGED_SIZES[0], STAGED_PV,
                           u_sizes=STAGED_SIZES, device="cuda",
                           args=(STAGED_N, scales), timeout=900)
    say(f"3-axis mesh 2x2x2 (u over pod, data): 8 rank processes on one card in "
        f"{time.perf_counter() - t0:.1f} s")
    launches = check_staged(ranks)
    for f in os.listdir(REF_DIR):
        if f.startswith("staged_"):
            os.remove(os.path.join(REF_DIR, f))
    torch.cuda.empty_cache()
    return ranks, launches


def check_staged(ranks):
    """``staged_mesh``'s checks of the ranks' results; returns the ring
    kernels' launches."""
    from repro_torch.core import transpose as tr

    launches = dict.fromkeys(RING_KERNELS, 0)
    for i, (engine, fused) in enumerate(STAGED_RUNS):
        name = f"2x2x2 {engine} {'fused roundtrip' if fused else 'composed'} N={STAGED_N}"
        model = tr.bidi_rounds if engine == "bidi_ring" else tr.ring_rounds
        for rank, r in enumerate(r_["runs"][i] for r_ in ranks):
            c = r["counts"]
            for k in ("ring_payload", "ring_send", "ring_land", "fft_radix2"):
                if c[k] == 0:
                    fail(f"{name} rank {rank}: {k} never launched")
            if c["ref.calls"] or c["payload_plain"]:
                fail(f"{name} rank {rank}: a plain version ran: {c}")
            if sorted(r["wires"]) != ["u/data", "u/pod", "v/model"] or any(
                    w["rounds"] != w["model_rounds"] or not w["exchanges"]
                    for w in r["wires"].values()) or r["exchange_rounds"] != sum(
                    w["rounds"] for w in r["wires"].values()):
                fail(f"{name} rank {rank}: wires {r['wires']} against the staged "
                     f"model, exchange_rounds {r['exchange_rounds']}")
            bad = {k: e for k, e in r["err"].items() if not e <= 1e-10}
            if bad:
                fail(f"{name} rank {rank}: blocks differ from 1x1 by {bad} max|y|")
            for k in RING_KERNELS:
                launches[k] += c[k]
        r0 = ranks[0]["runs"][i]
        met = r0["metrics"]
        for ax in ("pod", "data", "model"):
            n_ex = met.get(f"comm.exchanges.{ax}", 0)
            if not n_ex or met.get(f"comm.exchange_rounds.{ax}") != n_ex * model(2):
                fail(f"{name}: rank 0's wire counters break the model on {ax}: {met}")
        if not met.get("comm.wire_bytes"):
            fail(f"{name}: rank 0 counted no wire bytes: {met}")
        bad = {k: e for k, e in r0["gathered_err"].items() if not e <= 1e-10}
        if bad or sorted(r0["gathered_err"]) != sorted(STAGED_TRANSFORMS):
            fail(f"{name}: gathered transforms differ from 1x1: {r0['gathered_err']}")
        say(f"{name}: vs 1x1 per rank (worst) "
            + ", ".join(f"{k} {max(r_['runs'][i]['err'][k] for r_ in ranks):.2e}"
                        for k in STAGED_TRANSFORMS)
            + "; gathered on rank 0 "
            + ", ".join(f"{k} {e:.2e}" for k, e in r0["gathered_err"].items())
            + " max|y|")
        say(f"{name} rank 0: ms per forward {[round(t, 3) for t in r0['ms']['fwd']]}, "
            f"per roundtrip {[round(t, 3) for t in r0['ms']['roundtrip']]}; counts "
            f"{r0['counts']}; wires {r0['wires']}; forward's counters {met}")
        for line in r0.get("breakdown", {}).get("lines", []):
            say(line)
    return launches


def observability(runs):
    """Phase 5, observability: heat N=512 f64 on 1x1 "pallas", 5 steps with
    obs off -- no wait for the card (``obs.synchronize`` never called), no
    span, no counter -- then 5 with obs on, whose Chrome trace must pass
    ``validate_chrome_trace`` with one ``dispatch/solver.step`` span a
    step.  ms/step of both printed; the obs-off median must stay within
    10 % of the fastest of the main path's heat steps (``runs``)."""
    import statistics

    import torch

    from repro_torch import obs
    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver

    solver = make_solver("heat", PencilGrid.from_mesh(1, 1), 512, device="cuda",
                         plan_cfg={"backend": "pallas"})
    state = solver.step(solver.init_state())
    waits = []
    real_sync = obs.synchronize

    def counted(out):
        waits.append(1)
        real_sync(out)

    def steps():
        nonlocal state
        ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = solver.step(state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    obs.disable()
    obs.clear()
    obs.synchronize = counted
    try:
        off = steps()
        off_waits = len(waits)
        off_records = len(obs.tracer.events()) + len(obs.metrics.counters())
        with obs.capture() as (tracer, metrics):
            on = steps()
    finally:
        obs.synchronize = real_sync
    if off_waits or off_records:
        fail(f"observability: with obs off, {off_waits} waits for the card and "
             f"{off_records} spans and counters")
    main_ms = min(runs["fft_radix2"][0]["step_ms"])
    if statistics.median(off) > 1.10 * main_ms:
        fail(f"observability: heat steps with obs off take {statistics.median(off):.3f} "
             f"ms, more than 1.10 x the main path's {main_ms:.3f}")
    path = os.path.join(HERE, "build", "chip_smoke_trace.json")
    obs.write_chrome_trace(path, tracer, metrics, meta={"run": "heat N=512 1x1"})
    with open(path) as f:
        doc = json.load(f)
    problems = obs.validate_chrome_trace(doc)
    n_steps = [e["name"] for e in doc["traceEvents"]].count("dispatch/solver.step")
    if problems or n_steps != len(on) or len(waits) != len(on):
        fail(f"observability: trace problems {problems[:3]}, {n_steps} step spans "
             f"and {len(waits)} waits for {len(on)} steps")
    out = {"off_ms": off, "on_ms": on, "spans": len(doc["traceEvents"]),
           "main_path_ms": main_ms}
    say(f"observability heat N=512 1x1 pallas: ms/step obs off "
        f"{[round(t, 3) for t in off]} (median {statistics.median(off):.3f}; the main "
        f"path's fastest {main_ms:.3f}), obs on "
        f"{[round(t, 3) for t in on]} (median {statistics.median(on):.3f}); trace "
        f"{out['spans']} spans, valid, {n_steps} dispatch/solver.step")
    del solver, state
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: the perf model's calibration and the plan autotuner
# ---------------------------------------------------------------------------

def calibrate_backends():
    """Phase 9 (a), in this process: each backend's 1D c2c transform at the
    main path's shape (``CARD_BACKEND_SHAPE``: f64, N=512, 512·512 rows),
    its time over ``torch.fft``'s.  Phase 9 starts with a cold plan cache."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.tuning import calibrate as cal

    for path in (TUNE_CACHE, CALIBRATION_OUT):
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    weights = cal.measure_backend_weights(iters=CALIBRATION_ITERS, device="cuda",
                                          verbose=True, **cal.CARD_BACKEND_SHAPE)
    torch.cuda.empty_cache()
    if set(weights) != set(ops.BACKENDS):
        fail(f"tuning (a): backend weights measured for {sorted(weights)} only")
    return {"weights": weights, "s": time.perf_counter() - t0}


def _calibrate_folds(ctx, weights):
    """Phase 9 (a), in each rank of the 4x1 grid: every engine's X<->Y fold
    at ``CARD_FOLD_SIZES`` in lockstep (each time the max over the ranks),
    the document assembled with the parent's backend weights and installed
    in this process's model."""
    from repro_torch.core import perfmodel as pm
    from repro_torch.tuning import calibrate as cal

    t0 = time.perf_counter()
    grid = ctx.grid()
    overheads, link = cal.measure_engine_overheads(
        grid, iters=CALIBRATION_ITERS, sizes=cal.CARD_FOLD_SIZES,
        verbose=ctx.rank == 0)
    doc = cal.calibration_document(grid.mesh_label, overheads, link, weights,
                                   quick=False, iters=CALIBRATION_ITERS,
                                   device=ctx.device)
    pm.set_calibration(doc)
    return {"doc": doc, "s": time.perf_counter() - t0}


def _predictions(solver, doc):
    """``solver.predict_step_us()`` under the model's H100 priors and under
    the calibration ``doc``, which stays installed."""
    from repro_torch.core import perfmodel as pm

    out = {}
    for label, cal in (("priors", None), ("calibrated", doc)):
        pm.set_calibration(cal)
        out[label] = solver.predict_step_us()
    return out


def _tune_counts():
    return {**_counts(), **_ring_counts()}


def _zero_tune_counts():
    from repro_torch.kernels import fft_mxu
    _zero_ring_counts()
    fft_mxu.launches = fft_mxu.plain_calls = 0


def _expected_keep(grid):
    """The candidates ``autotune_solver_step`` must time for TUNE_CASE on
    ``grid``, in order: the case's space ranked by the roundtrip model, its
    top ``TUNE_GRIDS[mesh]``, then the default if not among them."""
    from repro_torch.core import perfmodel as pm
    from repro_torch.solvers import SOLVERS
    from repro_torch.tuning import DEFAULT_CANDIDATE, candidate_space

    cls, n = SOLVERS[TUNE_CASE], (TUNE_N,) * 3
    cands = candidate_space(n, grid.pu, grid.pv, real=cls.real,
                            components=cls.components, fused=True,
                            pu_axes=grid.u_sizes, pv_axes=grid.v_sizes)
    cands.sort(key=lambda c: pm.estimate_roundtrip_seconds(
        n, grid.pu, grid.pv, spec=c.spec(real=cls.real), mu=max(cls.components, 1),
        pu_axes=grid.u_sizes, pv_axes=grid.v_sizes))
    keep = cands[:TUNE_GRIDS[(grid.pu, grid.pv)]]
    if DEFAULT_CANDIDATE not in keep:
        keep.append(DEFAULT_CANDIDATE)
    return [c.name for c in keep]


def _tune_and_run(ctx, mesh, ref_history, doc):
    """Phase 9 (b) on 1x1 in this process (``ctx`` None) or (c) in each rank:
    ``autotune_solver_step`` for heat N=512 f64 under the calibration
    ``doc`` into a cold cache, the counts set to 0 just before the sweep and
    read just after; the same call again (a cache hit, counts read); then
    TUNE_STEPS steps of the winner's plan, counts set to 0 just before,
    observables held to phase 5's ``backend="ref"`` heat run."""
    import torch

    from repro_torch import dist
    from repro_torch.core import perfmodel as pm
    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver
    from repro_torch.solvers.base import observables_rel_err
    from repro_torch.tuning import autotune_solver_step

    if ctx is None:
        grid, dev, rank = PencilGrid.from_mesh(*mesh), torch.device("cuda"), 0
    else:
        c = dist.regrid(*mesh)
        grid, dev, rank = c.grid(), c.device, ctx.rank
    pm.set_calibration(doc)
    kw = dict(dtype="float64", cache_path=TUNE_CACHE, max_candidates=TUNE_GRIDS[mesh],
              iters=TUNE_ITERS, device=dev)
    torch.cuda.synchronize(dev)
    _zero_tune_counts()
    t0 = time.perf_counter()
    res = autotune_solver_step(grid, TUNE_CASE, TUNE_N, verbose=rank == 0, **kw)
    out = {"mesh": list(mesh), "sweep_s": time.perf_counter() - t0,
           "sweep_counts": _tune_counts(), "cache_hit": res.cache_hit,
           "best": res.best_config, "best_name": res.best.name, "best_us": res.best_us,
           "rows": res.rows, "keep": _expected_keep(grid)}
    _zero_tune_counts()
    again = autotune_solver_step(grid, TUNE_CASE, TUNE_N, **kw)
    out["again"] = {"cache_hit": again.cache_hit, "best": again.best_config,
                    "counts": _tune_counts()}
    solver = make_solver(TUNE_CASE, grid, TUNE_N, device=dev, plan_cfg=res.best_config)
    state = solver.init_state()
    history = [solver.observables(state)]
    step_ms = []
    torch.cuda.synchronize(dev)
    _zero_tune_counts()
    for _ in range(TUNE_STEPS):
        t0 = time.perf_counter()
        state = solver.step(state)
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        history.append(solver.observables(state))
    out["counts"] = _tune_counts()
    ok, lines = solver.validate(history)
    out.update(step_ms=step_ms, validate=bool(ok), validate_lines=lines,
               finite=all(bool(torch.isfinite(f).all()) for f in state.fields),
               obs_rel_err=max(observables_rel_err(a, b)
                               for a, b in zip(history, ref_history)),
               predict_us=_predictions(solver, doc))
    del solver, state
    torch.cuda.empty_cache()
    return out


_BACKEND_KERNEL = {"pallas": "fft_radix2", "mxu": "fft_mxu"}


def _check_tuned(label, outs):
    """Phase 9 (b)/(c): every rank took the same winner from the same rows;
    every kept candidate was timed, none dropped, the default among them;
    the kernels of the timed backends launched in the sweep; the second
    call was a cache hit that launched nothing; the winner's steps passed
    ``validate()`` within 1e-10 of the ref run, launched its backend's
    kernel (and on a grid the wire's copies) and no plain version."""
    from repro_torch.tuning import DEFAULT_CANDIDATE

    o = outs[0]
    if any(x["best"] != o["best"] or x["rows"] != o["rows"] for x in outs):
        fail(f"tuning {label}: the ranks disagree: "
             f"{[x['best_name'] for x in outs]}")
    names = [r["name"] for r in o["rows"]]
    if o["cache_hit"] or names != o["keep"] or DEFAULT_CANDIDATE.name not in names:
        fail(f"tuning {label}: timed {names}, kept {o['keep']} (cache hit "
             f"{o['cache_hit']})")
    backends = {r["config"]["backend"] for r in o["rows"]}
    winner = o["best"]
    for rank, x in enumerate(outs):
        sc, wc = x["sweep_counts"], x["counts"]
        for b, k in _BACKEND_KERNEL.items():
            if b in backends and sc[k] == 0:
                fail(f"tuning {label} rank {rank}: {b!r} candidates timed, {k} "
                     f"never launched: {sc}")
        if sc["fft_mxu.plain_calls"] or sc["payload_plain"] or (
                "ref" not in backends and sc["ref.calls"]):
            fail(f"tuning {label} rank {rank}: a plain version ran in the sweep: {sc}")
        if not x["again"]["cache_hit"] or x["again"]["best"] != winner or any(
                x["again"]["counts"].values()):
            fail(f"tuning {label} rank {rank}: the second call {x['again']}")
        k = _BACKEND_KERNEL.get(winner["backend"])
        if (k and wc[k] == 0) or wc["ref.calls"] or wc["fft_mxu.plain_calls"] \
                or wc["payload_plain"]:
            fail(f"tuning {label} rank {rank}: the winner's steps counted {wc}")
        if len(outs) > 1 and (wc["ring_send"] == 0 or wc["ring_land"] == 0):
            fail(f"tuning {label} rank {rank}: the winner's exchanges launched no "
                 f"wire copy: {wc}")
        if not x["validate"] or not x["finite"] or x["obs_rel_err"] > 1e-10:
            fail(f"tuning {label} rank {rank}: validate {x['validate']} "
                 f"{x['validate_lines']}, finite {x['finite']}, observables vs the "
                 f"ref run {x['obs_rel_err']:.3e}")
    default = next(r for r in o["rows"] if r["name"] == DEFAULT_CANDIDATE.name)
    say(f"tuning {label}: {len(names)} candidates in {o['sweep_s']:.1f} s "
        f"(rank 0), none dropped; winner {o['best_name']} {o['best_us']:.1f} us/step "
        f"against the default's {default['us_per_call']:.1f} "
        f"({default['us_per_call'] / o['best_us']:.3f}x); "
        f"{'every rank the same; ' if len(outs) > 1 else ''}"
        f"sweep counts (rank 0) {o['sweep_counts']}")
    for r in o["rows"]:
        say(f"  tuning {label} {r['name']}: {r['us_per_call']:.1f} us/step")
    say(f"tuning {label} winner, {TUNE_STEPS} steps: ms/step "
        f"{[round(t, 3) for t in o['step_ms']]}, counts {o['counts']}, observables vs "
        f"the ref run {max(x['obs_rel_err'] for x in outs):.2e}, validate True; "
        f"second call a cache hit, nothing launched")


def tuning(runs, ranks, backends):
    """Phase 9 in this process: the calibration of (a) (the ranks' folds
    and this process's backends) checked and written, (c) checked, (b)
    run and checked, then (d): ``predict_step_us()`` under the priors and
    under the calibration against each measured ms/step."""
    import statistics

    from repro_torch.core import perfmodel as pm
    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import make_solver
    from repro_torch.tuning import calibrate as cal

    docs = [{k: v for k, v in r["calibration"]["doc"].items() if k != "created"}
            for r in ranks]
    doc = ranks[0]["calibration"]["doc"]
    problems = cal.validate_calibration(doc)
    if problems or any(d != docs[0] for d in docs):
        fail(f"tuning (a): calibration problems {problems}, or the ranks disagree")
    cal.save_calibration(doc, CALIBRATION_OUT)
    say(f"tuning (a): calibration in {backends['s']:.1f} s (backends) + "
        f"{ranks[0]['calibration']['s']:.1f} s (folds on 4x1, N={cal.CARD_FOLD_SIZES})")
    for b, w in sorted(doc["backend_compute_weight"].items()):
        say(f"  compute weight   {b:<13} {w:8.4f}  (prior {pm.BACKEND_COMPUTE_WEIGHT[b]})")
    for e in pm.ENGINE_MESSAGE_OVERHEAD_S:
        got = doc["engine_message_overhead_s"].get(e)
        say(f"  message overhead {e:<13} "
            + (f"{got * 1e6:8.3f} us" if got else "not measured (noise)")
            + f"  (prior {pm.ENGINE_MESSAGE_OVERHEAD_S[e] * 1e6:.3f} us)")
    say(f"  wire bandwidth   {doc.get('link_bytes_per_s', 0) / 1e9:8.2f} GB/s "
        f"(prior {pm.LINK_BYTES_PER_S / 1e9:.1f} GB/s)")
    _check_tuned("(c) 2x2", [r["tuned"] for r in ranks])
    ref_history = runs["fft_radix2"][0]["ref_history"]
    one = _tune_and_run(None, (1, 1), ref_history, doc)
    _check_tuned("(b) 1x1", [one])

    table = []

    def row(label, pred, step_ms):
        ms = statistics.median(step_ms)
        table.append({"run": label, "measured_ms": ms, **{
            f"{k}_ms": v / 1e3 for k, v in pred.items()}, **{
            f"{k}_err": v / 1e3 / ms - 1 for k, v in pred.items()}})
        t = table[-1]
        say(f"tuning (d) {label}: measured {ms:.3f} ms/step; predicted "
            f"{t['priors_ms']:.3f} ms under the priors (model_err {t['priors_err']:+.3f}), "
            f"{t['calibrated_ms']:.3f} under the calibration ({t['calibrated_err']:+.3f})")
    for name in KERNELS:
        r = runs[name][0]  # heat N=512, the main path's default plan
        solver = make_solver("heat", PencilGrid.from_mesh(1, 1), 512, device="cuda",
                             plan_cfg={"backend": r["backend"]})
        row(f"heat 1x1 {r['backend']!r}", _predictions(solver, doc), r["step_ms"])
        del solver
    for i, (tag, case, mesh, cfg) in enumerate(MULTI_RANK):
        r0 = ranks[0]["runs"][i]
        row(f"({tag}) {case} {mesh[0]}x{mesh[1]} {cfg['comm_engine']}", r0["predict_us"],
            r0["step_ms"][1:])
    for label, o in (("(b) 1x1", one), ("(c) 2x2", ranks[0]["tuned"])):
        row(f"tuned {label} {o['best_name']}", o["predict_us"], o["step_ms"])
    pm.set_calibration(None)
    return {"calibration": doc, "backends": backends, "one": one,
            "grid": [r["tuned"] for r in ranks], "model": table}


# ---------------------------------------------------------------------------
# phase 10: serving spectral simulations (repro_torch.serving)
# ---------------------------------------------------------------------------

SERVE_KERNELS = ("fft_radix2", "fft_mxu", "ring_payload", "ring_send", "ring_land")
SERVE_PLAIN = ("ref.calls", "fft_mxu.plain_calls", "payload_plain")


def _serve_counts():
    from repro_torch.kernels import fft_mxu, fft_radix2, ops, ref, ring_rdma
    return {"fft_radix2": fft_radix2.launches, "fft_mxu": fft_mxu.launches,
            "ring_payload": ring_rdma.payload_launches,
            "ring_send": ring_rdma.send_launches, "ring_land": ring_rdma.land_launches,
            "shared_diag": ring_rdma.shared_diag_launches,
            "slab_copies": ops.slab_copies, "payload_copies": ring_rdma.payload_copies,
            "ref.calls": ref.calls, "fft_mxu.plain_calls": fft_mxu.plain_calls,
            "payload_plain": ring_rdma.plain_calls}


def _zero_serve_counts():
    from repro_torch.kernels import fft_mxu, fft_radix2, ops, ref, ring_rdma
    fft_radix2.launches = fft_mxu.launches = ref.calls = fft_mxu.plain_calls = 0
    ring_rdma.payload_launches = ring_rdma.send_launches = 0
    ring_rdma.land_launches = ring_rdma.plain_calls = 0
    ring_rdma.shared_diag_launches = ring_rdma.payload_copies = ops.slab_copies = 0


def _since(before):
    return {k: v - before[k] for k, v in _serve_counts().items()}


def _serve_requests(case, n, k, cfg, scale_step=0.25):
    from repro_torch.serving import SimRequest
    return [SimRequest(case=case, n=n, steps=SERVE_STEPS, dtype="float64",
                       plan_cfg=dict(cfg),
                       scale=1.0 + scale_step * (i % SERVE_SCALES),
                       request_id=f"{case}-{i}") for i in range(k)]


def _solo_history(solver, req):
    """A solo run of ``req`` (the server's initial fields, the solo step)."""
    from repro_torch.serving import scaled_initial_fields
    from repro_torch.solvers import SolverState

    st = SolverState(fields=scaled_initial_fields(solver, req.scale))
    hist = [solver.observables(st)]
    for _ in range(req.steps):
        st = solver.step(st)
        hist.append(solver.observables(st))
    return hist


def _solo_key(req):
    return f"{req.case}@{req.scale!r}"


def _solo_histories(registry, reqs):
    """One solo run for each (case, scale) among ``reqs``, keyed so."""
    solos = {}
    for r in reqs:
        if _solo_key(r) not in solos:
            solos[_solo_key(r)] = _solo_history(registry.get(r), r)
    return solos


def _batch_sizes(batch_log):
    """``{lanes: batches}`` of a server's ``batch_log``."""
    return dict(sorted(collections.Counter(len(ids) for _, ids in batch_log).items()))


def _ms3(fn, dev):
    """Median of 3 host-clock timings of ``fn()``, the card synchronised."""
    import torch

    times = []
    for _ in range(3):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[1]


def _step_vs_solo(solver, reqs, dev, profile_label=None, profile_step=False):
    """One batched step of ``reqs``' lanes against one solo step of the
    first: kernel and copy counts of each, ms (median of 3), and the step's
    footprint (its inputs plus the peak it allocates above them).  With
    ``profile_step``, one more batched step (every rank of a grid takes
    it), under ``torch.profiler`` where ``profile_label`` names it."""
    import torch

    from repro_torch.serving import scaled_initial_fields
    from repro_torch.solvers import SolverState

    lanes = [scaled_initial_fields(solver, r.scale) for r in reqs]
    stack = tuple(torch.stack(xs) for xs in zip(*lanes))
    solo = SolverState(fields=lanes[0])
    del lanes
    solver.step(solo)
    solver.batched_step(stack)   # both warm
    out = {"lanes": len(reqs)}
    for kind, fn, fields in (("solo", lambda: solver.step(solo), solo.fields),
                             ("batched", lambda: solver.batched_step(stack), stack)):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        before = _serve_counts()
        fn()
        torch.cuda.synchronize(dev)
        inputs = sum(f.numel() * f.element_size() for f in fields)
        out[kind] = {"counts": _since(before), "ms": _ms3(fn, dev),
                     "gib": (torch.cuda.max_memory_allocated(dev) - base + inputs) / 2**30}
    if profile_step and profile_label:
        out["breakdown"] = _profile(lambda: solver.batched_step(stack), profile_label)
    elif profile_step:
        solver.batched_step(stack)
    del stack, solo
    torch.cuda.empty_cache()
    return out


def _check_step_counts(tag, cmp):
    """A batched step launches each kernel as often as a solo step, and
    neither reaches a plain version."""
    s, b = cmp["solo"]["counts"], cmp["batched"]["counts"]
    if any(s[k] != b[k] for k in SERVE_KERNELS):
        fail(f"{tag}: a batched step of {cmp['lanes']} lanes launches "
             f"{ {k: b[k] for k in SERVE_KERNELS} }, a solo step "
             f"{ {k: s[k] for k in SERVE_KERNELS} }")
    if any(s[k] or b[k] for k in SERVE_PLAIN):
        fail(f"{tag}: a plain version ran: solo {s}, batched {b}")


def _check_lanes(tag, report, reqs, solos, registry):
    """Every request of ``reqs`` served, none rejected or failed, each
    lane's history bitwise the solo run of its case and scale and passing
    its solver's ``validate()``."""
    if report.n_rejected or report.n_failed or len(report.results) != len(reqs):
        fail(f"{tag}: {report.n_rejected} rejected, {report.n_failed} failed: "
             f"{[r.error for r in report.results if not r.ok]}")
    for r in report.results:
        want = solos[_solo_key(r.request)]
        if r.history != want:
            fail(f"{tag}: {r.request.request_id} is not bitwise its solo run: "
                 f"{r.history} vs {want}")
        ok, lines = registry.get(r.request).validate(r.history)
        if not ok:
            fail(f"{tag}: {r.request.request_id} validate() failed: {lines}")


def _load_line(smi, tag, report, batch_log):
    st = report.stats()
    sizes = _batch_sizes(batch_log)
    say(f"[{smi}] {tag}: {st['n_requests']} requests in {st['wall_s']:.3f} s, "
        f"{st['requests_per_s']:.3f} requests/s, latency p50 / p95 / p99 "
        f"{st['p50_us'] / 1e3:.1f} / {st['p95_us'] / 1e3:.1f} / "
        f"{st['p99_us'] / 1e3:.1f} ms, batches by lanes {sizes}, "
        f"{st['n_rejected']} rejected, {st['n_failed']} failed")
    return {**st, "batch_sizes": sizes}


def _step_line(smi, tag, cmp):
    s, b = cmp["solo"], cmp["batched"]
    say(f"[{smi}] {tag}: one batched step of B={cmp['lanes']} {b['ms']:.3f} ms "
        f"against B x solo {cmp['lanes'] * s['ms']:.3f} ms ({s['ms']:.3f} a solo "
        f"step; {cmp['lanes'] * s['ms'] / b['ms']:.3f}x); peak {b['gib']:.2f} GiB "
        f"at B={cmp['lanes']}, {s['gib']:.2f} GiB at B=1; launches a step "
        f"batched { {k: b['counts'][k] for k in SERVE_KERNELS if b['counts'][k]} } "
        f"= solo { {k: s['counts'][k] for k in SERVE_KERNELS if s['counts'][k]} }; "
        f"copies batched slab {b['counts']['slab_copies']} payload "
        f"{b['counts']['payload_copies']}, solo slab {s['counts']['slab_copies']} "
        f"payload {s['counts']['payload_copies']}")
    for line in cmp.get("breakdown", {}).get("lines", []):
        say(line)


def _serve_1x1(smi, backend):
    """Phase 10 (a) on ``backend``: the memory check, the burst of heat
    and nls requests through ``run_load`` (counts set to 0 just before and
    read just after), each lane against its solo run, one batched step
    against a solo step.  Returns the results and the solo histories."""
    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.serving import SimServer, run_load

    dev = torch.device("cuda", torch.cuda.current_device())
    grid = PencilGrid.from_mesh(1, 1)
    cfg = {"backend": backend}
    heat = _serve_requests("heat", SERVE_N, SERVE_REQUESTS, cfg)
    nls = _serve_requests("nls", SERVE_NLS[0], SERVE_NLS[1], cfg, scale_step=0.5)
    # memory first: one solo step's footprint, B lanes' at most SERVE_MEM_GIB
    server = SimServer(grid, device=dev, max_batch=SERVE_BATCH, use_plan_cache=False)
    probe = _step_vs_solo(server.registry.get(heat[0]), heat[:1], dev)
    solo_gib = probe["solo"]["gib"]
    b = SERVE_BATCH if SERVE_BATCH * solo_gib <= SERVE_MEM_GIB else max(
        1, int(SERVE_MEM_GIB // solo_gib))
    server.max_batch = b
    say(f"[{smi}] serving 1x1 {backend!r}: a solo heat N={SERVE_N} step takes "
        f"{solo_gib:.2f} GiB; {SERVE_BATCH} lanes {SERVE_BATCH * solo_gib:.2f} GiB "
        f"against {SERVE_MEM_GIB:g}: max_batch {b}")
    # the burst: heat 0-3, nls, the other heat, nls (the queue serves the
    # oldest lane's head first: 4 heat, 2 nls, the other heat 4 at a time)
    reqs = heat[:4] + nls[:1] + heat[4:] + nls[1:]
    torch.cuda.synchronize(dev)
    _zero_serve_counts()
    report = run_load(server, reqs)
    torch.cuda.synchronize(dev)
    counts = _serve_counts()
    if counts[_BACKEND_KERNEL[backend]] == 0 or any(counts[k] for k in SERVE_PLAIN):
        fail(f"serving 1x1 {backend!r}: counts {counts}")
    solos = _solo_histories(server.registry, reqs)
    _check_lanes(f"serving 1x1 {backend!r}", report, reqs, solos, server.registry)
    load = _load_line(smi, f"serving 1x1 {backend!r} burst (heat N={SERVE_N} "
                           f"x{SERVE_REQUESTS} + nls N={SERVE_NLS[0]} x{SERVE_NLS[1]}, "
                           f"{SERVE_STEPS} steps, max_batch {b})", report,
                      server.batch_log)
    say(f"serving 1x1 {backend!r}: counts of the burst {counts}; every lane "
        f"bitwise its solo run and validate() passing")
    label = (f"one batched heat N={SERVE_N} step, B={b}, {backend!r}"
             if backend == SERVE_BACKENDS[0] else None)
    cmp = _step_vs_solo(server.registry.get(heat[0]), heat[:b], dev, label,
                        profile_step=label is not None)
    _check_step_counts(f"serving 1x1 {backend!r}", cmp)
    _step_line(smi, f"serving 1x1 {backend!r}", cmp)
    del server, probe
    torch.cuda.empty_cache()
    return {"backend": backend, "max_batch": b, "solo_gib": solo_gib,
            "counts": counts, "load": load, "step": cmp}, solos


def _serve_threaded(smi, solos):
    """Phase 10 (b): the heat requests paced at ``SERVE_RATE`` requests/s
    through the scheduler thread (``run_load`` starts it; the thread takes
    the server's card as its own), each lane against its solo run."""
    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.serving import SimServer, run_load

    dev = torch.device("cuda", torch.cuda.current_device())
    backend = SERVE_BACKENDS[0]
    heat = _serve_requests("heat", SERVE_N, SERVE_REQUESTS, {"backend": backend})
    server = SimServer(PencilGrid.from_mesh(1, 1), device=dev,
                       max_batch=SERVE_BATCH, use_plan_cache=False)
    torch.cuda.synchronize(dev)
    _zero_serve_counts()
    report = run_load(server, heat, rate_hz=SERVE_RATE)
    torch.cuda.synchronize(dev)
    counts = _serve_counts()
    if server.running or counts[_BACKEND_KERNEL[backend]] == 0 or any(
            counts[k] for k in SERVE_PLAIN):
        fail(f"serving 1x1 threaded: running {server.running}, counts {counts}")
    _check_lanes("serving 1x1 threaded", report, heat, solos, server.registry)
    load = _load_line(smi, f"serving 1x1 {backend!r} threaded, paced at "
                           f"{SERVE_RATE:g} requests/s", report, server.batch_log)
    if max(load["batch_sizes"]) < 2:
        fail(f"serving 1x1 threaded: paced at {SERVE_RATE:g} requests/s, no "
             f"batch held more than one lane: {load['batch_sizes']}")
    say(f"serving 1x1 threaded: counts {counts}; every lane bitwise its solo run")
    del server
    torch.cuda.empty_cache()
    return {"counts": counts, "load": load}


def _serve_ranks(ctx):
    """Phase 10 (c), in each of the 4 rank processes: rank 0 runs the
    server's scheduler and the burst, the others follow its batches
    (counts set to 0 just before, read just after); then every rank's solo
    2x2 runs of the same requests and one batched step against a solo step,
    rank 0's profiled."""
    import torch
    import torch.distributed as tdist

    from repro_torch.serving import SimServer, run_load

    dev = ctx.device
    reqs = _serve_requests("heat", SERVE_N, SERVE_GRID_REQUESTS,
                           MULTI_RANK_CFG[CKPT_RUN])
    server = SimServer(ctx.grid(), device=dev, max_batch=SERVE_GRID_BATCH,
                       use_plan_cache=False)
    out = {"rank": ctx.rank}
    torch.cuda.synchronize(dev)
    tdist.barrier()
    _zero_serve_counts()
    if ctx.rank == 0:
        report = run_load(server, reqs)
        server.close()
        out["results"] = [(r.request.request_id, _solo_key(r.request), r.ok,
                           r.error, r.batch_size, r.history) for r in report.results]
        out["load"] = report.stats()
        out["load"]["batch_sizes"] = _batch_sizes(server.batch_log)
    else:
        server.follow()
    torch.cuda.synchronize(dev)
    out["counts"] = _serve_counts()
    out["batch_log"] = server.batch_log
    solver = server.registry.get(reqs[0])
    out["solos"] = _solo_histories(server.registry, reqs)
    out["validate"] = {}
    for key, hist in out["solos"].items():
        ok, lines = solver.validate(hist)
        out["validate"][key] = (bool(ok), lines)
    label = (f"one batched heat N={SERVE_N} step on 2x2, B={SERVE_GRID_BATCH}, "
             "rank 0's kernels") if ctx.rank == 0 else None
    out["step"] = _step_vs_solo(solver, reqs[:SERVE_GRID_BATCH], dev, label,
                                profile_step=True)
    del server, solver
    torch.cuda.empty_cache()
    return out


def _serve_grid(smi):
    """Phase 10 (c): the 2x2 spawn and its gates."""
    import torch

    from repro_torch import dist

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.run_ranks(_serve_ranks, 2, 2, device="cuda", timeout=600)
    tag = f"serving 2x2 {MULTI_RANK_CFG[CKPT_RUN]}"
    r0 = ranks[0]
    for rank, r in enumerate(ranks):
        c = r["counts"]
        if any(c[k] == 0 for k in ("fft_radix2", "ring_payload", "ring_send",
                                   "ring_land", "shared_diag")) or any(
                c[k] for k in SERVE_PLAIN):
            fail(f"{tag} rank {rank}: counts {c}")
        if r["batch_log"] != r0["batch_log"]:
            fail(f"{tag}: rank {rank} served {r['batch_log']}, rank 0 {r0['batch_log']}")
        _check_step_counts(f"{tag} rank {rank}", r["step"])
    for rid, key, ok, err, _, hist in r0["results"]:
        if not ok:
            fail(f"{tag}: {rid} failed: {err}")
        if hist != r0["solos"][key]:
            fail(f"{tag}: {rid} is not bitwise its solo 2x2 run: {hist} vs "
                 f"{r0['solos'][key]}")
        v_ok, lines = r0["validate"][key]
        if not v_ok:
            fail(f"{tag}: {rid} validate() failed: {lines}")
    if len(r0["results"]) != SERVE_GRID_REQUESTS or r0["load"]["n_rejected"]:
        fail(f"{tag}: {len(r0['results'])} results, {r0['load']['n_rejected']} rejected")
    st = r0["load"]
    say(f"[{smi}] {tag}: 4 rank processes in {time.perf_counter() - t0:.1f} s; "
        f"{st['n_requests']} requests in {st['wall_s']:.3f} s, "
        f"{st['requests_per_s']:.3f} requests/s, latency p50 / p95 / p99 "
        f"{st['p50_us'] / 1e3:.1f} / {st['p95_us'] / 1e3:.1f} / "
        f"{st['p99_us'] / 1e3:.1f} ms, batches by lanes {st['batch_sizes']}; "
        f"every rank served the same {len(r0['batch_log'])} batches")
    for rank, r in enumerate(ranks):
        say(f"{tag} rank {rank}: counts {r['counts']}")
    say(f"{tag}: every lane bitwise its solo 2x2 run, validate() passing; "
        f"roundtrip payloads with the multiplier shared by the lanes "
        f"{r0['counts']['shared_diag']} on rank 0")
    _step_line(smi, f"{tag} rank 0", r0["step"])
    return ranks


def serving(smi):
    """Phase 10: serving on the card; returns the results and the kernel
    launches of its runs (the bursts, the paced run, the 2x2 burst)."""
    out = {"1x1": []}
    solos = None
    for backend in SERVE_BACKENDS:
        r, s = _serve_1x1(smi, backend)
        out["1x1"].append(r)
        solos = solos or s
    out["threaded"] = _serve_threaded(smi, solos)
    ranks = _serve_grid(smi)
    out["2x2"] = [{k: v for k, v in r.items() if k != "solos"} for r in ranks]
    launches = dict.fromkeys(SERVE_KERNELS, 0)
    for counts in ([r["counts"] for r in out["1x1"]] + [out["threaded"]["counts"]]
                   + [r["counts"] for r in ranks]):
        for k in SERVE_KERNELS:
            launches[k] += counts[k]
    return out, launches


# ---------------------------------------------------------------------------
# phase 11: the fleet (repro_torch.fleet): supervised workers, kill and resume
# ---------------------------------------------------------------------------

FLEET_DIR = os.path.join(HERE, "build", "chip_smoke_fleet")
FLEET_N = 512
FLEET_STEPS = 4
FLEET_SCALES = (1.0, 1.25)
FLEET_KILL_STEP = 3
FLEET_KILL = f"kill-at-step:{FLEET_KILL_STEP}"
FLEET_CKPT_EVERY = 2
#: the step the killed attempts resume from: the last snapshot before the kill
FLEET_RESUME = FLEET_KILL_STEP - FLEET_KILL_STEP % FLEET_CKPT_EVERY
FLEET_CFG = {"backend": "pallas"}
# (b): nls, whose transforms are all c2c, so the payload rides the 2x1
# grid's X<->Y fold and the 1x2 grid's Y<->Z roundtrip; heat's would ride
# neither (2x1: X<->Y is r2c, Y<->Z has one rank; 1x2: kx = 257 rows, a
# prime, cut in no slabs)
FLEET_GRID_CASE = "nls"
FLEET_GRID_CFG = {"backend": "pallas", "comm_engine": "pallas_ring",
                  "fused_roundtrip": True}
FLEET_WORKER = "--fleet-worker"
FLEET_ONLY = "--fleet-only"
FLEET_PLAIN = ("ref.calls", "fft_mxu.plain_calls", "fft_mxu")
RING_PLAIN = ("ref.calls", "payload_plain")


def _write_kernels(path, rc, prof, **extra):
    """The kernel wrappers' counts of this process and the kernels the
    profiler saw, as ``path``."""
    doc = {"rc": rc, "counts": {**_counts(), **_ring_counts()}, **extra,
           "kernels": [{"ms": ms, "count": c, "name": k[:120]}
                       for ms, c, k in _kernel_rows(prof)]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def _fleet_rank(ctx, spec, attempt, active):
    """The fleet worker's rank function (``repro_torch.fleet.worker.
    _rank_main``) under ``torch.profiler``, in each rank process of a
    ``--fleet-worker`` job of several ranks; writes
    ``<job>.attempt<A>.rank<r>.kernels.json``.  A killed rank writes
    nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import worker

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rc = worker._rank_main(ctx, spec, attempt, active)
        torch.cuda.synchronize(ctx.device)
    base = spec["result_path"][:-len(".result.json")]
    _write_kernels(f"{base}.attempt{attempt}.rank{ctx.rank}.kernels.json", rc, prof)
    return rc


def fleet_worker(argv) -> int:
    """``chip_smoke.py --fleet-worker --spec S --attempt A``: the
    controller's worker (``repro_torch.fleet.worker.main``) under
    ``torch.profiler``, its ranks' function wrapped by :func:`_fleet_rank`.
    Beside the attempt's spec it writes ``<job>.attempt<A>.kernels.json``:
    the kernel wrappers' counts of this process, the kernels the profiler
    saw, and the wall-clock times of this process's start, of the end of
    its imports and of the attempt's first progress line.  A killed 1x1
    attempt writes nothing."""
    import threading

    t_enter = time.time()
    sys.path.insert(0, SRC)
    spec_path = argv[argv.index("--spec") + 1]
    with open(spec_path) as f:
        spec = json.load(f)
    progress = spec["progress_path"]
    size0 = os.path.getsize(progress) if os.path.exists(progress) else 0
    first = []

    def watch():
        while not first:
            if os.path.exists(progress) and os.path.getsize(progress) > size0:
                first.append(time.time())
            time.sleep(0.005)

    threading.Thread(target=watch, daemon=True).start()
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fleet import worker

    t_imported = time.time()
    worker._rank_main = _fleet_rank
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rc = worker.main(argv)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    _write_kernels(spec_path.replace(".spec.json", ".kernels.json"), rc, prof,
                   enter_time=t_enter, imported_time=t_imported,
                   first_progress_time=first[0] if first else None)
    return rc


def _fleet_controller():
    from repro_torch.fleet import FleetController

    class Timed(FleetController):
        """The controller, noting the wall-clock time of every spawn."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.spawned = {}

        def _launch(self, att):
            t = time.time()
            run_ = super()._launch(att)
            self.spawned[(att.job.job_id, att.attempt)] = t
            return run_

    return Timed


def _campaign(tag, jobs, **kw):
    """One campaign under ``FLEET_DIR/tag``: (results, controller, wall s,
    {(job, attempt, rank or None): a worker's or rank's kernels document})."""
    import glob

    Timed = _fleet_controller()
    workdir = os.path.join(FLEET_DIR, tag)
    ctl = Timed(jobs, workdir=workdir, total_slots=2, ckpt_every=FLEET_CKPT_EVERY,
                keep=2, timeout_s=600,
                worker_argv=(sys.executable, os.path.abspath(__file__), FLEET_WORKER),
                **kw)
    t0 = time.perf_counter()
    results = ctl.run()
    wall = time.perf_counter() - t0
    docs = {}
    for path in glob.glob(os.path.join(workdir, "*.kernels.json")):
        jid, attempt, *rank = os.path.basename(path).split(".")[:-2]
        with open(path) as f:
            docs[(jid, int(attempt[len("attempt"):]),
                  int(rank[0][len("rank"):]) if rank else None)] = json.load(f)
    # the snapshots are 1 GiB a field: drop them once the campaign is read
    shutil.rmtree(os.path.join(workdir, "ckpt"), ignore_errors=True)
    return results, ctl, wall, docs


def _fleet_jobs(case="heat", mesh=(1, 1), cfg=FLEET_CFG, scales=FLEET_SCALES,
                prefix="job"):
    from repro_torch.fleet import FleetJob
    return [FleetJob(job_id=f"{prefix}{i}", case=case, n=FLEET_N,
                     steps=FLEET_STEPS, mesh=mesh, plan_cfg=dict(cfg), scale=s,
                     device="cuda")
            for i, s in enumerate(scales)]


def _fleet_solo(case, scale, cfg):
    """A solo in-process 1x1 run of a job: its history ``{step: obs}``, the
    ``fft_radix2`` launches of one step (every step the same) and the
    solver (for its ``validate()``)."""
    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.kernels import fft_radix2
    from repro_torch.serving.server import scaled_initial_fields
    from repro_torch.solvers import SolverState, make_solver

    solver = make_solver(case, PencilGrid.from_mesh(1, 1), FLEET_N, device="cuda",
                         dtype="float64", plan_cfg=dict(cfg))
    state = SolverState(fields=scaled_initial_fields(solver, scale))
    history = {0: solver.observables(state)}
    per_step = set()
    for i in range(1, FLEET_STEPS + 1):
        before = fft_radix2.launches
        state = solver.step(state)
        torch.cuda.synchronize()
        per_step.add(fft_radix2.launches - before)
        history[i] = solver.observables(state)
    del state
    torch.cuda.empty_cache()
    if len(per_step) != 1:
        fail(f"fleet: a solo {case} step launched fft_radix2 {sorted(per_step)} times")
    return history, per_step.pop(), solver


def _startups(ctl, docs, attempt):
    """Seconds from each spawn of ``attempt`` to its first progress line,
    and the part of it before the worker's imports had ended."""
    out = {}
    for (jid, a, rank), doc in sorted(docs.items(), key=str):
        if a == attempt and rank is None and doc.get("first_progress_time"):
            t = ctl.spawned[(jid, a)]
            out[jid] = {"first_line_s": round(doc["first_progress_time"] - t, 3),
                        "imports_s": round(doc["imported_time"] - t, 3)}
    return out


def _check_docs(tag, docs, need, plain, steps_of=None, per_step=0):
    """Every document's process launched each kernel of ``need`` (with
    ``steps_of``, ``fft_radix2`` exactly ``per_step`` times a step), no
    plain version, and the profiler, where it saw the card, saw each
    kernel; returns the launches of ``need`` summed."""
    total = dict.fromkeys(need, 0)
    for key, doc in sorted(docs.items(), key=str):
        c = doc["counts"]
        bad = any(c[k] == 0 for k in need) or any(c[k] for k in plain)
        if steps_of is not None:
            bad = bad or c["fft_radix2"] != steps_of(*key) * per_step
        names = " ".join(k["name"] for k in doc["kernels"])
        if bad or (names and any(f"{k}_kernel" not in names for k in need)):
            fail(f"fleet {tag} {key}: counts {c}, kernels seen "
                 f"{[k['name'][:60] for k in doc['kernels'][:10]]}"
                 + (f"; a solo step launches fft_radix2 {per_step} times"
                    if steps_of else ""))
        for k in need:
            total[k] += c[k]
    return total


def fleet(smi):
    """Phase 11: the fleet's kill-and-resume proof on the card; returns the
    results and the launches of rows 1, 3, 5 and 6."""
    import torch

    from repro_torch.fleet.records import KILL_EXIT
    from repro_torch.solvers.base import observables_rel_err

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    out = {}
    # (a) heat 1x1 on "pallas": clean, then every worker killed after step 3
    clean, cctl, clean_s, cdocs = _campaign("clean", _fleet_jobs())
    chaos, kctl, chaos_s, kdocs = _campaign("chaos", _fleet_jobs(), fault_spec=FLEET_KILL)
    solos = [_fleet_solo("heat", s, FLEET_CFG) for s in FLEET_SCALES]
    per_step = solos[0][1]
    for i, (hist, n, _) in enumerate(solos):
        c, k = clean[f"job{i}"], chaos[f"job{i}"]
        if n != per_step:
            fail(f"fleet: solo steps launch fft_radix2 {n} and {per_step} times")
        if not c.ok or c.attempts != 1 or c.history != hist:
            fail(f"fleet (a) clean job{i}: {c.status}, {c.attempts} attempt(s); "
                 f"history bitwise the solo run: {c.history == hist}")
        kinds = [(f.kind, f.exit_code) for f in k.failures]
        if not k.ok or k.attempts != 2 or kinds != [("crash", KILL_EXIT)]:
            fail(f"fleet (a) chaos job{i}: {k.status}, {k.attempts} attempts, "
                 f"failures {kinds}")
        if k.history != c.history:
            fail(f"fleet (a) chaos job{i}: history is not bitwise the clean one: "
                 f"{k.history} vs {c.history}")
        if not k.restore_latency_us > 0:
            fail(f"fleet (a) chaos job{i}: restore_latency_us {k.restore_latency_us}")
    del solos
    if kctl.counters["fleet.jobs.retried"] != 2 or kctl.counters["fleet.jobs.quarantined"]:
        fail(f"fleet (a) chaos counters {kctl.counters}")
    # every finished worker: the clean ones, the chaos retries (from step 2)
    finished = {("clean",) + k: v for k, v in cdocs.items()}
    finished.update({("chaos",) + k: v for k, v in kdocs.items() if k[1] == 1})
    if set(finished) != {(run, f"job{i}", int(run == "chaos"), None)
                         for run in ("clean", "chaos") for i in range(2)}:
        fail(f"fleet (a): worker documents {sorted(cdocs)} {sorted(kdocs)}")
    radix2 = _check_docs(
        "(a)", finished, ("fft_radix2",), FLEET_PLAIN,
        lambda run, *_: FLEET_STEPS - (FLEET_RESUME if run == "chaos" else 0),
        per_step)["fft_radix2"]
    out["a"] = {"clean": cctl.report(clean), "chaos": kctl.report(chaos),
                "clean_s": clean_s, "chaos_s": chaos_s,
                "startup": _startups(cctl, cdocs, 0),
                "resumed_first_line": _startups(kctl, kdocs, 1),
                "radix2_per_step": per_step, "radix2_launches": radix2}
    say(f"[{smi}] fleet (a) heat N={FLEET_N} f64 1x1 {FLEET_CFG}, 2 jobs x "
        f"{FLEET_STEPS} steps (scales {FLEET_SCALES}), ckpt every {FLEET_CKPT_EVERY}: "
        f"clean {clean_s:.3f} s, chaos ({FLEET_KILL}) {chaos_s:.3f} s, time to "
        f"recover {chaos_s - clean_s:.3f} s; restore_latency_us "
        f"{ {j: r.restore_latency_us for j, r in sorted(chaos.items())} }; "
        f"fleet.checkpoint.bytes clean {int(cctl.counters['fleet.checkpoint.bytes'])} "
        f"chaos {int(kctl.counters['fleet.checkpoint.bytes'])}; worker startup "
        f"(spawn to first progress line; to the end of its imports) "
        f"{out['a']['startup']}; resumed attempts' first line (restore and a step) "
        f"{out['a']['resumed_first_line']}")
    say(f"fleet (a): every job completed, each chaos job 2 attempts with one "
        f"crash (exit {KILL_EXIT}), retried 2, quarantined 0; histories bitwise "
        f"the clean ones and the clean ones bitwise a solo run; fft_radix2 "
        f"{per_step} launches a step in every finished worker ({radix2} in all), "
        f"no plain version")

    # (b) nls 2x1 on pallas_ring, fused: clean, then killed and resumed on 1x2
    ref, _, validator = _fleet_solo(FLEET_GRID_CASE, FLEET_SCALES[0], FLEET_GRID_CFG)
    jobs = _fleet_jobs(FLEET_GRID_CASE, (2, 1), FLEET_GRID_CFG, FLEET_SCALES[:1], "grid")
    gclean, gcctl, gclean_s, gcdocs = _campaign("grid_clean", jobs)
    gchaos, gkctl, gchaos_s, gkdocs = _campaign(
        "grid_chaos", jobs, fault_spec=FLEET_KILL, reshape_on_retry=((1, 2),))
    gc, gk = gclean["grid0"], gchaos["grid0"]
    with open(os.path.join(FLEET_DIR, "grid_chaos", "grid0.attempt1.spec.json")) as f:
        retry_mesh = json.load(f)["mesh"]
    kinds = [(f.kind, f.exit_code) for f in gk.failures]
    if not gc.ok or gc.attempts != 1 or not gk.ok or gk.attempts != 2 or \
            kinds != [("crash", KILL_EXIT)] or retry_mesh != [1, 2]:
        fail(f"fleet (b): clean {gc.status} in {gc.attempts} attempt(s), chaos "
             f"{gk.status} in {gk.attempts} attempts, failures {kinds}, the retry "
             f"on {retry_mesh}")
    errs = {}
    for step, want in ref.items():
        have = gk.history.get(step)
        if have is None or have["t"] != want["t"]:
            fail(f"fleet (b) step {step}: {have} vs the solo 1x1 run's {want}")
        errs[step] = observables_rel_err(have, want)
    if max(errs.values()) > 1e-10:
        fail(f"fleet (b): observables vs the solo 1x1 run {errs} > 1e-10")
    if any(gk.history[i] != gc.history[i] for i in range(FLEET_RESUME + 1)):
        fail("fleet (b): the steps before the kill are not bitwise the clean 2x1 run's")
    ok, lines = validator.validate([gk.history[i] for i in sorted(gk.history)])
    if not ok:
        fail(f"fleet (b): validate() failed: {lines}")
    del validator
    torch.cuda.empty_cache()
    # every rank of the finished attempts: the clean 2x1 run, the 1x2 retry
    ranks = {("clean",) + k: v for k, v in gcdocs.items() if k[2] is not None}
    ranks.update({("chaos",) + k: v for k, v in gkdocs.items() if k[2] is not None})
    if set(ranks) != {(run, "grid0", int(run == "chaos"), r)
                      for run in ("clean", "chaos") for r in range(2)}:
        fail(f"fleet (b): rank documents {sorted(ranks)}")
    ring = _check_docs("(b)", ranks, RING_KERNELS, RING_PLAIN)
    out["b"] = {"case": FLEET_GRID_CASE, "clean": gcctl.report(gclean),
                "chaos": gkctl.report(gchaos), "clean_s": gclean_s,
                "chaos_s": gchaos_s, "obs_rel_err": errs,
                "startup": _startups(gcctl, gcdocs, 0),
                "resumed_first_line": _startups(gkctl, gkdocs, 1),
                "rank_counts": {"/".join(map(str, k)): v["counts"]
                                for k, v in sorted(ranks.items())}}
    say(f"[{smi}] fleet (b) {FLEET_GRID_CASE} N={FLEET_N} f64 2x1 {FLEET_GRID_CFG}, "
        f"1 job: clean {gclean_s:.3f} s, chaos ({FLEET_KILL}, retried on 1x2) "
        f"{gchaos_s:.3f} s, time to recover {gchaos_s - gclean_s:.3f} s; "
        f"restore_latency_us {gk.restore_latency_us}; fleet.checkpoint.bytes clean "
        f"{int(gcctl.counters['fleet.checkpoint.bytes'])} chaos "
        f"{int(gkctl.counters['fleet.checkpoint.bytes'])}; worker startup (spawn "
        f"to first progress line, 2 ranks; to the end of the worker's imports) "
        f"{out['b']['startup']}; the 1x2 retry's first line (2 ranks, restore "
        f"and a step) {out['b']['resumed_first_line']}")
    say(f"fleet (b): completed on 1x2, every step within {max(errs.values()):.3e} "
        f"of the solo 1x1 run (steps 0-{FLEET_RESUME} bitwise the clean 2x1 "
        f"run's), validate() passing; every rank of the clean 2x1 attempt and "
        f"of the 1x2 retry launched {', '.join(RING_KERNELS)} ({ring} in all), "
        f"no plain version; counts (run, job, attempt, rank) "
        f"{out['b']['rank_counts']}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] fleet: phase 11 in {out['phase_s']:.3f} s")
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    return out, {"fft_radix2": radix2, **ring}


# ---------------------------------------------------------------------------
# phase 12: training (repro_torch.launch.train) at smollm-360m's full width
# ---------------------------------------------------------------------------

# launch/train.py's defaults: smollm-360m (32 layers, d 960), bf16 compute,
# f32 params and moments, remat, B=8, S=512
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 12
# (c): the halted run saves at steps 0 and 6 (every 6) and stops after 7;
# the resumed run restarts at 7 and saves at 11, its last step
TRAIN_HALT, TRAIN_CKPT_EVERY = 7, 6
TRAIN_RESUME_TOL = 1e-4
TRAIN_DIR = os.path.join(HERE, "build", "chip_smoke_train")
# (a): the kernel path against the plain attention through the whole model
# at step 0: per gradient leaf ||g_kernel - g_plain|| <= tol·||g_plain||,
# every wq/wk/wv gradient nonzero, the losses within TRAIN_LOSS_TOL
# relative; the same gate must refuse the kernel's output detached from q,
# k and v (the fault this slice repaired: no gradient reaches wq, wk, wv).
# The tolerances are about 3-4x the largest gaps measured on the H100:
# 1.48e-2 in bf16 (one-unit differences of the attention's bf16 output and
# gradients, through 32 layers) and 2.45e-6 in f32
TRAIN_GRAD_TOL = {"bfloat16": 5e-2, "float32": 1e-5}
TRAIN_LOSS_TOL = 3e-2
# (d): steps timed after the first
TRAIN_TIMED = 5
TRAIN_ONLY = "--train-only"


def _train_grads(cfg, run, model, tokens):
    """(loss, {name: gradient}) of ``lm_loss`` at ``model``'s parameters;
    a parameter the loss does not reach gets a zero gradient."""
    import torch

    from repro_torch.models import transformer as T

    model.requires_grad_(True)
    loss = T.lm_loss(cfg, run, model, {"tokens": tokens})
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.item(), dict(zip(names, grads))


def _check_grads(label, got, want, loss, loss_want, tol):
    """(a)'s gate on the gradients ``got`` against ``want``: every leaf
    finite and within ``tol`` (||d|| over ||want||), every wq/wk/wv
    gradient nonzero, the losses within TRAIN_LOSS_TOL relative.  Prints
    the gaps; returns (passes, record)."""
    import torch

    gaps = {}
    for name, w in want.items():
        d = got[name].float() - w.float()
        gaps[name] = ((d.norm() / w.float().norm().clamp_min(1e-30)).item(),
                      (d.abs().max() / w.float().abs().max().clamp_min(1e-30)).item())
    worst = max(gaps, key=lambda n: gaps[n][0])
    qkv = [n for n in got if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")]
    zero = [n for n in qkv if not bool(got[n].abs().max() > 0)]
    finite = all(bool(torch.isfinite(g).all()) for g in got.values())
    loss_gap = abs(loss - loss_want) / abs(loss_want)
    ok = finite and gaps[worst][0] <= tol and not zero and loss_gap <= TRAIN_LOSS_TOL
    qkv_gap = max(gaps[n][0] for n in qkv)
    say(f"training (a) {label}: loss {loss:.6f} against the plain attention's "
        f"{loss_want:.6f} ({loss_gap:.3e} relative, tol {TRAIN_LOSS_TOL:g}); "
        f"gradient leaves ||d||/||g|| max {gaps[worst][0]:.3e} at {worst} "
        f"(max|d|/max|g| {gaps[worst][1]:.3e}), wq/wk/wv max {qkv_gap:.3e} "
        f"(tol {tol:g}); {len(zero)} of {len(qkv)} wq/wk/wv gradients zero: "
        f"{'passes' if ok else 'refused'}")
    return ok, {"loss": loss, "loss_plain": loss_want, "loss_gap": loss_gap,
                "worst_leaf": worst, "worst_norm_gap": gaps[worst][0],
                "worst_max_gap": gaps[worst][1], "qkv_norm_gap": qkv_gap,
                "max_gap": max(g[1] for g in gaps.values()),
                "zero_qkv": len(zero), "finite": finite, "tol": tol, "ok": ok}


def _train_grad_checks(cfg):
    """Phase 12 (a): step 0's gradients through the repaired kernel path
    against the plain attention's (``RunCfg(plain_attention=True)``), in
    bf16 as configured and in f32, the kernel launched once a block
    forward and no plain call; then the control with the kernel's output
    detached, which the bf16 gate must refuse."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels import attention
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    model = T.init_model(cfg, seed=0, device="cuda")
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH))
    tokens = torch.from_numpy(pipe.batch_for_step(0)["tokens"]).cuda()
    run, plain = T.RunCfg(), T.RunCfg(plain_attention=True)
    out, kept = {}, {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        attention.launches = attention.plain_calls = 0
        loss, got = _train_grads(c, run, model, tokens)
        counts = [attention.launches, attention.plain_calls]
        loss_p, want = _train_grads(c, plain, model, tokens)
        ok, out[dtype] = _check_grads(dtype, got, want, loss, loss_p,
                                      TRAIN_GRAD_TOL[dtype])
        out[dtype]["counts"] = counts
        if counts != [T.block_forwards(c, run), 0]:
            fail(f"training (a) {dtype}: the kernel path made {counts} launches "
                 f"and plain calls, want [{T.block_forwards(c, run)}, 0]")
        if not ok:
            fail(f"training (a) {dtype}: the kernel path's gradients fail the gate")
        if dtype == "bfloat16":
            kept = {"want": want, "loss": loss_p}
        del got, want
    detached = L.flash_attention
    L.flash_attention = lambda q, k, v, causal: attention._kernel_forward(q, k, v, causal)
    try:
        loss, got = _train_grads(cfg, run, model, tokens)
    finally:
        L.flash_attention = detached
    ok, out["detached_control"] = _check_grads(
        "control, output detached", got, kept["want"], loss, kept["loss"],
        TRAIN_GRAD_TOL["bfloat16"])
    if ok:
        fail("training (a): the gradient gate accepted the detached output")
    del model, got, kept
    torch.cuda.empty_cache()
    return out


def _train_argv(*extra):
    return ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1", *extra]


def _step_losses(stdout):
    """{step: loss} of the ``step N loss ...`` lines."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("step"):
            parts = line.split()
            out[int(parts[1])] = float(parts[3])
    return out


def _train_resume(cfg, ref):
    """Phase 12 (c): ``launch/train.py`` halted after step TRAIN_HALT - 1 in
    this process (checkpoints at steps 0 and 6), the latest checkpoint
    restored here on the clock, then the run resumed in a fresh process;
    the resumed losses within TRAIN_RESUME_TOL of the uninterrupted
    run's ``ref``."""
    import torch

    from repro_torch import obs
    from repro_torch.checkpoint.checkpoint import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    ck = ["--ckpt-dir", TRAIN_DIR, "--ckpt-every", str(TRAIN_CKPT_EVERY)]
    obs.enable()
    obs.clear()
    t0 = time.perf_counter()
    halted = train.main(_train_argv(*ck, "--halt-after", str(TRAIN_HALT)))
    halted_s = time.perf_counter() - t0
    saved = {k: obs.metrics.get(k) for k in ("checkpoint.saves", "checkpoint.bytes",
                                             "checkpoint.snapshot_us",
                                             "checkpoint.write_us")}
    obs.disable()
    latest = CheckpointManager(TRAIN_DIR).latest_step()
    model = T.init_model(cfg, seed=1, device="cuda")
    acfg = adamw.AdamWConfig(moment_dtype=cfg.opt_state_dtype)
    opt = adamw.init(acfg, dict(model.named_parameters()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    meta = train.restore_train_state(CheckpointManager(TRAIN_DIR), model, opt)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del model, opt
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=SRC)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        *_train_argv(*ck)], env=env, cwd=HERE, capture_output=True,
                       text=True, timeout=600)
    resume_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"training (c): the resumed run exited {r.returncode}: {r.stderr[-2000:]}")
    got = _step_losses(r.stdout)
    resumed_from = TRAIN_HALT - 1 - (TRAIN_HALT - 1) % TRAIN_CKPT_EVERY
    gaps = {s: abs(got[s] - ref[s]) for s in got}
    worst = max(gaps[s] for s in range(8, TRAIN_STEPS))
    # the lines print 4 decimals, so a gap below 5e-5 may be their rounding
    as_printed = all(f"{got[s]:.4f}" == f"{ref[s]:.4f}" for s in got)
    halted_same = halted == [ref[s] for s in range(TRAIN_HALT)]
    out = {"halted_losses": halted, "halted_s": halted_s, "latest": latest,
           "saved": saved, "restore_s": restore_s, "restored_step": meta["step"],
           "resume_s": resume_s, "resumed_losses": got, "gaps": gaps,
           "worst_gap_8_11": worst, "tol": TRAIN_RESUME_TOL,
           "equal_as_printed": as_printed, "halted_bitwise": halted_same}
    say(f"training (c) kill and resume: halted after step {TRAIN_HALT - 1} in "
        f"{halted_s:.3f} s ({int(saved['checkpoint.saves'])} saves, "
        f"{int(saved['checkpoint.bytes'])} B; the last one's snapshot "
        f"{saved['checkpoint.snapshot_us'] / 1e6:.3f} s, write "
        f"{saved['checkpoint.write_us'] / 1e6:.3f} s); latest checkpoint step "
        f"{latest} restored onto the card in {restore_s:.3f} s; resumed in a fresh "
        f"process in {resume_s:.3f} s; steps 8-11 within {worst:.3e} of the "
        f"uninterrupted run (tol {TRAIN_RESUME_TOL:g}); every gap "
        f"{ {s: f'{g:.2e}' for s, g in sorted(gaps.items())} }, the resumed "
        f"losses {'equal' if as_printed else 'NOT equal'} to the uninterrupted "
        f"run's at the 4 decimals the lines print; the halted run's losses at "
        f"steps 0-{TRAIN_HALT - 1} {'bitwise' if halted_same else 'NOT bitwise'} "
        f"(b)'s")
    if f"[resume] from step {resumed_from}" not in r.stdout:
        fail(f"training (c): no '[resume] from step {resumed_from}' in the resumed "
             f"run's output: {r.stdout[-1500:]}")
    if sorted(got) != list(range(resumed_from + 1, TRAIN_STEPS)) or \
            not worst <= TRAIN_RESUME_TOL:
        fail(f"training (c): resumed losses {got} against {ref}")
    if saved["checkpoint.saves"] != 2 or len(halted) != TRAIN_HALT:
        fail(f"training (c): the halted run saved {saved['checkpoint.saves']} times "
             f"and ran {len(halted)} steps")
    return out  # its step-6 checkpoint stays for phase 13 (b)


# the params' change ||p_n - p_0|| is read after these step counts (phase
# 12 (d) on one device; phase 13 (a), (c) and the controls on a mesh)
MOVED_AFTER = (3, 6)


def _host_copy(model) -> dict:
    """The model's parameters (this rank's shards), copied to the host."""
    return {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}


def _moved_parts(model, start: dict) -> dict:
    """Each leaf's ||param - start|| (this rank's shard), f32, one leaf at
    a time; no collective, so that the step's counts hold none."""
    import torch

    params = dict(model.named_parameters())
    return {n: torch.linalg.vector_norm(params[n].detach().float()
                                        - s.to(params[n].device).float())
            for n, s in start.items()}


def _moved(parts: dict, cut: dict | None = None) -> float:
    """||params - start|| over every leaf from :func:`_moved_parts`; on a
    mesh (``cut``: each leaf's cut axes) each leaf's square summed over
    the ranks it is cut over, a whole leaf counted once (collective)."""
    from repro_torch.optim import adamw

    names = list(parts)
    return float(adamw.global_norm([parts[n] for n in names],
                                   None if cut is None else [cut[n] for n in names]))


def _train_measure(smi, cfg):
    """Phase 12 (d): ms/step on the host clock around each synchronised
    step (the first apart), tokens/s, peak memory; one step under
    ``torch.profiler``; the attention's forward and backward at the
    training shape, kernel and ``attention_grad`` against SDPA's."""
    import statistics

    import torch
    import torch.nn.functional as F

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels import attention
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import TrainCfg, make_train_step

    model = T.init_model(cfg, seed=0, device="cuda")
    acfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS,
                             warmup_steps=max(TRAIN_STEPS // 20, 5),
                             moment_dtype=cfg.opt_state_dtype)
    opt = adamw.init(acfg, dict(model.named_parameters()))
    step = make_train_step(cfg, T.RunCfg(remat=cfg.remat), TrainCfg(adamw=acfg))
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH))
    start = _host_copy(model)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, gnorms, moved = [], [], [], {}
    for i in range(TRAIN_TIMED + 1):
        batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_for_step(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(model, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if i + 1 in MOVED_AFTER:
            moved[i + 1] = _moved(_moved_parts(model, start))
    peak = torch.cuda.max_memory_allocated()
    ms = statistics.median(times[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    prof = _profile(lambda: step(model, opt, batch),
                    f"training step {TRAIN_ARCH} B={TRAIN_BATCH} S={TRAIN_SEQ}", top=12)
    del model, opt
    torch.cuda.empty_cache()
    # the attention alone at the training shape, forward and backward
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, s, h, hkv, d = TRAIN_BATCH, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = _rand((b, s, h, d), torch.float32, gen).bfloat16().requires_grad_()
    k = _rand((b, s, hkv, d), torch.float32, gen).bfloat16().requires_grad_()
    v = _rand((b, s, hkv, d), torch.float32, gen).bfloat16().requires_grad_()
    do = _rand((b, s, h, d), torch.float32, gen).bfloat16()
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_() for x in (q, k, v))
    attn = {
        "kernel_fwd_bwd_ms": _time_ms(lambda: attention.flash_attention(
            q, k, v).backward(do), 10, 2),
        "attention_grad_ms": _time_ms(lambda: attention.attention_grad(
            q.detach(), k.detach(), v.detach(), do), 10, 2),
        "sdpa_fwd_bwd_ms": _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True).backward(do.transpose(1, 2)),
            10, 2)}
    del q, k, v, do, qt, kt, vt
    torch.cuda.empty_cache()
    out = {"ms_per_step": ms, "step_ms": times, "first_step_ms": times[0],
           "tokens_per_s": tokens / (ms / 1e3), "peak_bytes": peak,
           "losses": losses, "gnorms": gnorms, "moved": moved, "breakdown": prof,
           "attention": attn}
    say(f"[{smi}] training {TRAIN_ARCH} bf16 remat B={TRAIN_BATCH} S={TRAIN_SEQ}: "
        f"{ms:.3f} ms/step (median of {TRAIN_TIMED}; "
        f"{', '.join(f'{t:.3f}' for t in times[1:])}; first {times[0]:.3f}), "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {peak / 2**30:.3f} GiB; the params' "
        f"change ||p_n - p_0|| after n steps {moved}")
    for line in prof["lines"]:
        say(line)
    say(f"[{smi}] training attention B={b} S={s} H={h} Hkv={hkv} D={d} bf16 causal, "
        f"forward and backward: kernel + attention_grad {attn['kernel_fwd_bwd_ms']:.4f} ms "
        f"(attention_grad alone {attn['attention_grad_ms']:.4f}), SDPA "
        f"{attn['sdpa_fwd_bwd_ms']:.4f} ms")
    return out


def training(smi):
    """Phase 12: training of smollm-360m at full width and depth on the
    card; returns the results and (b)'s ``flash_attention`` launches."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels import attention
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    out = {"grads": _train_grad_checks(cfg)}
    # (b) 12 steps through launch/train.py's main, counts from 0
    attention.launches = attention.plain_calls = attention.pad_copies = 0
    t0 = time.perf_counter()
    losses = train.main(_train_argv())
    wall = time.perf_counter() - t0
    counts = {"flash_attention": attention.launches,
              "flash_attention_plain": attention.plain_calls,
              "pad_copies": attention.pad_copies}
    per_step = T.block_forwards(cfg, T.RunCfg(remat=cfg.remat))
    want = TRAIN_STEPS * per_step
    out["train"] = {"losses": losses, "wall_s": wall, "counts": counts,
                    "launches_per_step": per_step}
    say(f"training (b) {TRAIN_ARCH} {TRAIN_STEPS} steps through launch/train.py: "
        f"{wall:.3f} s, losses {losses[0]:.4f} -> {losses[-1]:.4f}, counts {counts} "
        f"(want {want}: {TRAIN_STEPS} steps x {per_step} block forwards, "
        f"{cfg.n_layers} layers with two-level remat)")
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        fail(f"training (b): losses {losses}")
    if counts != {"flash_attention": want, "flash_attention_plain": 0, "pad_copies": 0}:
        fail(f"training (b): counts {counts}, want {want} launches, no plain call, "
             "no pad copy")
    out["resume"] = _train_resume(cfg, dict(enumerate(losses)))
    out["measure"] = _train_measure(smi, cfg)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] training: phase 12 in {out['phase_s']:.3f} s")
    return out, counts["flash_attention"]


# ---------------------------------------------------------------------------
# phase 13: the dense decoders sharded over 4 rank processes (FSDP x TP)
# ---------------------------------------------------------------------------

# (a) phase 12's model, seed and data on a 2x2 mesh, SHARD_STEPS steps
# against phase 12 (d)'s 1x1 steps; (b) launch/train.py on 2x2: a run that
# saves at steps 0 and 3 and halts after 4 (resumed on 1x1 here for steps
# 4-5), and phase 12's step-6 checkpoint resumed on 2x2 for steps 7-8;
# (c) (pod 2, data 1, model 2), SHARD_COMP_STEPS compressed steps;
# (d) phase 8's serving on 2x2, teacher-forced with phase 8's tokens;
# (e) two controls that the gates of (a) and (c) must refuse: (a) with the
# update left out (lr 0, SHARD_COMP_STEPS steps) and (c) with the pod sync
# left out (each pod steps on its own rows' gradients)
SHARD_STEPS, SHARD_COMP_STEPS = 6, 3
SHARD_MESH = {"data": 2, "model": 2}
SHARD_COMP_MESH = {"pod": 2, "data": 1, "model": 2}
SHARD_DIR = os.path.join(HERE, "build", "chip_smoke_sharded")
# The gates, relative to the run compared with, each set between the sound
# readings and the controls' of (e) on the H100 (PERF.md, phase 13):
# a step's loss and gnorm on 2x2 against 1x1 in bf16 (the row-parallel sums
# and the FSDP reduce-scatter add bf16 activations and f32 gradients in
# another order than one device's GEMMs; sound at most 2.6e-5 and 3.6e-4,
# the run that leaves the params unchanged 1.2e-4 and 1.8e-3), also the
# loss after a resume across grids
SHARD_LOSS_TOL, SHARD_GNORM_TOL = 6e-5, 1e-3
# the params' change ||p_n - p_0|| after MOVED_AFTER steps, 2x2 against 1x1
# (sound 1.7e-6; unchanged params 1)
SHARD_MOVED_TOL = 1e-4
# (c) against (a)'s uncompressed steps: the int8 levels move the gnorm by
# up to 3e-3, each pod's own gradient (no pod sync) by 0.36 to 0.47; the
# loss of either stays within 2.1e-4 (no gate between them: the pods'
# params must also agree bitwise)
SHARD_COMP_LOSS_TOL, SHARD_COMP_GNORM_TOL = 2e-3, 3e-2
LM_ONLY = "--lm-only"


def _shard_counts():
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import attention, ring_rdma

    return {"flash_attention": attention.launches,
            "flash_attention_plain": attention.plain_calls,
            "pad_copies": attention.pad_copies, "ring_send": ring_rdma.send_launches,
            "ring_land": ring_rdma.land_launches, "wire_bytes": C.wire_bytes,
            **{f"collectives.{k}": n for k, n in C.calls.items()}}


def _zero_shard_counts():
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import attention, ring_rdma

    attention.launches = attention.plain_calls = attention.pad_copies = 0
    ring_rdma.send_launches = ring_rdma.land_launches = 0
    C.wire_bytes = 0
    for k in C.calls:
        C.calls[k] = 0


def _shard_steps(ctx, cfg, steps, *, lr=None, compressed=False, profile=False):
    """``steps`` steps of phase 12's model on this rank's mesh (the
    compressed step with ``compressed``), each synchronised and timed,
    from counts set to 0; the counts, the peak, the params' change after
    MOVED_AFTER steps; with ``profile`` one more step under
    ``torch.profiler`` on rank 0.  ``lr`` overrides the learning rate (0:
    the update left out)."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed import compression as comp
    from repro_torch.launch import mesh as M
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import TrainCfg, cut_axes, make_train_step

    run, model, _ = M.rank_setup(cfg, ctx, None, remat=cfg.remat)
    acfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS,
                             warmup_steps=max(TRAIN_STEPS // 20, 5),
                             moment_dtype=cfg.opt_state_dtype)
    if lr is not None:
        acfg = dataclasses.replace(acfg, lr=lr)
    opt = adamw.init(acfg, dict(model.named_parameters()))
    step = make_train_step(cfg, run, TrainCfg(adamw=acfg, grad_compression=compressed))
    res = comp.init_residuals(dict(model.named_parameters())) if compressed else None
    cut = cut_axes(cfg, run)
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH))
    start = _host_copy(model)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_shard_counts()
    times, losses, gnorms, moved = [], [], [], {}
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_for_step(i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if compressed:
            _, metrics, res = step(model, opt, res, batch)
        else:
            _, metrics = step(model, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        if i + 1 in MOVED_AFTER:
            moved[i + 1] = _moved_parts(model, start)
    out = {"step_ms": times, "losses": losses, "gnorms": gnorms,
           "counts": _shard_counts(), "peak_bytes": torch.cuda.max_memory_allocated(),
           "breakdown": None}
    out["moved"] = {n: _moved(parts, cut) for n, parts in moved.items()}
    if compressed:
        out["max_residual"] = _mesh_max(run, [r.abs().max() for r in res.values()])
        out["pods_apart"] = _pods_apart(model)
    if profile:
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in pipe.batch_for_step(steps).items()}
        if ctx.rank == 0:
            out["breakdown"] = _profile(
                lambda: step(model, opt, batch),
                f"sharded training step 2x2 rank 0 B={TRAIN_BATCH} S={TRAIN_SEQ}", top=10)
        else:
            step(model, opt, batch)
    torch.cuda.synchronize()
    del model, opt, res
    torch.cuda.empty_cache()
    return out


def _mesh_max(run, xs) -> float:
    """The largest of ``xs`` (scalars on the card) over every rank."""
    import torch

    from repro_torch.distributed import collectives as C

    mx = torch.stack(xs).max()
    return float(C.all_reduce(mx, tuple(run.mesh.shape), "max"))


def _pods_apart(model) -> float:
    """How far the two pods' parameters lie apart: the largest gap, over
    the mesh, between the pods' per-leaf f64 sums and sums of squares (0
    when each rank holds the same bits as its peer in the other pod)."""
    import torch

    from repro_torch.distributed import collectives as C

    fp = torch.stack([torch.stack([p.detach().double().sum(),
                                   p.detach().double().square().sum()])
                      for p in model.parameters()]).flatten()
    both = C.all_gather(fp[None], "pod", 0)
    gap = (both[0] - both[1]).abs().max()
    return float(C.all_reduce(gap, ("pod", "data", "model"), "max"))


def _shard_launch(ctx, argv):
    """launch/train.py's run of ``argv`` as this rank; (losses, wall s)."""
    from repro_torch.launch import train

    t0 = time.perf_counter()
    losses = train.train(train.parse_args(argv), ctx)
    return {"losses": losses, "wall_s": time.perf_counter() - t0}


def _shard_compressed_unsynced(ctx, cfg):
    """(e)'s control of (c): the compressed step with the pod sync left
    out, so that each pod steps on the gradients of its own rows."""
    from repro_torch.distributed import compression as comp

    synced = comp.pod_sync_compressed
    comp.pod_sync_compressed = lambda grads, residuals, *a, **k: (grads, residuals)
    try:
        return _shard_steps(ctx, cfg, SHARD_COMP_STEPS, compressed=True)
    finally:
        comp.pod_sync_compressed = synced


def _shard_serve(ctx, cfg, forced):
    """(d): phase 8's prompts on 2x2, teacher-forced with phase 8's
    tokens; rank 0 keeps the gathered logits."""
    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve

    run, model, _ = M.rank_setup(cfg, ctx, None)
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, ctx.device)
    serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_shard_counts()
    r = serve.generate(cfg, run, model, tokens, LM_GEN,
                       forced=torch.from_numpy(forced).to(ctx.device), keep_logits=True)
    counts = _shard_counts()
    out = {"prefill_ms": r["prefill_ms"], "decode_ms": r["decode_ms"],
           "counts": counts, "peak_bytes": torch.cuda.max_memory_allocated(),
           "cache_shape": list(r["cache"]["k"].shape)}
    if ctx.rank == 0:  # numpy: a rank's result crosses to the parent pickled
        out["tokens"] = r["tokens"].cpu().numpy()
        out["logits"] = [x.float().cpu().numpy() for x in r["logits"]]
    del model, r
    torch.cuda.empty_cache()
    return out


def _sharded_ranks(ctx, forced):
    """Everything phase 13's 4 rank processes do, (a) to (e)."""
    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ring_rdma
    from repro_torch.launch import mesh as M

    cfg = get_config(TRAIN_ARCH)
    out = {"rank": ctx.rank, "train": _shard_steps(ctx, cfg, SHARD_STEPS, profile=True)}
    ck = ["--ckpt-dir"]
    _zero_shard_counts()
    out["writes"] = _shard_launch(ctx, _train_argv(
        "--mesh", "2x2", *ck, os.path.join(SHARD_DIR, "2x2"), "--ckpt-every", "3",
        "--halt-after", "4"))
    out["from_1x1"] = _shard_launch(ctx, _train_argv(
        "--mesh", "2x2", *ck, os.path.join(SHARD_DIR, "1x1"), "--halt-after",
        str(TRAIN_CKPT_EVERY + 3)))
    out["launch_counts"] = _shard_counts()
    out["control_update"] = _shard_steps(ctx, cfg, SHARD_COMP_STEPS, lr=0.0)
    wires = dict(ctx.wires())
    ctx = M.regrid_mesh(SHARD_COMP_MESH)
    out["compressed"] = _shard_steps(ctx, cfg, SHARD_COMP_STEPS, compressed=True)
    out["control_sync"] = _shard_compressed_unsynced(ctx, cfg)
    wires.update({("pod2",) + k: w for k, w in ctx.wires().items()})
    ctx = M.regrid_mesh(SHARD_MESH)
    out["serve"] = _shard_serve(ctx, cfg, forced)
    wires.update({("serve",) + k: w for k, w in ctx.wires().items()})
    out["wires"] = sorted(f"{k}: {type(w).__name__}" for k, w in wires.items())
    out["wires_ipc"] = all(isinstance(w, ring_rdma.IpcWire) for w in wires.values())
    out["backend"] = tdist.get_backend()
    return out


def _gaps(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def _moved_gaps(got: dict, want: dict) -> dict:
    """The params' change against another run's, relative, after each
    step count both read."""
    return {n: abs(got[n] - want[n]) / want[n] for n in got if n in want}


def _step_faults(label, run, ref, loss_tol, gnorm_tol, moved_tol=None) -> list:
    """What the gates of a run of steps refuse against ``ref``'s steps:
    each step's loss and gnorm within their tolerances (relative), and the
    params' change within ``moved_tol`` (None: not gated)."""
    import math

    n = len(run["losses"])
    loss = _gaps(run["losses"], ref["losses"][:n])
    gnorm = _gaps(run["gnorms"], ref["gnorms"][:n])
    moved = _moved_gaps(run["moved"], ref["moved"])
    bad = []
    if not all(math.isfinite(x) for x in run["losses"] + run["gnorms"]):
        bad.append(f"{label}: a loss or gnorm not finite")
    if max(loss) > loss_tol:
        bad.append(f"{label}: loss gaps {[f'{g:.2e}' for g in loss]} > {loss_tol:g}")
    if max(gnorm) > gnorm_tol:
        bad.append(f"{label}: gnorm gaps {[f'{g:.2e}' for g in gnorm]} > {gnorm_tol:g}")
    if moved_tol is not None and (not moved or max(moved.values()) > moved_tol):
        bad.append(f"{label}: params' change gaps {moved} > {moved_tol:g}")
    return bad


def _steps_line(label, run, ref, ref_label) -> str:
    loss = _gaps(run["losses"], ref["losses"])
    gnorm = _gaps(run["gnorms"], ref["gnorms"])
    moved = _moved_gaps(run["moved"], ref["moved"])
    return (f"{label}: losses {[round(x, 6) for x in run['losses']]} against {ref_label} "
            f"{[round(x, 6) for x in ref['losses'][:len(loss)]]}: gaps "
            f"{[f'{g:.2e}' for g in loss]}; gnorm gaps {[f'{g:.2e}' for g in gnorm]}; "
            f"the params' change after n steps "
            f"{ {n: f'{v:.6e}' for n, v in run['moved'].items()} } against "
            f"{ {n: f'{v:.6e}' for n, v in ref['moved'].items()} }: gaps "
            f"{ {n: f'{g:.2e}' for n, g in moved.items()} }")


def sharded_lm(smi, trained, served):
    """Phase 13: smollm-360m at full width sharded over a 2x2 mesh of rank
    processes on the one card (one spawn, re-cut between meshes), against
    phases 12 and 8; returns the results and the kernels' launches summed
    over the ranks.  Every reading is printed before the gates fail."""
    import torch

    from repro_torch import dist
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    ref = trained["measure"]
    full_losses = dict(enumerate(trained["train"]["losses"]))
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    # phase 12's step-6 checkpoint, alone in a directory of its own
    one = os.path.join(SHARD_DIR, "1x1")
    os.makedirs(one)
    step6 = f"step_{TRAIN_CKPT_EVERY:08d}"
    os.symlink(os.path.join(TRAIN_DIR, step6), os.path.join(one, step6))
    with open(os.path.join(one, "LATEST"), "w") as f:
        f.write(step6)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dist.run_ranks(_sharded_ranks, 2, 2, device="cuda",
                           args=(served["tokens"].numpy(),), timeout=1200)
    spawn_s = time.perf_counter() - t0
    # (b) the 2x2 run's step-3 checkpoint resumed on one device, steps 4-5
    t0 = time.perf_counter()
    resumed = train.main(_train_argv("--ckpt-dir", os.path.join(SHARD_DIR, "2x2"),
                                     "--halt-after", "6"))
    resume_1x1_s = time.perf_counter() - t0
    out = {"spawn_s": spawn_s, "ranks": ranks, "resume_1x1": resumed,
           "resume_1x1_s": resume_1x1_s}
    bad = []
    r0 = ranks[0]
    a = r0["train"]
    loss_gaps, gnorm_gaps = _gaps(a["losses"], ref["losses"]), _gaps(a["gnorms"], ref["gnorms"])
    ms = sorted(a["step_ms"][1:])[len(a["step_ms"][1:]) // 2]
    per_step = {k: v / SHARD_STEPS for k, v in a["counts"].items()}
    limit = ref["peak_bytes"]
    peaks = [r["train"]["peak_bytes"] for r in ranks]
    say(f"[{smi}] sharded LM (a) {TRAIN_ARCH} 2x2 (4 ranks on one card) bf16 remat "
        f"B={TRAIN_BATCH} S={TRAIN_SEQ}: {ms:.3f} ms/step on rank 0 (median of "
        f"{SHARD_STEPS - 1}; {', '.join(f'{t:.3f}' for t in a['step_ms'])}); "
        + _steps_line("against 1x1", a, ref, "1x1")
        + f" (tol loss {SHARD_LOSS_TOL:g}, gnorm {SHARD_GNORM_TOL:g}, change "
        f"{SHARD_MOVED_TOL:g}); peak GiB by rank {[round(p / 2**30, 3) for p in peaks]} "
        f"against 1x1's {limit / 2**30:.3f}")
    say(f"[{smi}] sharded LM (a) a step on rank 0: flash_attention "
        f"{per_step['flash_attention']:g} launches ({per_step['flash_attention_plain']:g} "
        f"plain, {per_step['pad_copies']:g} pad copies), ring_send "
        f"{per_step['ring_send']:g}, ring_land {per_step['ring_land']:g}, wire bytes "
        f"{per_step['wire_bytes']:.0f}, collectives "
        f"{ {k: v for k, v in per_step.items() if k.startswith('collectives.')} }")
    if a["breakdown"]:
        for line in a["breakdown"]["lines"]:
            say(line)
    cfg = get_config(TRAIN_ARCH)
    want_flash = T.block_forwards(cfg, T.RunCfg(remat=cfg.remat))
    for r in ranks:
        c = r["train"]["counts"]
        if c["flash_attention"] != SHARD_STEPS * want_flash or c["flash_attention_plain"] \
                or c["pad_copies"]:
            bad.append(f"(a) rank {r['rank']}: counts {c}, want {SHARD_STEPS * want_flash} "
                       "flash launches, no plain call, no pad copy")
        if not (c["ring_send"] > 0 and c["ring_land"] > 0):
            bad.append(f"(a) rank {r['rank']}: the collectives made no wire copy: {c}")
        if not r["wires_ipc"] or r["backend"] != "gloo":
            bad.append(f"rank {r['rank']}: wires {r['wires']}, default group "
                       f"{r['backend']}: a CUDA tensor's collective off the peer-mapped wire")
    if max(peaks) >= limit:
        bad.append(f"(a): a rank peaked at {max(peaks) / 2**30:.3f} GiB, not below 1x1's "
                   f"{limit / 2**30:.3f}")
    bad += _step_faults("(a)", a, ref, SHARD_LOSS_TOL, SHARD_GNORM_TOL, SHARD_MOVED_TOL)
    # (b)
    w, f1 = r0["writes"], r0["from_1x1"]
    b_gaps = {"2x2 steps 0-3": _gaps(w["losses"], [full_losses[s] for s in range(4)]),
              "1x1 from the 2x2 checkpoint, steps 4-5": _gaps(
                  resumed, [full_losses[s] for s in (4, 5)]),
              "2x2 from the 1x1 checkpoint, steps 7-8": _gaps(
                  f1["losses"], [full_losses[s] for s in (7, 8)])}
    say(f"[{smi}] sharded LM (b) checkpoints across grids: 2x2 run with saves at 0 "
        f"and 3 in {w['wall_s']:.3f} s; phase 12's step-6 checkpoint resumed on 2x2 "
        f"in {f1['wall_s']:.3f} s (steps 7-8); the 2x2 step-3 checkpoint resumed on "
        f"1x1 in {resume_1x1_s:.3f} s (steps 4-5); loss gaps against phase 12's "
        f"uninterrupted 1x1 run: "
        f"{ {k: [f'{g:.2e}' for g in v] for k, v in b_gaps.items()} } "
        f"(tol {SHARD_LOSS_TOL:g}; PR 22's bf16 kernel-vs-plain loss gap 1.031e-05)")
    if len(resumed) != 2 or len(f1["losses"]) != 2 or len(w["losses"]) != 4 or \
            max(max(v) for v in b_gaps.values()) > SHARD_LOSS_TOL:
        bad.append(f"(b): {b_gaps}")
    # (c) against (a)'s uncompressed steps
    c = r0["compressed"]
    c_gaps = _gaps(c["losses"], a["losses"][:SHARD_COMP_STEPS])
    say(f"[{smi}] sharded LM (c) (pod 2, data 1, model 2) int8 pod sync: "
        f"{', '.join(f'{t:.3f}' for t in c['step_ms'])} ms/step on rank 0; "
        + _steps_line("against 2x2 uncompressed", c, a, "2x2")
        + f" (tol loss {SHARD_COMP_LOSS_TOL:g}, gnorm {SHARD_COMP_GNORM_TOL:g}); the pods' "
        f"params apart by {c['pods_apart']:.3e} (tol 0); largest residual "
        f"{c['max_residual']:.3e}; peak GiB by rank "
        f"{[round(r['compressed']['peak_bytes'] / 2**30, 3) for r in ranks]}")
    bad += _step_faults("(c)", c, a, SHARD_COMP_LOSS_TOL, SHARD_COMP_GNORM_TOL)
    if c["pods_apart"] != 0 or not c["max_residual"] > 0:
        bad.append(f"(c): the pods' params apart by {c['pods_apart']}, largest residual "
                   f"{c['max_residual']}")
    # (d)
    d = r0["serve"]
    d["logits"] = [torch.from_numpy(x) for x in d["logits"]]
    gaps = _logit_gaps(served["logits"], d["logits"])
    agree = float(sum((x[:, -1].argmax(-1) == y[:, -1].argmax(-1)).float().mean()
                      for x, y in zip(d["logits"], served["logits"])) / len(gaps))
    steps = LM_GEN - 1
    say(f"[{smi}] sharded LM (d) serving 2x2 B={LM_BATCH} prompt={LM_PROMPT} "
        f"gen={LM_GEN}, teacher-forced with phase 8's tokens: prefill "
        f"{d['prefill_ms']:.3f} ms, decode {d['decode_ms'] / steps:.3f} ms/step on rank "
        f"0; logits against phase 8's 1x1: prefill {gaps[0]:.3e}, decode max "
        f"{max(gaps[1:]):.3e} of max|logit| (tol {LM_TOL_BF16:g}); greedy choices "
        f"agree on {agree:.1%}; cache a rank {d['cache_shape']}; counts {d['counts']}")
    for r in ranks:
        cd = r["serve"]["counts"]
        if cd["flash_attention"] != cfg.n_layers or cd["flash_attention_plain"]:
            bad.append(f"(d) rank {r['rank']}: counts {cd}")
    if max(gaps) > LM_TOL_BF16 or tuple(d["tokens"].shape) != (LM_BATCH, LM_GEN):
        bad.append(f"(d): logits gap {max(gaps):.3e} > {LM_TOL_BF16}")
    # (e) the controls: the gates above must refuse each
    cu, cs = r0["control_update"], r0["control_sync"]
    refused_update = _step_faults("control", cu, a, SHARD_LOSS_TOL, SHARD_GNORM_TOL,
                                  SHARD_MOVED_TOL)
    refused_sync = _step_faults("control", cs, a, SHARD_COMP_LOSS_TOL,
                                SHARD_COMP_GNORM_TOL) + (
        ["the pods apart"] if cs["pods_apart"] != 0 else [])
    say(f"[{smi}] sharded LM (e) control, (a) with the update left out (lr 0): "
        + _steps_line("against (a)", cu, a, "(a)")
        + f"; {'refused: ' + '; '.join(refused_update) if refused_update else 'PASSED'}")
    say(f"[{smi}] sharded LM (e) control, (c) with the pod sync left out: "
        + _steps_line("against (a)", cs, a, "(a)")
        + f"; the pods' params apart by {cs['pods_apart']:.3e}; "
        f"{'refused: ' + '; '.join(refused_sync) if refused_sync else 'PASSED'}")
    if not refused_update:
        bad.append("(e): the gates of (a) pass a run that leaves the params unchanged")
    if not refused_sync:
        bad.append("(e): the gates of (c) pass a run without the pod sync")
    launches = {"flash_attention": 0, "ring_send": 0, "ring_land": 0}
    for r in ranks:
        for part in (r["train"]["counts"], r["launch_counts"], r["compressed"]["counts"],
                     r["serve"]["counts"]):
            for k in launches:
                launches[k] += part[k]
    out.update(loss_gaps=loss_gaps, gnorm_gaps=gnorm_gaps, ms_per_step=ms,
               per_step=per_step, peaks=peaks, peak_1x1=limit, resume_gaps=b_gaps,
               compressed_gaps=c_gaps, logit_gaps=gaps, greedy_agree=agree,
               launches=launches, refused={"update": refused_update, "sync": refused_sync})
    for r in ranks:
        r["serve"].pop("logits", None)
        r["serve"].pop("tokens", None)
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] sharded LM: phase 13 in {out['phase_s']:.3f} s (spawn and ranks "
        f"{spawn_s:.3f} s)")
    if bad:
        fail("sharded LM " + "; ".join(bad))
    return out, launches


REPLACES = {"flash_attention": "src/repro/kernels/attention.py:68",
            "fft_radix2": "src/repro/kernels/fft_radix2.py:90",
            "fft_mxu": "src/repro/kernels/fft_mxu.py:80",
            "ring_payload": "src/repro/kernels/ring_rdma.py:153",
            "ring_send": "src/repro/kernels/ring_rdma.py:88",
            "ring_land": "src/repro/kernels/ring_rdma.py:101"}


def main(argv) -> int:
    name, smi = card()
    sys.path.insert(0, SRC)
    import torch

    # the plain versions' products go through cuBLAS: full f32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    if argv == [FLEET_ONLY]:
        fleet(smi)
        return 0
    if argv == [TRAIN_ONLY]:
        training(smi)
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        return 0
    if argv == [LM_ONLY]:
        lm, lm_kept = lm_serving(float("nan"))
        trained, _ = training(smi)
        sharded_lm(smi, trained, lm_kept)
        return 0
    flash_sass_counts, ptxas_build = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    max_abs = kernel_vs_plain(gen)
    max_abs.update(ring_vs_plain(gen))
    max_abs["flash_attention"], flash_rel, flash_gaps = flash_vs_plain(gen)
    mma_rates = mma_probe()
    times = timing(gen)
    ring_times = ring_timing(gen)
    flash_times = flash_timing(gen)
    flash_time = flash_times[0]
    os.makedirs(REF_DIR, exist_ok=True)
    runs, launches = main_path()
    observed = observability(runs)
    prof = [breakdown(BACKEND[k]) for k in KERNELS]
    tune_backends = calibrate_backends()
    ranks, ring_launches = multi_rank(runs, tune_backends)
    staged_ranks, staged_launches = staged_mesh()
    launches.update({k: n + staged_launches[k] for k, n in ring_launches.items()})
    lm, lm_kept = lm_serving(flash_rel)
    launches["flash_attention"] = lm["counts"]["flash_attention"]
    tuned = tuning(runs, ranks, tune_backends)
    served, serve_launches = serving(smi)
    for k, n in serve_launches.items():
        launches[k] += n
    fleeted, fleet_launches = fleet(smi)
    for k, n in fleet_launches.items():
        launches[k] += n
    trained, launches_trained = training(smi)
    launches["flash_attention"] += launches_trained
    sharded, sharded_launches = sharded_lm(smi, trained, lm_kept)
    for k, n in sharded_launches.items():
        launches[k] += n

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
                   "flash_sass": flash_sass_counts, "ptxas": ptxas_build,
                   "mma_rates": mma_rates,
                   "kernels": kernels, "runs": runs, "breakdown": prof,
                   "observability": observed, "multi_rank": ranks,
                   "staged": staged_ranks, "flash_bf16_gaps": flash_gaps, "lm": lm,
                   "tuning": tuned, "serving": served, "fleet": fleeted,
                   "training": trained, "sharded_lm": sharded},
                  f, indent=1)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [FLEET_WORKER]:
        sys.exit(fleet_worker(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
