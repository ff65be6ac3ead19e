#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; nothing of
JAX or of the JAX package ``repro``).  It covers the nine kernels of the
port's three main paths.  The solver step: ``fft_radix2`` (backend
``"pallas"``), ``fft_mxu`` (backend ``"mxu"``, the four-step FFT on the
FP64 tensor cores), and the NIC engine's ``ring_payload``, ``ring_send``
and ``ring_land`` (``csrc/ring_rdma.cu``, engines
``pallas_ring``/``bidi_ring`` on a grid of more than one rank).  LM
serving and training: ``flash_attention`` (``csrc/flash_attention.cu``),
the attention of every layer of the prefill and of every forward of a
training step (deepseek-v2-lite's MLA in its decompressed form, at
D=192); RWKV-6's recurrence, ``wkv6`` (``csrc/wkv6.cu``), once a
layer in rwkv6-3b's prefill and each of its decode steps and once a
block forward in its training, and its gradient, ``wkv6_bwd`` (same
source), once a layer a microbatch in the backward; Mamba's selective
scan, ``selective_scan`` (``csrc/selective_scan.cu``), once a Mamba layer
in the Jamba hybrid's prefill and each of its decode steps; sharded over a
mesh of rank processes, the LM's collectives run on ``ring_send`` and
``ring_land`` too, the MoE's expert-parallel all-to-alls among them.  Phases, each
fatal on failure:

1. card — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build — the six CUDA sources, ``nvcc`` processes started together,
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
   batch 8, prompt 2048, 16 greedy tokens; the ``flash_attention`` counts
   set to 0 just before and read just after (one launch a layer, no
   plain call, no pad copy); prefill ms, decode ms a step, tok/s, peak
   memory.  Then
   the same prompts with the plain attention (``RunCfg(plain_attention=
   True)``), teacher-forced with the kernel run's tokens: every step's
   logits within 3e-2·max|logit| (the drift of 32 bf16 layers, about
   3× the gap measured on the H100); then the int8 KV cache (the config's
   ``kv_quant``: int8 k and v with an f32 scale a token and kv head), the
   same prompts teacher-forced with the kernel run's tokens, its prefill's
   ``flash_attention`` counts from 0 (one launch a layer): every step's
   logits within 2e-2·max|logit| of the bf16 cache run's (the reference's
   own test allows 0.08, which a control reading k with v's scales passes
   on the H100) and the top-1 choice agreeing on ≥ 7/8 of rows × steps, a
   gate that must refuse that control; every prompt entry of the int8
   cache within half a level of a bf16 prefill's; the cache's bytes,
   decode ms a step, tok/s and peak beside the bf16 cache's; and
   both attentions in f32 at prompt 512 (8 tokens), free-running: identical greedy
   tokens, logits within 1e-4·max|logit|.  One ``torch.profiler`` trace
   of a prefill and of a decode step (informational);
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
   than 70 GiB), then a burst through ``run_load`` of 24 heat requests
   (scale 1 + 0.25·(i mod 8), 3 steps: 12 batches of 4) and 2 nls N=256
   requests (another fingerprint); (b) the heat requests paced at 16
   requests/s (above what one-lane batches serve) through the scheduler
   thread, on ``"pallas"``; (c) 4 rank processes on 2x2 (phase 13's, after
   its runs: no spawn of its own), heat N=512 on run (c)'s plan
   (``pallas_ring``, fused, chunks=3), 24 requests, ``max_batch`` 2, rank 0
   scheduling.  Gates: no request rejected or
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
   heat N=256 f64 on 1x1 ``"pallas"``, 2 jobs of 4
   steps at scales 1.0 and 1.25, a snapshot every 2 steps, run clean and
   then with ``kill-at-step:3``: every job completes; each chaos job in 2
   attempts with one crash of exit code 13; ``fleet.jobs.retried`` 2,
   ``quarantined`` 0; the histories bitwise the clean ones (``t``
   included), the clean ones bitwise a solo in-process run of the same job;
   ``restore_latency_us`` > 0; every finished worker launched
   ``fft_radix2`` as often a step as the solo step and no plain version.
   (b) one job at nls N=256 f64 on 2x1 ``pallas_ring``, fused (nls: all
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
12. training — ``smollm-360m`` at full width, cut to its first 12 of 32
   layers (``--layers 12``: two remat groups of 6, as the full model's
   groups of 8 are two-level), through
   ``repro_torch.launch.train`` (bf16 compute, f32 params and moments,
   two-level remat, B=8, S=512, random weights from seed 0).  (a) Step
   0's loss and gradients through the kernel path against the plain
   attention's (``RunCfg(plain_attention=True)``), in bf16 and in f32: the
   kernel launched once a block forward (``models.transformer.
   block_forwards``: 34 a step, 12 layers in two remat groups) and no plain
   call; every ``wq``/``wk``/``wv`` gradient nonzero; per gradient leaf
   ``||d|| <= tol·||g_plain||`` (bf16 5e-2, f32 1e-5); the losses within
   3e-2 relative; and the same gate must refuse a control whose kernel
   output is detached from q, k and v (the fault this slice repaired).
   (b) 12 steps through ``launch/train.py``'s ``main``, counts set to 0
   just before and read just after: every loss finite, ``flash_attention``
   launched 12 × 16 times, no plain call, no pad copy.  (c) The run halted
   after step 6 (checkpoints at steps 0 and 6, under
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
   Phase 12's model (12 layers), seed and data on 2x2 (FSDP over ``data``, the mlp and
   vocab over ``model``, the 15 heads replicated): 6 steps, each loss
   within 3e-2 of phase 12 (d)'s 1x1 step (the gaps and gnorms' printed),
   ms/step on rank 0, one step under ``torch.profiler`` on rank 0 (its
   idle share), every rank's peak below phase 12's, per step and rank 34
   ``flash_attention`` launches and no plain call, the wire copies and
   bytes.  (b) ``launch/train.py`` on 2x2 saves at steps 0 and 3 and
   halts (its checkpoint resumed on 1x1 here for steps 4-5), and phase
   12's step-6 checkpoint resumed on 2x2 for steps 7-8; each loss within
   3e-2 of phase 12 (b)'s.  (c) Re-cut to (pod 2, data 1, model 2): 3
   steps with the int8 pod sync, the losses against (a)'s and the largest
   residual.  (d) Re-cut to 2x2: phase 8's prompts (B=8, prompt 2048)
   for 2 tokens teacher-forced with phase 8's, one launch a layer a rank:
   the dense decode and the sequence-sharded one (``RunCfg.seq_shard_kv``:
   the cache's time axis cut over ``data``, its head_dim over ``model``,
   the batch whole; each decode step's softmaxes combined over ``data`` by
   log-sum-exp), each step's logits within 3e-2·max|logit| of phase 8's
   (and the sequence-sharded of the dense 2x2's), a gate that must refuse
   a control combining with each rank's local max (2 tokens); then the
   int8 cache on 2x2 within 3e-2·max|logit| of phase 8's int8 run.  Each
   run's prefill ms, decode ms/step on rank 0, cache bytes a rank, and one
   more decode step's collectives and wire bytes.
14. the MoE — ``qwen3-moe-30b-a3b`` at full width (d 2048, 32 heads on 4
   kv heads, head_dim 128, 128 experts top-8, expert d_ff 768, vocab
   151936), cut to 4 of its 48 layers (``dataclasses.replace(CONFIG,
   n_layers=4)``: 3.115 B params), bf16, seed 0.  Every correctness gate
   runs at capacity factor 8.0, where nothing drops (the EP and dense
   capacity rules drop different pairs at 1.25), and pins the expert
   choices of the run compared to the reference run's
   (``models.moe.routing``: the top-k of bf16 router logits flips under
   one-unit changes); the timed runs take the config's 1.25 and print the
   share of pairs dropped.  (a) 1x1 serving, B=8, prompt 2048, 16 tokens
   through ``launch/serve.py``'s ``generate``: 4 ``flash_attention``
   launches a prefill, no plain call; every step's logits within
   3e-2·max|logit| of the plain attention's, teacher-forced; block 0's MoE
   at T=512 by index against the one-hot plain version (2e-2 of max);
   prefill ms, decode ms a step, tok/s, peak, a profiled prefill.  (c)
   1x1 training, B=8, S=512, remat: step 0's gradients against the plain
   attention's per leaf (5e-2, phase 12's gate), 4 steps (ms/step,
   tokens/s, peak), 3 steps at 8.0.  (b) and (d): one spawn of 4 rank
   processes on 2x2, expert-parallel (every all-to-all on the peer-mapped
   wire: ``ring_send``/``ring_land``).  (b) serving 2 tokens at 8.0,
   teacher-forced with (a)'s first 4 there: logits within 3e-2·max|logit|
   of (a)'s; at 1.25 (2 tokens) prefill and decode ms on rank 0, all-to-alls and wire bytes a
   prefill and a decode step.  (d) 3 steps at 8.0 against (c)'s: loss,
   gnorm and the params' change ‖p₃ − p₀‖, gates that must refuse the
   same steps with the experts' gradients left out; at 1.25 ms/step on
   rank 0, peak a rank, all-to-alls and wire bytes a step.
   ``chip_smoke.py --moe-only`` runs phases 1 and 14;
15. MLA — ``deepseek-v2-lite-16b`` at full width (d 2048, 16 heads, MLA
   kv_lora 512, nope 128, rope 64, v 128; 64 experts top-6, expert d_ff
   1408, 2 shared experts; the first block dense at d_ff 10944; vocab
   102400), bf16, seed 0; its prefill's attention the flash kernel at
   D=192 (the decompressed form: 16 heads on 16, v zero-padded to 192).
   (a) 1x1 serving at full depth (27 layers, 15.706 B params, 62.83 GB of
   f32 params on the card), B=8, prompt 2048, 16 tokens through
   ``generate``: 27 ``flash_attention`` launches a prefill, no plain call,
   no pad copy; the plain attention's run of its first 8 tokens,
   teacher-forced and its expert choices pinned: the kernel's gates are every layer's kernel output on
   the plain run's q, k, v within phase 3's bf16 rule and the same runs in
   f32 (prompt 512, 8 tokens) within 1e-4; the bf16 logits are shown
   beside those of a control attention (unblocked f32, rounded once) and
   bounded by max(3e-2, 2 × the control's gap), a bound that a key tile
   dropped in every layer must exceed (p rounded to bf16 passes it and is
   shown); one MLA layer at
   B=8, S=2048, the decompressed form on the kernel within 2e-2·max|out|
   of the plain latent form; prefill ms, decode ms a step, tok/s, peak,
   the share of pairs dropped at 1.25 and the compressed cache's bytes.
   (b) 1x1 training cut to 4 layers (1 dense + 3 MoE), B=8, S=512, remat:
   step 0's gradients against the plain attention's per leaf (5e-2), 8
   launches a step; 4 steps at 1.25 (ms/step, tokens/s, peak); then (c)'s
   references at capacity factor 11 (64 experts / top-6 rounded up: no
   pair drops under either capacity rule): serving in bf16 and f32 (tokens,
   logits, expert choices) and 3 steps in bf16 and in f32.  (c) Inside
   phase 14's spawn,
   after its runs: the 4-layer model on 2x2 (heads over ``model``, the
   latents and the cache whole there, the experts expert-parallel),
   serving 2 tokens at 11 teacher-forced and pinned, logits within
   3e-2·max|logit| of (b)'s first 4 (f32: 1e-4); 3 training steps at 11 against (b)'s: in bf16
   the loss and ‖p₃ − p₀‖ under phase 14's (d) gates (1e-3, 1e-3), the
   gnorm shown; in f32 the loss, gnorm and change under all three (1e-3,
   4e-3, 1e-3), which must refuse a control with MLA's latent weights'
   gradients left unsummed over ``model``; rank 0's ms/step, peak a rank,
   all-to-alls and wire bytes a step.  Last, a reading that gates
   nothing: step 0's f32 gradients on 2x2 with the expert choices pinned
   to 1x1's, each leaf's norm against 1x1's (the unpinned f32 gnorm gap's
   cause).
   ``chip_smoke.py --mla-only`` runs phases 1 and 15, (c) in a spawn of
   its own;
16. RWKV — ``rwkv6-3b`` at full width and depth (32 layers, d 2560, 40
   heads of 64, d_ff 8960, vocab 65536; 3.07 B params, 12.29 GB in f32),
   bf16, seed 0, its recurrence the ``wkv6`` kernel (``wkv6``'s ptxas
   registers and spills in phase 2, fatal on a spill).  (a) After phase 8,
   its batch, prompt and 16 tokens through ``generate``: one launch a layer
   for the prefill and for each decode step, no plain call (counted in
   the run, and again for one prefill and one step alone); the plain
   recurrence's run (``RunCfg(plain_wkv=True)``), teacher-forced for 2
   tokens, in which every call of the recurrence also runs the kernel on
   the same inputs: y and the final state within 1e-5 of max, a gate that
   must refuse the kernel with u = 0 in every call; the bf16 logits within
   max(3e-2, 2 × the gap of a correct control, the recurrence in f64
   rounded once) of the plain run's, a bound that the kernel with u = 0 in
   every layer must exceed; f32 at prompt 512, 8 tokens: identical greedy
   tokens, logits within 1e-4; prefill ms, decode ms a step, tok/s, peak,
   the decode state's bytes, a profiled prefill and decode step; the
   kernel timed at the prefill shape and at S=1 against its bound.  (b)
   B=1 at ``long_500k``'s 524288 positions (in chunks of
   ``transformer.SEQ_CHUNK_TOKENS``), then 8 decode steps: prefill s,
   decode ms a step, peak, the state's bytes, finite logits; at layer 0
   the kernel over the whole prompt equals its two halves with the state
   carried, bit for bit, and the plain loop over the last 2048 steps from
   the kernel's state there is within 1e-5 of it.  (c) Inside phase 13's
   spawn, after its runs: the model's shards on 2x2 (20 heads a rank and
   their WKV state; FSDP over ``data``), (a)'s prompts teacher-forced with
   its tokens: bf16 for 2 tokens within max(3e-2, 2 × the gap of a
   correct 1x1 control with 2x2's arithmetic: ``Wo`` and the channel
   mix's ``Wv`` in two halves of their rows, each rounded to bf16, summed
   in rank order) of (a)'s logits; f32 at prompt 512 for 2 tokens within
   1e-4 of (a)'s f32 run, a gate that must refuse the same run with every
   rank taking the first heads' decay (the bf16 run with that fault is
   shown too: it stays within twice a correct run's bf16 drift);
   decode ms a step on rank 0, a decode step's exchanges and wire bytes,
   the state a rank.  ``--rwkv-only`` runs phases 1, 16 and 17 ((c) and
   17 (b) in a spawn of their own); ``--lm-only`` runs phases 1, 8, 16,
   17, 18, 12, 13, 14 and 15;
17. RWKV training — (a) right after 16 (b), on its model: step 0's
   gradients in one microbatch (B=8, the first 256 of S=512) against the plain
   recurrence's run (torch's autograd through its loop), in bf16 at 12
   layers (the plain run took 88 s at 32) and in f32 at 4, each leaf
   within max(floor, 2 x a correct control's largest gap on that kind of
   leaf, the recurrence in f64 rounded once; floors 5e-2 and 1e-5), bounds
   that the kernel with dw = 0 must exceed; then 4 steps of rwkv6-3b at
   full width and depth through ``launch/train.py`` (bf16, f32 params and
   moments, remat, 2 microbatches; counts from 0: 2 x 92 ``wkv6`` and 2 x
   32 ``wkv6_bwd`` launches a step, no plain forward; finite losses and
   gnorms), in whose step 0 the first and last layer of each remat group
   (16 of the 64 ``wkv6_bwd`` calls: the plain backward takes ~0.26 s a
   call) are held against ``wkv6_backward_plain`` on the same inputs,
   each output within 1e-5 of its max, a gate that must refuse dw = 0 and
   du = 0 (those 16 plain calls the run's only ones); ms/step, tokens/s,
   peak, the last step profiled; both kernels timed at the training shape
   against their bounds.  (b) Inside phase 13's spawn
   after 16 (c): rwkv6-3b cut to 4 layers on 2x2, 3 f32 steps within
   phase 13's gates (loss 6e-5, gnorm 1e-3, the params' change 1e-4) of
   the same 1x1 run (made in (a)), 3 bf16 steps shown; after every step
   each leaf whole over ``model`` the same bits on both ranks of
   ``model``; two controls refused (the time mix's sliced leaves without
   their gradients summed over ``model``; the receptance gathered with no
   autograd); rank 0's ms/step, peak a rank, a step's exchanges and wire
   bytes.
18. Jamba — right after 17 (a), in the main process:
   ``jamba-1.5-large-398b`` at full width (d 8192, 64 heads on 8 kv heads
   of 128, d_ff 24576, 16 experts top-2 at d_ff 24576 every other layer,
   Mamba d_state 16, d_conv 4, d_inner 16384, vocab 65536), one superblock
   (72 -> 8 layers: 1 attention, 7 Mamba, 4 MoE and 4 dense MLP
   sub-layers), the card holding experts 0-7 of each MoE layer's 16 (one
   chip of a deployment that puts them over 2, expert-parallel:
   ``init_model(experts=(0, 8))``; 25.91 B params, 51.8 GB), bf16, seed 0,
   capacity factor 1.25; its recurrence the ``selective_scan`` kernel
   (``csrc/selective_scan.cu``; its ptxas registers and spills in phase 2,
   fatal on a spill).  First the launcher's own command, ``python3 -m
   repro_torch.launch.serve --arch jamba-1.5-large-398b --layers 8
   --experts 0:8 --batch 8 --prompt-len 2048 --gen 16``, in this process:
   its counts as (a)'s, its tokens against (a)'s.  (a) Phase 8's batch,
   prompt and 16 tokens through ``generate``: 7 scan launches a prefill
   and 7 a decode step, 1
   ``flash_attention`` launch a prefill, no plain call (counted in the
   run, and again for one prefill and one step alone); prefill ms, decode
   ms a step, tok/s, peak, the decode state's bytes (the Mamba layers'
   conv and ssm states against the attention layer's k and v), a profiled
   prefill and decode step.  (b) The plain scan's and plain attention's
   run, teacher-forced for 2 tokens, the expert choices pinned to (a)'s;
   every call of the recurrence in it also runs the kernel on the same
   inputs: y and the final state within 1e-5 of max, a gate that must
   refuse the kernel reading B of the step before in every call; the bf16
   logits within max(3e-2, 2 × the gap of a correct control, the scan in
   f64 rounded once) of the plain run's, a bound that the kernel reading
   B of the step before in every layer must exceed.  (c) f32 at prompt
   512, 8 tokens, each sub-layer's params cast as it runs: the plain run,
   pinned to the kernel run's routing and teacher-forced with its tokens,
   within 1e-4 of its logits; the peak.  The kernel timed at the prefill
   shape and at S=1 against its bound (the larger of its bytes and its
   arithmetic: its f32 flops on the FMA pipes and its exponentials split
   between the special function units and a polynomial on the FMA pipes,
   at the card's max SM clock, which ``nvidia-smi`` reads; the
   exponentials on the special function units alone printed beside it)
   and its plain time.  (d) Jamba trained, after (a)-(c)'s model is
   freed: one superblock at full width, the card holding expert 0 of each
   MoE layer's 16 (one chip of a deployment that puts them over 16 chips,
   one expert each; 9.00 B params, bf16 params, gradients and moments: 72
   GB), its recurrence's gradient the ``selective_scan_bwd`` kernel (its
   ptxas registers and spills in phase 2, fatal on a spill), the forward
   keeping the state every 16 steps.  Step 0's gradients at B=8, S=128
   against the plain scan's run (torch's autograd through its loop), the
   expert choices pinned, each leaf within max(5e-2, 2 × a correct
   control's gap, the scan in f64 rounded once), bounds that the backward
   with dA_log = 0 and with dC of the step before must exceed.  Then the
   launcher's own command, ``python3 -m repro_torch.launch.train --arch
   jamba-1.5-large-398b --layers 8 --experts 0:1 --batch 8 --seq 512
   --steps 4``, in this process: counts from 0 (21 scan launches a step:
   the forward, the superblock's recompute and each Mamba layer's own; 7
   ``selective_scan_bwd``; 2 ``flash_attention``; no plain call), finite
   losses and gnorms, ms/step, tokens/s, peak, the last step profiled;
   step 0's 7 ``selective_scan_bwd`` calls kept on the host and, once the
   run has freed the card, each held against the plain backward on the
   same inputs: each output within 1e-5 of its max, dC of the step before
   and dA_log = 0 (made from the kernel's result) refused in every call.
   Both kernels timed at the training shape (B=8, S=512) against their
   bounds, beside their plain times.
   ``--jamba-only`` runs phases 1, 2 and 18.

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
SOURCES = KERNELS + ("ring_rdma", "flash_attention", "wkv6", "selective_scan")
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
# B is cut where SERVE_BATCH lanes' step would take more than SERVE_MEM_GIB.
# 24 requests a run (the script's time limit): every scale 3 times, every
# lane still checked against its solo run
SERVE_N, SERVE_REQUESTS, SERVE_STEPS, SERVE_BATCH = 512, 24, 3, 4
SERVE_SCALES = 8
SERVE_NLS = (256, 2)    # (N, requests)
SERVE_RATE = 16.0
SERVE_GRID_REQUESTS, SERVE_GRID_BATCH = 24, 2
SERVE_MEM_GIB = 70.0
SERVE_BACKENDS = ("pallas", "mxu")

# flash attention: (B, S, T, H, Hkv, D, causal) held against the plain
# version, the LM prefill's shapes first (smollm-360m: 15 heads, 5 kv
# heads, head_dim 64; bf16 at prompt 2048, f32 at prompt 512), then the
# edges of tests/test_torch_gpu.py (D 20..256, groups 1, 3, 8, S 1..2048)
FLASH_MAIN = (8, 2048, 2048, 15, 5, 64, True)
# phase 4 also times the training step's shape (phase 12: B=8, S=512)
FLASH_TRAIN = (8, 512, 512, 15, 5, 64, True)
# deepseek-v2-lite's MLA prefill (phase 15) in its decompressed form: 16
# heads on 16 at D = 192 (nope 128 + rope 64, v zero-padded to 192)
FLASH_MLA = (8, 2048, 2048, 16, 16, 192, True)
# the MLA path's value width (v_head_dim): v goes to the kernel zero-padded
# to D and the output is cut back, so phase 4 times the kernel on the
# padded v, and takes the function's bound and SDPA's time with v and the
# output at this width
FLASH_MLA_DV = 128
FLASH_CHECKS = {
    "bfloat16": (FLASH_MAIN, (1, 1, 1, 8, 1, 256, True), (1, 17, 17, 6, 2, 20, True),
                 (2, 64, 77, 24, 3, 128, False), (1, 2048, 2048, 6, 2, 256, True),
                 (1, 17, 30, 3, 3, 64, False), (2, 129, 142, 8, 1, 256, False),
                 FLASH_MLA),
    "float32": ((8, 512, 512, 15, 5, 64, True), (1, 1, 1, 8, 1, 256, True),
                (1, 17, 17, 6, 2, 20, True), (2, 64, 77, 24, 3, 128, False),
                (1, 2048, 2048, 6, 2, 256, True), (2, 512, 512, 16, 16, 192, True)),
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
LM_BATCH, LM_PROMPT, LM_GEN = 8, 2048, 16
# the tokens of a serving run on 2x2 (phases 13 (d), 14 (b), 15 (c)): the
# first MESH_GEN of the 1x1 run compared with, teacher-forced (a 2x2 decode
# step takes 0.2-1.4 s on rank 0: the script's time limit): the prefill
# and one decode step
MESH_GEN = 2
LM_PROMPT_F32 = 512
# phase 8's f32 runs (kernel and plain attention, free-running) serve
# LM_GEN_F32 tokens
LM_GEN_F32 = 8
# kernel vs plain attention through the whole bf16 model, each step's
# logits: max|d| <= LM_TOL_BF16 · max|logit|.  This bounds the model's
# drift, not the kernel's error (phase 3 holds that to a few bf16 units in
# the last place): one-unit differences of the attention output grow
# through 32 bf16 layers, to 9.4e-3 of max|logit| on the H100.  f32:
# identical greedy tokens and max|d| <= 1e-4 · max|logit|
LM_TOL_BF16 = 3e-2
LM_TOL_F32 = 1e-4
# phase 8's int8 KV cache (the config's kv_quant): the same prompts,
# teacher-forced with the bf16 cache run's tokens.  Every step's logits
# within LM_INT8_TOL·max|logit| of the bf16 cache run's and the top-1
# choice agreeing on at least LM_INT8_AGREE of rows x steps (the reference's
# own test, tests/test_attention.py::test_int8_kv_cache_decode_close_to_bf16,
# bounds the gap by LM_INT8_REF_TOL); a control that reads k with v's
# scales must be refused.  On the H100 the sound run parts by 7.8e-3 and
# the control by 3.9e-2, both under the reference's 0.08, so the gate sits
# between them.  And every prompt entry of the int8 cache dequantizes to
# within half a level (LM_INT8_LEVELS, f32) of the bf16 cache's value
LM_INT8_TOL, LM_INT8_AGREE, LM_INT8_REF_TOL = 2e-2, 7 / 8, 0.08
LM_INT8_LEVELS = 0.5 + 1e-4

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
    wkv = wkv_ptxas(_build.build_log("wkv6"))
    scan = scan_ptxas(_build.build_log("selective_scan"))
    return flash_sass(libs["flash_attention"], _build.build_log("flash_attention"),
                      _build.nvcc()), radix2 + mxu + copies + wkv + scan


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


def wkv_ptxas(log: str) -> list:
    """Phase 2, ``wkv6`` and ``wkv6_bwd``: registers and spill bytes of
    each instantiation (f32 and bf16 inputs, head sizes 16 and 64); fatal
    on a spill or a missing one."""
    dtype = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
    out = []
    for kernel in ("wkv6_kernel", "wkv6_bwd_kernel"):
        ks = _ptxas_entries(log, rf"\d{kernel}I(f|13__nv_bfloat16)Li(\d+)E")
        say(f"  ptxas {kernel}, registers / spill bytes: " + ", ".join(
            f"<{dtype[k['groups'][0]]}, K={k['groups'][1]}>: {k['registers']}/"
            f"{k['spill_bytes']}" for k in ks))
        if len(ks) != 4 or any(k["spill_bytes"] != 0 for k in ks):
            fail(f"{kernel} instantiations: {ks}")
        out += [{"source": "wkv6", "kernel": kernel, "dtype": dtype[k["groups"][0]],
                 "head_size": int(k["groups"][1]), "registers": k["registers"],
                 "spill_bytes": k["spill_bytes"]} for k in ks]
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
    phase 3's f32 prefill shape, bf16 at the training step's shape (B=8,
    S=T=512) and at deepseek-v2-lite's MLA prefill (``FLASH_MLA``: 16 heads
    at D=192, v at FLASH_MLA_DV zero-padded to 192 as the MLA path gives
    it).  Each against ``scaled_dot_product_attention`` on (B, H, S, D)
    views with ``enable_gqa`` (a yardstick the port never calls; f32 with
    TF32 off, as ``main`` sets; at the MLA shape v unpadded), CUDA events;
    the plain version at the prefill, training and MLA shapes only.  The
    bound is the larger of q, k, v and o's bytes over 3.35 TB/s and the
    kept pairs' flops (Q·Kᵀ at D, P·V at v's width: the function's, not
    the padding's) over the peak of the units the kernel runs on (bf16
    tensor cores; f32 CUDA cores).
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
    shapes.append(("deepseek-v2-lite-16b MLA prefill", FLASH_MLA, torch.bfloat16,
                   BF16_TC_FLOPS))
    out = []
    for label, shape, dtype, peak in shapes:
        b, s, t, h, hkv, d, causal = shape
        dv = FLASH_MLA_DV if shape == FLASH_MLA else d
        q = _rand((b, s, h, d), torch.float32, gen).to(dtype)
        k = _rand((b, t, hkv, d), torch.float32, gen).to(dtype)
        v0 = _rand((b, t, hkv, dv), torch.float32, gen).to(dtype)
        v = F.pad(v0, (0, d - dv)).contiguous() if dv != d else v0
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v0))
        ms = _time_ms(lambda: attention.flash_attention(q, k, v, causal=causal), 20, 3)
        plain_ms = (_time_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=causal), 3, 1) if shape in (FLASH_MAIN, FLASH_TRAIN, FLASH_MLA)
            else None)
        library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20, 3)
        moved = q.element_size() * (b * s * h * (d + dv) + b * t * hkv * (d + dv))
        flops = attention.attention_flops(b, s, t, h, d, causal) * (d + dv) / (2 * d)
        bytes_ms = moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / peak * 1e3
        r = {"kernel": "flash_attention", "label": label, "shape": list(shape),
             "dtype": str(dtype).removeprefix("torch."), "ms": ms,
             "plain_ms": plain_ms, "library_ms": library_ms, "bytes": moved,
             "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "dv": dv}
        plain = f"plain {plain_ms:.3f} ms, " if plain_ms is not None else ""
        padded = (f"; at the padded width {attention.attention_flops(b, s, t, h, d, causal):.4g}"
                  f" flop {attention.attention_flops(b, s, t, h, d, causal) / peak * 1e3:.4f} ms"
                  if dv != d else "")
        say(f"timing flash_attention ({label}) B={b} S={s} H={h} Hkv={hkv} D={d} "
            + (f"(v at {dv}, padded to {d} for the kernel) " if dv != d else "")
            + f"{r['dtype']} {'causal' if causal else 'full'}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s), {plain}sdpa {library_ms:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: {moved} B "
            f"{bytes_ms:.4f} ms, {flops:.4g} flop {ops_ms:.4f} ms{padded}), "
            f"{r['bound_ms'] / ms:.1%} of the bound")
        out.append(r)
        del q, k, v, v0, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def _logit_gaps(a, b):
    """Per step: max|a - b| over max|a|."""
    return [(x.float() - y.float()).abs().max().item() / x.float().abs().max().item()
            for x, y in zip(a, b)]


def _cache_bytes(cache) -> int:
    """The bytes of a decode cache's tensors (``len`` left out)."""
    return sum(t.numel() * t.element_size() for k, t in cache.items() if k != "len")


def _top1_agree(a, b) -> float:
    """The share of rows x steps whose greedy choice agrees."""
    return float(sum((x[:, -1].float().argmax(-1) == y[:, -1].float().argmax(-1))
                     .float().mean() for x, y in zip(a, b)) / len(a))


def _int8_k_by_v_scales(fn):
    """``fn()`` with the int8 decode reading every layer's k with v's
    scales: the control that phase 8's int8 gate must refuse."""
    from repro_torch.models import transformer as T

    decode = T._attn_decode_int8

    def swapped(p, cfg, run, x, cache, *args):
        return decode(p, cfg, run, x, dict(cache, k_scale=cache["v_scale"]), *args)

    T._attn_decode_int8 = swapped
    try:
        return fn()
    finally:
        T._attn_decode_int8 = decode


def _levels_apart(qcache, fcache, s: int) -> float:
    """The largest gap, in levels of its scale, between a prompt entry of
    the int8 cache ``qcache`` dequantized (f32) and the float cache
    ``fcache``'s, over the first ``s`` positions of every layer."""
    worst = 0.0
    for key in ("k", "v"):
        q, sc, f = qcache[key], qcache[key + "_scale"], fcache[key]
        for i in range(q.shape[0]):
            d = (q[i, :, :s].float() * sc[i, :, :s] - f[i, :, :s].float()).abs()
            worst = max(worst, float((d / sc[i, :, :s]).max()))
    return worst


def _lm_int8(cfg, model, tokens, kept, bf16):
    """Phase 8's int8 KV cache: ``cfg`` with ``kv_quant``, the same prompts
    teacher-forced with the bf16 cache run's tokens (``kept``), its
    ``flash_attention`` counts from 0; cache bytes, decode ms a step, tok/s
    and peak beside the bf16 cache's (``bf16``); the gate (LM_INT8_TOL,
    LM_INT8_AGREE) and its control (k read with v's scales); the prompt
    entries against a bf16 prefill's cache (LM_INT8_LEVELS).  Returns the
    readings and the int8 run's logits."""
    import dataclasses

    import torch

    from repro_torch.kernels import attention
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfgq = dataclasses.replace(cfg, kv_quant=True)
    run = T.RunCfg()
    forced = kept["tokens"].cuda()
    serve.generate(cfgq, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention.plain_calls = attention.pad_copies = 0
    q = serve.generate(cfgq, run, model, tokens, LM_GEN, forced=forced, keep_logits=True)
    counts = {"flash_attention": attention.launches,
              "flash_attention_plain": attention.plain_calls,
              "pad_copies": attention.pad_copies}
    steps = LM_GEN - 1
    logits = [x.float().cpu() for x in q["logits"]]
    out = {"counts": counts, "cache_bytes": _cache_bytes(q["cache"]),
           "cache_dtypes": {k: str(t.dtype) for k, t in q["cache"].items() if k != "len"},
           "prefill_ms": q["prefill_ms"], "decode_ms_per_step": q["decode_ms"] / steps,
           "tok_per_s": steps * LM_BATCH / (q["decode_ms"] / 1e3),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "gaps": _logit_gaps(kept["logits"], logits),
           "agree": _top1_agree(kept["logits"], logits),
           "tol": LM_INT8_TOL, "min_agree": LM_INT8_AGREE, "ref_tol": LM_INT8_REF_TOL}
    _, fcache = T.prefill(cfg, run, model, {"tokens": tokens}, t_max=LM_PROMPT + LM_GEN)
    out["levels_apart"] = _levels_apart(q["cache"], fcache, LM_PROMPT)
    del q, fcache
    c = _int8_k_by_v_scales(lambda: serve.generate(
        cfgq, run, model, tokens, LM_GEN, forced=forced, keep_logits=True))
    control = [x.float().cpu() for x in c["logits"]]
    del c
    torch.cuda.empty_cache()
    out["control"] = {"gaps": _logit_gaps(kept["logits"], control),
                      "agree": _top1_agree(kept["logits"], control)}

    def verdict(r):
        return max(r["gaps"]) <= LM_INT8_TOL and r["agree"] >= LM_INT8_AGREE

    out["passes"], out["control"]["passes"] = verdict(out), verdict(out["control"])
    say(f"LM serving {LM_ARCH} int8 KV cache B={LM_BATCH} prompt={LM_PROMPT} "
        f"gen={LM_GEN}, teacher-forced with the bf16 cache run's tokens: prefill "
        f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms_per_step']:.3f} ms/step "
        f"({out['tok_per_s']:.1f} tok/s), peak {out['peak_bytes'] / 2**30:.3f} GiB, cache "
        f"{out['cache_bytes']} B {out['cache_dtypes']}; the bf16 cache: decode "
        f"{bf16['decode_ms_per_step']:.3f} ms/step ({bf16['tok_per_s']:.1f} tok/s), peak "
        f"{bf16['peak_bytes'] / 2**30:.3f} GiB, cache {bf16['cache_bytes']} B "
        f"({out['cache_bytes'] / bf16['cache_bytes']:.4f}x); counts {counts}")
    say(f"LM int8 KV cache against the bf16 cache: logits gap prefill {out['gaps'][0]:.3e}, "
        f"decode max {max(out['gaps'][1:]):.3e} of max|logit| (tol {LM_INT8_TOL:g}; the "
        f"reference's test {LM_INT8_REF_TOL:g}), top-1 agreement {out['agree']:.2%} of rows "
        f"x steps (min {LM_INT8_AGREE:.2%}): {'passes' if out['passes'] else 'FAILS'}; "
        f"control, k read with v's scales: gap max {max(out['control']['gaps']):.3e}, "
        f"agreement {out['control']['agree']:.2%}: "
        f"{'PASSED' if out['control']['passes'] else 'refused'}; the prompt entries "
        f"{out['levels_apart']:.6f} levels from a bf16 prefill's cache at most (tol "
        f"{LM_INT8_LEVELS:g})")
    if counts["flash_attention"] != cfg.n_layers or counts["flash_attention_plain"] \
            or counts["pad_copies"]:
        fail(f"LM int8: the prefill's counts {counts}, want {cfg.n_layers} launches")
    if not all(bool(torch.isfinite(x).all()) for x in logits) or not out["passes"]:
        fail(f"LM int8: logits gap {max(out['gaps']):.3e} > {LM_INT8_TOL} or top-1 "
             f"agreement {out['agree']:.2%} < {LM_INT8_AGREE:.2%}, or non-finite logits")
    if out["control"]["passes"]:
        fail("LM int8: the gate passes the control that reads k with v's scales")
    if not out["levels_apart"] <= LM_INT8_LEVELS:
        fail(f"LM int8: a prompt entry {out['levels_apart']:.6f} levels from the bf16 "
             f"cache's (tol {LM_INT8_LEVELS:g})")
    return out, logits


def lm_serving(flash_rel_bf16):
    """Phase 8: the LM serving main path.  ``smollm-360m`` at full width
    and depth, bf16 as configured, random weights from seed 0, batch 8,
    prompt 2048, 32 greedy tokens through ``repro_torch.launch.serve``;
    the flash-attention counts set to 0 just before and read just after
    (one launch a layer, no plain call).  Then the same prompts with the
    plain attention (``RunCfg(plain_attention=True)``), teacher-forced
    with the kernel run's tokens, every step's logits within
    ``LM_TOL_BF16``; the int8 KV cache (:func:`_lm_int8`); and both
    attentions at f32 (prompt 512, LM_GEN_F32 tokens), free-running:
    identical tokens, logits within ``LM_TOL_F32``.  One ``torch.profiler`` trace of a prefill and
    of a decode step (informational)."""
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
    out["cache_bytes"] = _cache_bytes(cache)
    del r, p, cache
    torch.cuda.empty_cache()
    out["int8"], kept["int8_logits"] = _lm_int8(cfg, model, tokens, kept, out)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    t32 = tokens[:, :LM_PROMPT_F32]
    attention.launches = attention.plain_calls = 0
    k32 = serve.generate(cfg32, run, model, t32, LM_GEN_F32, keep_logits=True)
    n32 = attention.launches
    p32 = serve.generate(cfg32, plain_run, model, t32, LM_GEN_F32, keep_logits=True)
    gaps32 = _logit_gaps(k32["logits"], p32["logits"])
    same = bool(torch.equal(k32["tokens"], p32["tokens"]))
    out["f32"] = {"prompt": LM_PROMPT_F32, "prefill_ms": k32["prefill_ms"],
                  "decode_ms": k32["decode_ms"], "plain_prefill_ms": p32["prefill_ms"],
                  "same_tokens": same, "gap_max": max(gaps32), "launches": n32,
                  "tol": LM_TOL_F32}
    say(f"LM f32 (prompt {LM_PROMPT_F32}, {LM_GEN_F32} tokens): kernel prefill "
        f"{k32['prefill_ms']:.3f} ms "
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
    """``(device ms, launches, name)`` of every kernel a profile saw, summed
    by name from the profiler's raw device events: ``key_averages()`` gives
    the same rows but builds an event tree first, 20 times slower (most of
    the time a profiled rwkv6-3b training step, 41,000 kernels, took)."""
    from torch.autograd import DeviceType

    by_name: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_hidden_event():
            continue
        ns = e.duration_ns()
        if ns > 0:
            row = by_name.setdefault(e.name(), [0, 0])
            row[0] += ns
            row[1] += 1
    return sorted(((ns / 1e6, c, k) for k, (ns, c) in by_name.items()), reverse=True)


#: the background threads of :func:`_warm_profiler` not yet joined
_WARMING: list = []


def _warm_profiler() -> None:
    """Start and stop a first ``torch.profiler`` session (the card's
    events) in a background thread.  A process's first start costs 7-18 s
    on the card's machine and does not hold the interpreter, so untimed
    work (a build, correctness checks, set-up) runs beside it;
    :func:`_warmed` joins it before the first timed region.  Kineto then
    prints "External init callback must run in same thread as
    registerClient": the later sessions, from the main thread, record the
    card's kernels all the same."""
    import threading

    def warm():
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            pass

    thread = threading.Thread(target=warm, daemon=True)
    thread.start()
    _WARMING.append(thread)


def _warmed(ctx=None) -> float:
    """Join this process's :func:`_warm_profiler` threads, so that nothing
    timed runs beside one; with ``ctx`` (a rank's), a barrier of all the
    ranks after it, so that no rank starts a clock while rank 0 still
    waits.  Returns the seconds it took."""
    t0 = time.perf_counter()
    while _WARMING:
        _WARMING.pop().join()
    if ctx is not None:
        import torch.distributed as tdist

        tdist.barrier()
    return time.perf_counter() - t0


def _profile(step, label: str, top: int = 8) -> dict:
    """Device time by kernel name over one call of ``step()`` from
    ``torch.profiler`` (this process's kernels), and the host-clock wall
    time around it; busy over wall gives the idle share.  Prints the
    ``top`` kernels.  The profiler records the card's activity only: the
    host's ops too slowed a profiled training step of rwkv6-3b and tripled
    the time to sum its 41,000 kernels.  Also reports the seconds the
    profiler took to start (a process's first start is the slow one), to
    stop, and :func:`_kernel_rows` to sum."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    join_s = _warmed()
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
    t2 = time.perf_counter()
    rows = _kernel_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    start_s, stop_s, sum_s = t0 - t_start, t2 - t1, time.perf_counter() - t2
    lines = [f"breakdown {label}: the profiler saw no device time (not measured)"]
    if rows:
        lines = [f"breakdown {label}: wall {wall_ms:.3f} ms, device busy "
                 f"{busy_ms:.3f} ms, idle {1 - busy_ms / wall_ms:.1%}, "
                 f"{sum(r[1] for r in rows)} kernels (the profiler started in "
                 f"{start_s:.3f} s after {join_s:.3f} s waiting for its warm-up, stopped "
                 f"in {stop_s:.3f} s, its kernels summed in {sum_s:.3f} s)"]
        lines += [f"  {ms:9.3f} ms {ms / busy_ms:6.1%} x{c:<4d} {k[:90]}"
                  for ms, c, k in rows[:top]]
    return {"label": label, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "start_s": start_s, "warm_join_s": join_s, "stop_s": stop_s, "sum_s": sum_s,
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
    r["warm_wait_s"] = _warmed(ctx)
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
    if ctx.rank == 0 and ctx.device.type == "cuda":
        _warm_profiler()  # beside the wire's check and run (a)'s set-up
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

    if ctx.rank == 0 and ctx.device.type == "cuda":
        _warm_profiler()  # beside the first run's set-up and checks

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
        r["warm_wait_s"] = _warmed(ctx)
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
    t0 = time.perf_counter()
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
    out["serve_s"] = time.perf_counter() - t0
    return out


def serve_grid_gates(smi, ranks):
    """Phase 10 (c)'s gates, on the results of its 4 ranks (run last in
    phase 13's spawn, :func:`_sharded_ranks`); returns the kernels'
    launches summed over the ranks."""
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
    say(f"[{smi}] {tag}: 4 rank processes (phase 13's, after its runs) in "
        f"{r0['serve_s']:.1f} s; {st['n_requests']} requests in {st['wall_s']:.3f} s, "
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
    launches = dict.fromkeys(SERVE_KERNELS, 0)
    for r in ranks:
        for k in SERVE_KERNELS:
            launches[k] += r["counts"][k]
    return [{k: v for k, v in r.items() if k != "solos"} for r in ranks], launches


def serving(smi):
    """Phase 10 (a), (b): serving on the card; returns the results and the
    kernel launches of its runs (the bursts, the paced run).  (c), the 2x2
    burst, runs in phase 13's spawn (:func:`serve_grid_gates`)."""
    out = {"1x1": []}
    solos = None
    for backend in SERVE_BACKENDS:
        r, s = _serve_1x1(smi, backend)
        out["1x1"].append(r)
        solos = solos or s
    out["threaded"] = _serve_threaded(smi, solos)
    launches = dict.fromkeys(SERVE_KERNELS, 0)
    for counts in [r["counts"] for r in out["1x1"]] + [out["threaded"]["counts"]]:
        for k in SERVE_KERNELS:
            launches[k] += counts[k]
    return out, launches


# ---------------------------------------------------------------------------
# phase 11: the fleet (repro_torch.fleet): supervised workers, kill and resume
# ---------------------------------------------------------------------------

FLEET_DIR = os.path.join(HERE, "build", "chip_smoke_fleet")
# N=256 (the script's time limit): a snapshot is 1/8 of N=512's (the fused payload
# of (b) still rides: a power-of-two row on the peer-mapped wire)
FLEET_N = 256
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
    profiler saw (none where ``prof`` is None), as ``path``."""
    doc = {"rc": rc, "counts": {**_counts(), **_ring_counts()}, **extra,
           "kernels": [{"ms": ms, "count": c, "name": k[:120]}
                       for ms, c, k in (_kernel_rows(prof) if prof else [])]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def _fleet_profiler(profiled: bool):
    """``torch.profiler`` of the card's kernels, or nothing: its first
    start costs a process ~8 s (the H100 machine), worth paying only where
    it sees kernels that a document keeps."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA]) if profiled else \
        contextlib.nullcontext()


def _killed(active) -> bool:
    """Whether an attempt's faults kill it: it then writes no document."""
    return any(f.kind == "kill-at-step" for f in active)


def _fleet_rank(ctx, spec, attempt, active):
    """The fleet worker's rank function (``repro_torch.fleet.worker.
    _rank_main``) under ``torch.profiler`` (not in an attempt that its
    faults kill), in each rank process of a ``--fleet-worker`` job of
    several ranks; writes ``<job>.attempt<A>.rank<r>.kernels.json``.  A
    killed rank writes nothing."""
    import torch

    from repro_torch.fleet import worker

    with _fleet_profiler(not _killed(active)) as prof:
        rc = worker._rank_main(ctx, spec, attempt, active)
        torch.cuda.synchronize(ctx.device)
    base = spec["result_path"][:-len(".result.json")]
    _write_kernels(f"{base}.attempt{attempt}.rank{ctx.rank}.kernels.json", rc, prof)
    return rc


def fleet_worker(argv) -> int:
    """``chip_smoke.py --fleet-worker --spec S --attempt A``: the
    controller's worker (``repro_torch.fleet.worker.main``) under
    ``torch.profiler`` where it runs the job itself (1x1) and its faults
    do not kill it, its ranks' function wrapped by :func:`_fleet_rank`.
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

    from repro_torch.fleet import faults, worker

    t_imported = time.time()
    worker._rank_main = _fleet_rank
    attempt = int(argv[argv.index("--attempt") + 1]) if "--attempt" in argv else 0
    alone = all(int(d) == 1 for d in spec["mesh"])
    killed = _killed(faults.plan_from_env().active(spec["job_id"], attempt))
    with _fleet_profiler(alone and not killed) as prof:
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
    # the snapshots are 128 MiB a field: drop them once the campaign is read
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
# phases 12 and 13 (a)-(c), (e) train it at full width cut to its first
# TRAIN_LAYERS of 32 layers (``launch/train.py --layers``; phase 16 took
# the room): 12, the least depth whose remat is two-level as the full
# model's (two groups of 6; 8 layers would be one group, a single level);
# phase 13 (d) serves it at full depth, as phase 8 does
TRAIN_LAYERS = 12
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


def _check_grads(label, got, want, loss, loss_want, tol, stage="training (a)"):
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
    say(f"{stage} {label}: loss {loss:.6f} against the plain attention's "
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
    return ["--arch", TRAIN_ARCH, "--layers", str(TRAIN_LAYERS), "--steps", str(TRAIN_STEPS),
            "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1", *extra]


def _train_cfg():
    """Phase 12's config: TRAIN_ARCH cut to its first TRAIN_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)


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
    """Phase 12: training of smollm-360m at full width, cut to
    TRAIN_LAYERS layers, on the card; returns the results and (b)'s
    ``flash_attention`` launches."""
    import math

    from repro_torch.kernels import attention
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = _train_cfg()
    group = T._remat_group(cfg.n_layers)
    if not 1 < group < cfg.n_layers:
        fail(f"training: {cfg.n_layers} layers make remat groups of {group}, a single "
             "level; the cut must keep the full model's two-level remat")
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
# (d) phase 8's serving on 2x2, teacher-forced with phase 8's first
# MESH_GEN tokens: the dense decode, the sequence-sharded decode
# (RunCfg.seq_shard_kv: the cache's time axis over data, the batch whole)
# with a control that combines with each rank's local max (SHARD_CONTROL_GEN
# tokens), and the int8 cache (kv_quant) against phase 8's int8 run;
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
# (d): the tokens of the local-max control's run; every other serving run
# on 2x2 (here and in phases 14 (b) and 15 (c)) serves MESH_GEN tokens
SHARD_CONTROL_GEN = 2
LM_ONLY = "--lm-only"


def _shard_counts():
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import attention, ring_rdma

    return {"flash_attention": attention.launches,
            "flash_attention_plain": attention.plain_calls,
            "pad_copies": attention.pad_copies, **_wkv_counts(),
            "ring_send": ring_rdma.send_launches,
            "ring_land": ring_rdma.land_launches, "wire_bytes": C.wire_bytes,
            **{f"collectives.{k}": n for k, n in C.calls.items()}}


def _zero_shard_counts():
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import attention, ring_rdma

    attention.launches = attention.plain_calls = attention.pad_copies = 0
    _zero_wkv_counts()
    ring_rdma.send_launches = ring_rdma.land_launches = 0
    C.wire_bytes = 0
    for k in C.calls:
        C.calls[k] = 0


def _shard_steps(ctx, cfg, steps, *, lr=None, compressed=False, profile=False,
                 after_step=None):
    """``steps`` steps of ``cfg`` on this rank's mesh (``ctx`` None: on one
    device; the compressed step with ``compressed``), each synchronised
    and timed, from counts set to 0; the counts, the peak, the params'
    change after MOVED_AFTER steps; with ``profile`` one more step under
    ``torch.profiler`` on rank 0.  ``lr`` overrides the learning rate (0:
    the update left out).  ``after_step(cfg, run, model)``, read after each
    step outside the timing, goes to ``after_step``."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed import compression as comp
    from repro_torch.launch import mesh as M
    from repro_torch.optim import adamw
    from repro_torch.training.train_loop import TrainCfg, cut_axes, make_train_step

    run, model, _ = M.rank_setup(cfg, ctx, "cuda", remat=cfg.remat)
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
    times, losses, gnorms, moved, after = [], [], [], {}, []
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
        if after_step is not None:
            after.append(after_step(cfg, run, model))
    out = {"step_ms": times, "losses": losses, "gnorms": gnorms,
           "counts": _shard_counts(), "peak_bytes": torch.cuda.max_memory_allocated(),
           "breakdown": None, "after_step": after}
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


def _local_max(fn):
    """``fn()`` with every max all-reduce left out (each rank keeps its
    own): (d)'s control, whose sequence-sharded combine then weighs each
    slab by its rank's local max in place of the global one."""
    from repro_torch.distributed import collectives as C

    reduce = C.all_reduce
    C.all_reduce = lambda x, axes, op="sum": x if op == "max" else reduce(x, axes, op)
    try:
        return fn()
    finally:
        C.all_reduce = reduce


def _serve_part(ctx, cfg, run, model, tokens, forced, gen, *, timed=True):
    """One of (d)'s serving runs on this rank, counts from 0: ``gen``
    tokens teacher-forced with ``forced``; with ``timed`` after a warm-up,
    and then one more decode step on its cache, counted alone (a decode
    step's collectives and wire bytes).  Rank 0 keeps the gathered
    logits."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    if timed:
        serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_shard_counts()
    forced = torch.from_numpy(forced[:, :gen]).to(ctx.device)
    r = serve.generate(cfg, run, model, tokens, gen, forced=forced, keep_logits=True)
    counts = _shard_counts()
    out = {"prefill_ms": r["prefill_ms"], "decode_ms_per_step": r["decode_ms"] / (gen - 1),
           "counts": counts, "peak_bytes": torch.cuda.max_memory_allocated(),
           "cache_shape": {k: list(t.shape) for k, t in r["cache"].items() if k != "len"},
           "cache_bytes": _cache_bytes(r["cache"])}
    if timed:
        brun = T.batch_run(run, tokens.shape[0])
        _zero_shard_counts()
        T.decode_step(cfg, brun, model, r["cache"], T.local_rows(forced[:, -1:], brun))
        torch.cuda.synchronize()
        out["decode_step_counts"] = {k: v for k, v in _shard_counts().items()
                                     if k.startswith("collectives.") or k == "wire_bytes"}
    if ctx.rank == 0:  # numpy: a rank's result crosses to the parent pickled
        out["tokens"] = r["tokens"].cpu().numpy()
        out["logits"] = [x.float().cpu().numpy() for x in r["logits"]]
    del r
    torch.cuda.empty_cache()
    return out


def _shard_serve(ctx, cfg, forced):
    """(d): phase 8's prompts on 2x2, teacher-forced with phase 8's tokens:
    the dense decode, the sequence-sharded one and its local-max control,
    and the int8 cache."""
    import dataclasses

    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve

    run, model, _ = M.rank_setup(cfg, ctx, None)
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, ctx.device)
    seq = dataclasses.replace(run, seq_shard_kv=True)
    out = {"dense": _serve_part(ctx, cfg, run, model, tokens, forced, MESH_GEN),
           "seq": _serve_part(ctx, cfg, seq, model, tokens, forced, MESH_GEN),
           "seq_control": _local_max(lambda: _serve_part(
               ctx, cfg, seq, model, tokens, forced, SHARD_CONTROL_GEN, timed=False)),
           "int8": _serve_part(ctx, dataclasses.replace(cfg, kv_quant=True), run, model,
                               tokens, forced, MESH_GEN)}
    del model
    return out


def _sharded_ranks(ctx, forced, rwkv_args=None, serve_grid=False):
    """Everything phase 13's 4 rank processes do, (a) to (e), and then
    phase 16 (c) (with ``rwkv_args``) and phase 10 (c) (with
    ``serve_grid``), in the processes already started."""
    import torch.distributed as tdist

    from repro_torch.configs import get_config
    from repro_torch.kernels import ring_rdma
    from repro_torch.launch import mesh as M

    cfg = _train_cfg()
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
    out["serve"] = _shard_serve(ctx, get_config(TRAIN_ARCH), forced)
    if rwkv_args is not None:
        out["rwkv"] = _rwkv_ranks(ctx, *rwkv_args)
    if serve_grid:
        out["serve_grid"] = _serve_ranks(ctx)
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


def sharded_lm(smi, trained, served, rwkv_kept=None, serve_grid=False):
    """Phase 13: smollm-360m at full width sharded over a 2x2 mesh of rank
    processes on the one card (one spawn, re-cut between meshes), against
    phases 12 and 8; returns the results and the kernels' launches summed
    over the ranks.  Every reading is printed before the gates fail.  With
    ``rwkv_kept`` (phase 16 (a)'s), the spawn runs phase 16 (c) last, its
    ranks' results under ``rwkv_ranks`` (gated by :func:`rwkv_mesh`); with
    ``serve_grid``, phase 10 (c) after it, under ``serve_ranks`` (gated by
    :func:`serve_grid_gates`)."""
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
    rwkv_args = None if rwkv_kept is None else _rwkv_rank_args(rwkv_kept)
    ranks = dist.run_ranks(_sharded_ranks, 2, 2, device="cuda",
                           args=(served["tokens"].numpy(), rwkv_args, serve_grid),
                           timeout=1200)
    rwkv_ranks = [r.pop("rwkv") for r in ranks] if rwkv_kept is not None else None
    serve_ranks = [r.pop("serve_grid") for r in ranks] if serve_grid else None
    spawn_s = time.perf_counter() - t0
    # (b) the 2x2 run's step-3 checkpoint resumed on one device, steps 4-5
    t0 = time.perf_counter()
    resumed = train.main(_train_argv("--ckpt-dir", os.path.join(SHARD_DIR, "2x2"),
                                     "--halt-after", "6"))
    resume_1x1_s = time.perf_counter() - t0
    out = {"spawn_s": spawn_s, "ranks": ranks, "resume_1x1": resumed,
           "resume_1x1_s": resume_1x1_s, "rwkv_ranks": rwkv_ranks,
           "serve_ranks": serve_ranks}
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
    cfg = _train_cfg()
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
    d = {k: v for k, v in r0["serve"].items()}
    for part in d.values():
        part["logits"] = [torch.from_numpy(x) for x in part["logits"]]
    want = served["logits"][:MESH_GEN]
    gaps = {"dense": _logit_gaps(want, d["dense"]["logits"]),
            "seq": _logit_gaps(want, d["seq"]["logits"]),
            "seq vs dense 2x2": _logit_gaps(d["dense"]["logits"], d["seq"]["logits"]),
            "control": _logit_gaps(want, d["seq_control"]["logits"]),
            "control vs dense 2x2": _logit_gaps(d["dense"]["logits"],
                                                d["seq_control"]["logits"]),
            "int8": _logit_gaps(served["int8_logits"][:MESH_GEN],
                                d["int8"]["logits"])}
    agree = _top1_agree(d["dense"]["logits"], want)
    for label, part in (("dense", d["dense"]), ("sequence-sharded", d["seq"]),
                        ("int8 cache", d["int8"])):
        say(f"[{smi}] sharded LM (d) serving 2x2 {label} B={LM_BATCH} prompt={LM_PROMPT} "
            f"gen={MESH_GEN}, teacher-forced with phase 8's tokens: prefill "
            f"{part['prefill_ms']:.3f} ms, decode {part['decode_ms_per_step']:.3f} ms/step "
            f"on rank 0; cache a rank {part['cache_shape']} {part['cache_bytes']} B; a "
            f"decode step's {part['decode_step_counts']}; counts {part['counts']}")
    say(f"[{smi}] sharded LM (d) logits against phase 8's 1x1: dense prefill "
        f"{gaps['dense'][0]:.3e}, decode max {max(gaps['dense'][1:]):.3e} (greedy choices "
        f"agree on {agree:.1%}); sequence-sharded {gaps['seq'][0]:.3e}, "
        f"{max(gaps['seq'][1:]):.3e}, against the dense 2x2 "
        f"{max(gaps['seq vs dense 2x2']):.3e}; int8 against phase 8's int8 "
        f"{gaps['int8'][0]:.3e}, {max(gaps['int8'][1:]):.3e} (tol {LM_TOL_BF16:g} of "
        f"max|logit|)")
    refused_local = [k for k in ("control", "control vs dense 2x2")
                     if max(gaps[k]) > LM_TOL_BF16]
    say(f"[{smi}] sharded LM (d) control, the sequence-sharded combine with each rank's "
        f"local max ({SHARD_CONTROL_GEN} tokens): against phase 8's 1x1 decode max "
        f"{max(gaps['control'][1:]):.3e}, against the dense 2x2 "
        f"{max(gaps['control vs dense 2x2'][1:]):.3e}: "
        f"{'refused by ' + ', '.join(refused_local) if refused_local else 'PASSED'}")
    for r in ranks:
        for label in ("dense", "seq", "int8", "seq_control"):
            cd = r["serve"][label]["counts"]
            if cd["flash_attention"] != get_config(TRAIN_ARCH).n_layers \
                    or cd["flash_attention_plain"]:
                bad.append(f"(d) {label} rank {r['rank']}: counts {cd}")
    for label in ("dense", "seq", "seq vs dense 2x2", "int8"):
        if max(gaps[label]) > LM_TOL_BF16:
            bad.append(f"(d) {label}: logits gap {max(gaps[label]):.3e} > {LM_TOL_BF16}")
    if not refused_local:
        bad.append("(d): the gates pass the combine with each rank's local max")
    if tuple(d["dense"]["tokens"].shape) != (LM_BATCH, MESH_GEN):
        bad.append(f"(d): tokens {tuple(d['dense']['tokens'].shape)}")
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
                     *(r["serve"][k]["counts"] for k in ("dense", "seq", "int8"))):
            for k in launches:
                launches[k] += part[k]
    out.update(loss_gaps=loss_gaps, gnorm_gaps=gnorm_gaps, ms_per_step=ms,
               per_step=per_step, peaks=peaks, peak_1x1=limit, resume_gaps=b_gaps,
               compressed_gaps=c_gaps, logit_gaps=gaps, greedy_agree=agree,
               launches=launches, refused={"update": refused_update, "sync": refused_sync,
                                           "local_max": refused_local})
    for r in ranks:
        for part in r["serve"].values():
            part.pop("logits", None)
            part.pop("tokens", None)
    shutil.rmtree(SHARD_DIR, ignore_errors=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] sharded LM: phase 13 in {out['phase_s']:.3f} s (spawn and ranks "
        f"{spawn_s:.3f} s)")
    if bad:
        fail("sharded LM " + "; ".join(bad))
    return out, launches


# ---------------------------------------------------------------------------
# phase 14: the MoE (qwen3-moe-30b-a3b) served and trained on one card, and
# expert-parallel over a 2x2 mesh of rank processes
# ---------------------------------------------------------------------------

# full width (d 2048, 32 heads on 4 kv heads, 128 experts top-8, expert
# d_ff 768, vocab 151936); the one cut: 48 layers -> MOE_LAYERS (f32
# params 12.46 GB, training state 49.8 GB on one 80 GB card)
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_LAYERS = 4
MOE_BATCH, MOE_PROMPT, MOE_GEN = 8, 2048, 16
# every correctness gate runs at this capacity factor, where nothing
# drops (the reference's EP test's), so that 2x2 and 1x1 compare: their
# capacity rules differ; the timed runs take the config's 1.25
MOE_GATE_CF = 8.0
# (a) the index dispatch against the one-hot plain version on one layer,
# bf16: max|d| <= MOE_DISPATCH_TOL · max|plain| (the same bf16 products
# summed in another order; tests/test_torch_moe.py holds 2e-2)
MOE_DISPATCH_T, MOE_DISPATCH_TOL = 512, 2e-2
# (c) steps at 1.25 on one device (the first apart), and the gate's steps
# at MOE_GATE_CF on 1x1 and 2x2; (d) steps at 1.25 on 2x2
MOE_TIMED_STEPS, MOE_GATE_STEPS, MOE_MESH_STEPS = 4, 3, 3
# (d) against (c) at MOE_GATE_CF, relative: each step's loss and gnorm and
# the params' change after 3 steps.  The gnorm and change gates sit between
# the sound reading and the control's (2x2 with the experts' gradients left
# out) on the H100 (PERF.md, phase 14): gnorm sound at most 1.60e-3, the
# control's at least 7.70e-3; change sound 1.45e-5, the control's 0.637.
# The loss cannot tell them apart (sound 3.80e-4, 2.07e-4, 1.16e-4; the
# control's 3.80e-4, 1.64e-4, 2.01e-4: step 0 is before any update, and a
# tenth of the tokens route to other experts on 2x2 than on one device,
# unpinned), so its gate is a bound on the sound reading only
MOE_LOSS_TOL, MOE_GNORM_TOL, MOE_MOVED_TOL = 1e-3, 4e-3, 1e-3
MOE_ONLY = "--moe-only"


def _moe_cfg(cf=None):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _record(fn):
    """``fn()`` on one device with its expert choices recorded: (its
    result, the choices of each MoE call in order)."""
    from repro_torch.models import moe as MOE

    MOE.routing = {"record": []}
    try:
        return fn(), MOE.routing["record"]
    finally:
        MOE.routing = None


def _first_steps(record, gen: int) -> list:
    """The expert choices of a serving run of ``gen`` tokens (a prefill,
    then ``gen - 1`` decode steps, the same MoE calls each) cut to its
    first MESH_GEN: the prefill's and the first MESH_GEN - 1 steps'."""
    return record[:len(record) // gen * MESH_GEN]


def _replay(fn, record):
    """``fn()`` with each MoE call's expert choices pinned to ``record``'s:
    (its result, the share of tokens whose own choice differed)."""
    from repro_torch.models import moe as MOE

    MOE.routing = {"replay": record, "at": 0, "flips": 0, "tokens": 0}
    try:
        out = fn()
        if MOE.routing["at"] != len(record):
            fail(f"MoE: a replay took {MOE.routing['at']} of {len(record)} recorded "
                 "routings")
        return out, float(MOE.routing["flips"]) / max(MOE.routing["tokens"], 1)
    finally:
        MOE.routing = None


def _moe_dispatch_check(cfg, model, tokens):
    """(a): block 0's MoE on MOE_DISPATCH_T tokens (their normed
    embeddings), bf16: the index dispatch against the one-hot plain
    version, and both timed."""
    import torch

    from repro_torch.models import common as cm
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    p = T._cast_f(model.blocks[0].ff, torch.bfloat16)
    m = T.moe_dims(cfg)
    x = cm.rms_norm(model.embed[tokens[:1, :MOE_DISPATCH_T].long()].bfloat16(),
                    model.blocks[0].ln2.w)
    got, dropped = MOE.count_drops(lambda: MOE.apply_moe(p, m, x))
    want = MOE.apply_moe_plain(p, m, x)
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    out = {"tokens": MOE_DISPATCH_T, "err": err, "tol": MOE_DISPATCH_TOL,
           "dropped": dropped,
           "index_ms": _time_ms(lambda: MOE.apply_moe(p, m, x), 10, 2),
           "plain_ms": _time_ms(lambda: MOE.apply_moe_plain(p, m, x), 5, 1)}
    say(f"MoE (a) one layer at T={MOE_DISPATCH_T} bf16: the index dispatch against the "
        f"one-hot plain version max|d| {err:.3e} of max|plain| (tol {MOE_DISPATCH_TOL:g}), "
        f"{out['dropped']:.2%} of the pairs dropped; index {out['index_ms']:.4f} ms, "
        f"one-hot {out['plain_ms']:.4f} ms")
    if not err <= MOE_DISPATCH_TOL or not bool(torch.isfinite(got).all()):
        fail(f"MoE (a): the index dispatch is {err:.3e} of max|plain| from the one-hot one")
    return out


def _moe_serve_1x1(smi, cfg):
    """(a): qwen3-moe cut to MOE_LAYERS layers, bf16, B=8, prompt 2048, 32
    tokens through ``launch/serve.py``'s ``generate`` at capacity factor
    1.25: one ``flash_attention`` launch a layer, no plain call; logits
    within LM_TOL_BF16 · max|logit| of the plain attention's, teacher-
    forced; the one-layer dispatch check; a profiled prefill.  Then the
    same prompts at MOE_GATE_CF: (b)'s tokens and logits."""
    import torch

    from repro_torch.kernels import attention
    from repro_torch.launch import serve
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    run, plain_run = T.RunCfg(), T.RunCfg(plain_attention=True)
    model = T.init_model(cfg, seed=0, device="cuda")
    tokens = serve.prompt_tokens(cfg, MOE_BATCH, MOE_PROMPT, "cuda")
    serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention.plain_calls = attention.pad_copies = 0
    (r, record), dropped = MOE.count_drops(lambda: _record(lambda: serve.generate(
        cfg, run, model, tokens, MOE_GEN, keep_logits=True)))
    counts = {"flash_attention": attention.launches,
              "flash_attention_plain": attention.plain_calls,
              "pad_copies": attention.pad_copies}
    peak = torch.cuda.max_memory_allocated()
    steps = MOE_GEN - 1
    out = {"arch": MOE_ARCH, "layers": MOE_LAYERS, "counts": counts,
           "prefill_ms": r["prefill_ms"], "decode_ms_per_step": r["decode_ms"] / steps,
           "tok_per_s": steps * MOE_BATCH / (r["decode_ms"] / 1e3), "peak_bytes": peak,
           "dropped": dropped}
    say(f"[{smi}] MoE (a) {MOE_ARCH} ({MOE_LAYERS} layers) 1x1 bf16 B={MOE_BATCH} "
        f"prompt={MOE_PROMPT} gen={MOE_GEN}, capacity factor {cfg.moe.capacity_factor}: "
        f"prefill {r['prefill_ms']:.3f} ms, decode {out['decode_ms_per_step']:.3f} ms/step "
        f"({out['tok_per_s']:.1f} tok/s), peak {peak / 2**30:.3f} GiB, {dropped:.4%} of "
        f"the pairs dropped; counts {counts}")
    if counts != {"flash_attention": cfg.n_layers, "flash_attention_plain": 0,
                  "pad_copies": 0}:
        fail(f"MoE (a): counts {counts}, want {cfg.n_layers} launches, no plain call")
    if tuple(r["tokens"].shape) != (MOE_BATCH, MOE_GEN) or not all(
            bool(torch.isfinite(x).all()) for x in r["logits"]) or \
            tuple(r["logits"][0].shape) != (MOE_BATCH, 1, cfg.vocab):
        fail(f"MoE (a): tokens {tuple(r['tokens'].shape)}, logits "
             f"{tuple(r['logits'][0].shape)} or not finite")
    # the plain attention's run, teacher-forced: its own routing, then
    # pinned to the kernel run's (the gate: the same discrete choices)
    free = serve.generate(cfg, plain_run, model, tokens, MOE_GEN, forced=r["tokens"],
                          keep_logits=True)
    free_gaps = _logit_gaps(r["logits"], free["logits"])
    del free
    p, flips = _replay(lambda: serve.generate(cfg, plain_run, model, tokens, MOE_GEN,
                                              forced=r["tokens"], keep_logits=True), record)
    gaps = _logit_gaps(r["logits"], p["logits"])
    out.update(gap_prefill=gaps[0], gap_decode_max=max(gaps[1:]), tol=LM_TOL_BF16,
               flips=flips, free_gap_prefill=free_gaps[0],
               free_gap_decode_max=max(free_gaps[1:]))
    say(f"MoE (a) kernel vs plain attention (bf16, teacher-forced), the plain run's "
        f"expert choices pinned to the kernel run's: logits gap prefill {gaps[0]:.3e}, "
        f"decode steps max {max(gaps[1:]):.3e} of max|logit| (tol {LM_TOL_BF16:g}); "
        f"its own top-8 differed for {flips:.3%} of the tokens a layer; unpinned the "
        f"gaps are {free_gaps[0]:.3e}, {max(free_gaps[1:]):.3e}")
    if max(gaps) > LM_TOL_BF16:
        fail(f"MoE (a): kernel and plain attention logits differ by {max(gaps):.3e}")
    del p, record
    out["dispatch"] = _moe_dispatch_check(cfg, model, tokens)
    prof = _profile(lambda: T.prefill(cfg, run, model, {"tokens": tokens},
                                      t_max=MOE_PROMPT + MOE_GEN),
                    f"MoE prefill {MOE_ARCH} ({MOE_LAYERS} layers) B={MOE_BATCH} "
                    f"S={MOE_PROMPT}", top=10)
    for line in prof["lines"]:
        say(line)
    out["breakdown"] = prof
    del r
    torch.cuda.empty_cache()
    cfg8 = _moe_cfg(MOE_GATE_CF)
    r8, record8 = _record(lambda: serve.generate(cfg8, run, model, tokens, MOE_GEN,
                                                 keep_logits=True))
    kept = {"tokens": r8["tokens"].cpu(), "logits": [x.float().cpu() for x in r8["logits"]],
            "routing": [t.cpu().numpy() for t in record8]}
    out["gate_cf"] = {"prefill_ms": r8["prefill_ms"],
                      "decode_ms_per_step": r8["decode_ms"] / steps}
    del model, r8
    torch.cuda.empty_cache()
    return out, kept, counts["flash_attention"]


def _moe_train_1x1(smi, cfg):
    """(c): step 0's gradients through the kernel path against the plain
    attention's (phase 12's gate), MOE_TIMED_STEPS steps at 1.25 (ms/step,
    tokens/s, peak, the share dropped), and MOE_GATE_STEPS steps at
    MOE_GATE_CF: (d)'s reference."""
    import statistics

    import torch

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels import attention
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    # no remat here: a replay pins each MoE call once, in order
    run = T.RunCfg(remat=False)
    model = T.init_model(cfg, seed=0, device="cuda")
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    tokens = torch.from_numpy(pipe.batch_for_step(0)["tokens"]).cuda()
    attention.launches = attention.plain_calls = 0
    (loss, got), record = _record(lambda: _train_grads(cfg, run, model, tokens))
    counts = [attention.launches, attention.plain_calls]
    (loss_p, want), flips = _replay(lambda: _train_grads(
        cfg, T.RunCfg(plain_attention=True, remat=False), model, tokens), record)
    ok, grads = _check_grads("bfloat16, the plain run's expert choices pinned to the "
                             "kernel run's", got, want, loss, loss_p,
                             TRAIN_GRAD_TOL["bfloat16"], stage="MoE (c)")
    say(f"MoE (c): the plain run's own top-8 differed for {flips:.3%} of the tokens a layer")
    grads.update(counts=counts, flips=flips)
    del got, want, model
    torch.cuda.empty_cache()
    if counts != [cfg.n_layers, 0]:
        fail(f"MoE (c): the kernel path made {counts} launches and plain calls, "
             f"want [{cfg.n_layers}, 0]")
    per_step = T.block_forwards(cfg, T.RunCfg(remat=cfg.remat))
    if not ok:
        fail("MoE (c): the kernel path's gradients fail the gate")
    timed, dropped = MOE.count_drops(lambda: _shard_steps(None, cfg, MOE_TIMED_STEPS))
    timed["dropped"] = dropped
    ms = statistics.median(timed["step_ms"][1:])
    launches = counts[0] + timed["counts"]["flash_attention"]
    gate = _shard_steps(None, _moe_cfg(MOE_GATE_CF), MOE_GATE_STEPS)
    launches += gate["counts"]["flash_attention"]
    out = {"grads": grads, "timed": timed, "gate": gate, "ms_per_step": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
           "launches_per_step": per_step}
    say(f"[{smi}] MoE (c) training 1x1 bf16 remat B={TRAIN_BATCH} S={TRAIN_SEQ}, capacity "
        f"factor {cfg.moe.capacity_factor}: {ms:.3f} ms/step (median of "
        f"{MOE_TIMED_STEPS - 1}; {', '.join(f'{t:.3f}' for t in timed['step_ms'])}), "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {timed['peak_bytes'] / 2**30:.3f} GiB, "
        f"{timed['dropped']:.4%} of the pairs dropped, losses "
        f"{[round(x, 4) for x in timed['losses']]}; flash_attention "
        f"{timed['counts']['flash_attention'] / MOE_TIMED_STEPS:g} launches a step")
    say(f"MoE (c) at capacity factor {MOE_GATE_CF:g}: losses {gate['losses']}, gnorms "
        f"{gate['gnorms']}, the params' change {gate['moved']}")
    bad = [x for x in timed["losses"] + gate["losses"] if not x == x or abs(x) == float("inf")]
    if bad or timed["counts"]["flash_attention"] != MOE_TIMED_STEPS * per_step or \
            timed["counts"]["flash_attention_plain"]:
        fail(f"MoE (c): losses {timed['losses']}, counts {timed['counts']}")
    return out, launches


def _moe_experts_left_out(ctx, cfg, steps):
    """(d)'s control: the steps with the experts' gradients set to zero
    before the update."""
    import torch

    from repro_torch.optim import adamw

    update = adamw.update

    def without(c, grads, *args, **kw):
        grads = {n: torch.zeros_like(g) if ".ff.experts." in n else g
                 for n, g in grads.items()}
        return update(c, grads, *args, **kw)

    adamw.update = without
    try:
        return _shard_steps(ctx, cfg, steps)
    finally:
        adamw.update = update


def _moe_counts_of(fn):
    """The shard counts of one call of ``fn``, from 0."""
    import torch

    torch.cuda.synchronize()
    _zero_shard_counts()
    fn()
    torch.cuda.synchronize()
    return _shard_counts()


def _moe_ranks(ctx, forced8, routing8, mla=None):
    """Everything phase 14's 4 rank processes do: (b) serving on 2x2 at
    MOE_GATE_CF (teacher-forced with (a)'s tokens there) and at 1.25;
    (d) training at MOE_GATE_CF, its control, and at 1.25; then, with
    ``mla`` (phase 15 (c)'s forced tokens and expert choices), phase 15
    (c) with the qwen3-moe runs' memory freed."""
    import statistics

    import torch
    import torch.distributed as tdist

    from repro_torch.kernels import ring_rdma
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg, cfg8 = _moe_cfg(), _moe_cfg(MOE_GATE_CF)
    out = {"rank": ctx.rank}
    run, model, _ = M.rank_setup(cfg, ctx, None)
    tokens = serve.prompt_tokens(cfg, MOE_BATCH, MOE_PROMPT, ctx.device)
    serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    _zero_shard_counts()
    r8, flips = _replay(lambda: serve.generate(
        cfg8, run, model, tokens, MESH_GEN,
        forced=torch.from_numpy(forced8[:, :MESH_GEN]).to(ctx.device), keep_logits=True),
        [torch.from_numpy(a) for a in _first_steps(routing8, MOE_GEN)])
    out["serve8"] = {"counts": _shard_counts(), "flips": flips}
    if ctx.rank == 0:  # numpy: a rank's result crosses to the parent pickled
        out["serve8"]["logits"] = [x.float().cpu().numpy() for x in r8["logits"]]
    del r8
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_shard_counts()
    r, dropped = MOE.count_drops(lambda: serve.generate(cfg, run, model, tokens, MESH_GEN))
    counts = _shard_counts()
    local = T.local_rows(tokens, run)
    pre = {}
    c_pre = _moe_counts_of(lambda: pre.update(zip(("logits", "cache"), T.prefill(
        cfg, run, model, {"tokens": local}, t_max=MOE_PROMPT + MESH_GEN))))
    c_dec = _moe_counts_of(lambda: T.decode_step(cfg, run, model, pre["cache"],
                                                 pre["logits"][:, -1].argmax(-1)[:, None]))
    out["serve"] = {"prefill_ms": r["prefill_ms"], "decode_ms_per_step":
                    r["decode_ms"] / (MESH_GEN - 1), "counts": counts, "dropped": dropped,
                    "prefill_counts": c_pre, "decode_counts": c_dec,
                    "peak_bytes": torch.cuda.max_memory_allocated(),
                    "tokens_shape": list(r["tokens"].shape)}
    del model, r, pre
    torch.cuda.empty_cache()
    out["free_before_train"] = torch.cuda.mem_get_info()[0]
    out["train8"] = _shard_steps(ctx, cfg8, MOE_GATE_STEPS)
    out["control"] = _moe_experts_left_out(ctx, cfg8, MOE_GATE_STEPS)
    out["train"], dropped = MOE.count_drops(lambda: _shard_steps(ctx, cfg, MOE_MESH_STEPS))
    out["train"]["dropped"] = dropped
    out["train"]["ms_per_step"] = statistics.median(out["train"]["step_ms"][1:])
    if mla is not None:
        torch.cuda.empty_cache()
        out["mla"] = _mla_ranks_part(ctx, *mla)
    wires = dict(ctx.wires())
    out["wires"] = sorted(f"{k}: {type(w).__name__}" for k, w in wires.items())
    out["wires_ipc"] = all(isinstance(w, ring_rdma.IpcWire) for w in wires.values())
    out["backend"] = tdist.get_backend()
    return out


def moe_lm(smi, mla_kept=None):
    """Phase 14: qwen3-moe at full width (cut to MOE_LAYERS layers), (a)
    served and (c) trained on one card, (b) served and (d) trained
    expert-parallel on 2x2 (one spawn of 4 rank processes on the card;
    every all-to-all on the peer-mapped wire); returns the results and the
    kernels' launches (flash_attention, ring_send, ring_land).  With
    ``mla_kept`` (:func:`mla_lm`'s) the spawn's ranks then run phase 15
    (c), whose results go to ``out["mla_ranks"]`` for :func:`mla_mesh`.
    Every reading is printed before the gates fail."""
    import torch

    from repro_torch import dist
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = _moe_cfg()
    served, kept8, flash_a = _moe_serve_1x1(smi, cfg)
    trained, flash_c = _moe_train_1x1(smi, cfg)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    say(f"MoE: before the 2x2 spawn this process holds {torch.cuda.memory_reserved() / 2**30:.3f}"
        f" GiB reserved; the card has {free / 2**30:.3f} of {total / 2**30:.3f} GiB free")
    # four ranks hold 49.8 GB of training state on the one card: the
    # allocator's expandable segments keep their fragmentation down
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    t0 = time.perf_counter()
    try:
        mla = None if mla_kept is None else _mla_rank_args(mla_kept)
        ranks = dist.run_ranks(_moe_ranks, 2, 2, device="cuda",
                               args=(kept8["tokens"].numpy(), kept8["routing"], mla),
                               timeout=1200)
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    spawn_s = time.perf_counter() - t0
    bad = []
    r0 = ranks[0]
    # (b) serving on 2x2
    got8 = [torch.from_numpy(x) for x in r0["serve8"]["logits"]]
    gaps8 = _logit_gaps(kept8["logits"], got8)
    sv = r0["serve"]
    steps = MOE_GEN - 1
    per = {k: sv["decode_counts"][k] for k in ("collectives.all_to_all", "wire_bytes",
                                                "ring_send", "ring_land")}
    say(f"[{smi}] MoE (b) serving 2x2 (EP, 4 ranks on one card) at capacity factor "
        f"{MOE_GATE_CF:g}, teacher-forced with (a)'s tokens there and its expert choices "
        f"pinned to (a)'s: logits gap prefill {gaps8[0]:.3e}, decode max "
        f"{max(gaps8[1:]):.3e} of max|logit| (tol {LM_TOL_BF16:g}); rank 0's own top-8 "
        f"differed for {r0['serve8']['flips']:.3%} of its tokens a layer")
    say(f"[{smi}] MoE (b) serving 2x2 at {cfg.moe.capacity_factor}: prefill "
        f"{sv['prefill_ms']:.3f} ms, decode {sv['decode_ms_per_step']:.3f} ms/step on rank 0 "
        f"(1x1: {served['prefill_ms']:.3f}, {served['decode_ms_per_step']:.3f}); "
        f"{sv['dropped']:.4%} of the pairs dropped; a prefill: all_to_all "
        f"{sv['prefill_counts']['collectives.all_to_all']}, wire bytes "
        f"{sv['prefill_counts']['wire_bytes']}; a decode step: {per}; peak GiB by rank "
        f"{[round(r['serve']['peak_bytes'] / 2**30, 3) for r in ranks]}")
    if max(gaps8) > LM_TOL_BF16:
        bad.append(f"(b): logits gap {max(gaps8):.3e} > {LM_TOL_BF16}")
    for r in ranks:
        for key in ("serve8", "serve"):
            c = r[key]["counts"]
            if c["flash_attention"] != cfg.n_layers or c["flash_attention_plain"] or \
                    c["pad_copies"] or not c["collectives.all_to_all"] or \
                    not (c["ring_send"] > 0 and c["ring_land"] > 0):
                bad.append(f"(b) {key} rank {r['rank']}: counts {c}")
        if not r["wires_ipc"] or r["backend"] != "gloo":
            bad.append(f"rank {r['rank']}: wires {r['wires']}, default group "
                       f"{r['backend']}: a CUDA tensor's collective off the peer-mapped wire")
    if r0["serve"]["tokens_shape"] != [MOE_BATCH, MESH_GEN]:
        bad.append(f"(b): tokens {r0['serve']['tokens_shape']}")
    # (d) training on 2x2 against (c), at MOE_GATE_CF, and the control
    ref = trained["gate"]
    d8, ctl, d = r0["train8"], r0["control"], r0["train"]
    say(f"[{smi}] MoE (d) training 2x2 at capacity factor {MOE_GATE_CF:g}: "
        + _steps_line("against 1x1", d8, ref, "1x1")
        + f" (tol loss {MOE_LOSS_TOL:g}, gnorm {MOE_GNORM_TOL:g}, change {MOE_MOVED_TOL:g})")
    refused = _step_faults("control", ctl, ref, MOE_LOSS_TOL, MOE_GNORM_TOL, MOE_MOVED_TOL)
    say(f"[{smi}] MoE (d) control, the experts' gradients left out: "
        + _steps_line("against 1x1", ctl, ref, "1x1")
        + f"; {'refused: ' + '; '.join(refused) if refused else 'PASSED'}")
    bad += _step_faults("(d)", d8, ref, MOE_LOSS_TOL, MOE_GNORM_TOL, MOE_MOVED_TOL)
    if not refused:
        bad.append("(d): the gates pass the run without the experts' gradients")
    dper = {k: v / MOE_MESH_STEPS for k, v in d["counts"].items()}
    say(f"[{smi}] MoE (d) training 2x2 at {cfg.moe.capacity_factor}: "
        f"{d['ms_per_step']:.3f} ms/step on rank 0 (median of {MOE_MESH_STEPS - 1}; "
        f"{', '.join(f'{t:.3f}' for t in d['step_ms'])}; 1x1 {trained['ms_per_step']:.3f}); "
        f"losses {[round(x, 4) for x in d['losses']]}; {d['dropped']:.4%} of the pairs "
        f"dropped; peak GiB by rank {[round(r['train']['peak_bytes'] / 2**30, 3) for r in ranks]}"
        f" (1x1 {trained['timed']['peak_bytes'] / 2**30:.3f}; the card's free GiB as each "
        f"rank began training {[round(r['free_before_train'] / 2**30, 3) for r in ranks]}); "
        f"a step on rank 0: "
        f"all_to_all {dper['collectives.all_to_all']:g}, wire bytes {dper['wire_bytes']:.0f}, "
        f"ring_send {dper['ring_send']:g}, ring_land {dper['ring_land']:g}, flash "
        f"{dper['flash_attention']:g}")
    want_flash = T.block_forwards(cfg, T.RunCfg(remat=cfg.remat))
    for r in ranks:
        for key, n in (("train8", MOE_GATE_STEPS), ("train", MOE_MESH_STEPS)):
            c = r[key]["counts"]
            if c["flash_attention"] != n * want_flash or c["flash_attention_plain"] or \
                    not c["collectives.all_to_all"] or not c["ring_land"]:
                bad.append(f"(d) {key} rank {r['rank']}: counts {c}")
    launches = {"flash_attention": flash_a + flash_c, "ring_send": 0, "ring_land": 0}
    for r in ranks:
        for part in (r["serve8"]["counts"], r["serve"]["counts"], r["train8"]["counts"],
                     r["control"]["counts"], r["train"]["counts"]):
            for k in launches:
                launches[k] += part[k]
    mla_ranks = [{"rank": r["rank"], "mla": r.pop("mla"), "wires": r["wires"],
                  "wires_ipc": r["wires_ipc"], "backend": r["backend"]}
                 for r in ranks if "mla" in r]
    out = {"serve_1x1": served, "train_1x1": trained, "ranks": ranks, "spawn_s": spawn_s,
           "serve_gaps_gate_cf": gaps8, "refused": refused, "launches": launches,
           "mla_ranks": mla_ranks}
    for r in ranks:
        r["serve8"].pop("logits", None)
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] MoE: phase 14 in {out['phase_s']:.3f} s (spawn and ranks {spawn_s:.3f} s)")
    if bad:
        fail("MoE " + "; ".join(bad))
    return out, launches


# ---------------------------------------------------------------------------
# phase 15: MLA (deepseek-v2-lite-16b) served at full depth and trained on
# one card, and sharded over 2x2 inside phase 14's spawn
# ---------------------------------------------------------------------------

# full width (d 2048, 16 heads, MLA kv_lora 512, nope 128, rope 64, v 128;
# 64 experts top-6, expert d_ff 1408, 2 shared at d_ff 2816; the first
# block dense at d_ff 10944; vocab 102400, untied): (a) at full depth, 27
# layers (15.706 B params, 62.83 GB in f32); (b) and (c) cut to
# MLA_TRAIN_LAYERS (1 dense + 3 MoE: 2.255 B params, 36.1 GB of training
# state with gradients and both moments)
MLA_ARCH = "deepseek-v2-lite-16b"
MLA_TRAIN_LAYERS = 4
MLA_BATCH, MLA_PROMPT, MLA_GEN = 8, 2048, 16
# (a) the plain attention's, the control's and the broken attentions' runs
# serve the first MLA_CHECK_GEN of the kernel run's tokens, teacher-forced
MLA_CHECK_GEN = 8
# (a) one MLA layer at B=8, S=2048, bf16: the decompressed form on the
# kernel against the plain latent form, max|d| <= MLA_LAYER_TOL·max|latent|
# (two bf16 roundings of one function: the scores through c_kv·W_uk or
# through q_nope·W_ukᵀ)
MLA_LAYER_TOL = 2e-2
# (a) the bf16 logits through 27 layers part from the plain attention's by
# far more than phase 8's 32 dense layers do (the drift of bf16 roundings
# through 26 MoE layers with random routers), so the end-to-end bf16 gate
# is calibrated on a control that is a correct attention of the same
# arithmetic (``attention.bf16_control``: unblocked f32 scores and P·V,
# rounded once; phase 3 accepts it): the kernel run's gap to the plain
# run at most MLA_DRIFT_RATIO times the control's, or LM_TOL_BF16.  Every
# layer's kernel output is held to the plain one's on the plain run's own
# q, k, v by phase 3's bf16 rule, and the f32 run of the whole depth
# (prompt MLA_F32_PROMPT, MLA_F32_GEN tokens) to LM_TOL_F32
MLA_DRIFT_RATIO = 2.0
# (a) broken attentions (``attention.bf16_control``'s, in every layer of
# the plain run), each with whether that bound must refuse it: a key tile
# dropped must be (0.567 against 0.215 on the H100, PERF.md); p rounded to
# bf16 before P·V passes it (0.104), a fault that only the per-layer check
# (phase 3's rule refuses it) and the f32 run can see
MLA_BROKEN = (("key tile dropped", {"drop_tile": True}, True),
              ("p rounded to bf16", {"round_p": True}, False))
MLA_F32_PROMPT, MLA_F32_GEN = 512, 8
# (b) steps at the config's capacity factor 1.25 (the first apart); (c)
# steps at MLA_GATE_CF on 1x1 and on 2x2 (bf16 and f32), and the f32
# control's steps on 2x2
MLA_TIMED_STEPS, MLA_GATE_STEPS, MLA_CONTROL_STEPS = 4, 3, 3
# (c) compares 2x2 with 1x1 at a capacity factor where neither capacity
# rule drops a pair: E / k rounded up (64 / 6 -> 11), so that every
# expert's buffer holds every token of its slab.  Phase 14's 8.0 is not
# enough here: deepseek's random routers send most tokens of a slab to the
# same few experts (at 1.25 the dense rule drops 15 % of (b)'s pairs), and
# at 8.0 the expert-parallel rule (a capacity a chunk of tokens) and the
# dense rule (one capacity over the batch) still drop, different pairs: the
# f32 serving of 2x2 then parts from 1x1's by a whole max|logit| on the
# H100 (PERF.md, phase 15).  Beside the bf16 serving, its f32 run (the
# same params, no cast; prompt MLA_F32_PROMPT, MLA_F32_GEN tokens) is held
# to LM_TOL_F32 of 1x1's.  The training steps cannot be pinned (a replay
# pins no call under autograd).  In bf16 a twentieth of the tokens route
# elsewhere on 2x2, and the gnorm parts from 1x1's by up to 1.3e-2 on the
# H100 (PERF.md): its loss and params' change are gated, its gnorm shown.
# The same steps in f32 (the same params, no cast) are held to 1x1's f32
# steps by loss, gnorm and change (MLA_F32_TOLS), and so is a control that
# those gates must refuse: MLA's latent weights (w_dkv, w_kr, kv_norm,
# whole over ``model``) with their gradients left unsummed there, each
# rank's share from its own heads only.  On the H100 (PERF.md) the sound
# f32 steps part from 1x1's by at most 7.9e-5 (loss), 1.9e-3 (gnorm) and
# 6.2e-5 (change); the control by 1.1e-1 (gnorm) and 1.6e-3 (change)
MLA_GATE_CF = 11.0
MLA_F32_TOLS = (MOE_LOSS_TOL, MOE_GNORM_TOL, MOE_MOVED_TOL)
# (c), a reading and not a gate: step 0's f32 gradients at MLA_GATE_CF on
# 2x2 with the expert choices pinned to 1x1's (a replay: remat off), each
# leaf's norm against 1x1's.  The unpinned f32 steps' gnorm parts from
# 1x1's by ~3e-4 on the H100 (1.8e-7 on the CPU); a gap pinned above
# MLA_PINNED_GAP is a fault of the port, a smaller one leaves the routing's
# flips to explain it
MLA_PINNED_GAP = 1e-5
MLA_ONLY = "--mla-only"


def _mla_cfg(layers=None, cf=None):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(MLA_ARCH)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if cf is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    return cfg


def _mla_layer_check(cfg, p, x):
    """(a): one MLA layer (block 0's weights ``p`` in bf16, its normed
    input ``x``, B=8, S=2048): the decompressed form on the kernel against
    the plain latent form, and both timed."""
    import torch

    from repro_torch.models import mla as MLA
    from repro_torch.models import transformer as T

    m = T.mla_dims(cfg)
    b, s = x.shape[:2]
    pos = torch.arange(s, device=x.device)[None].expand(b, s)
    got = MLA.apply_mla(p, m, x, pos)[0]
    want = MLA.apply_mla_latent(p, m, x, pos)[0]
    err = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
    finite = bool(torch.isfinite(got).all())
    out = {"err": err, "tol": MLA_LAYER_TOL, "finite": finite,
           "ok": finite and err <= MLA_LAYER_TOL,
           "kernel_form_ms": _time_ms(lambda: MLA.apply_mla(p, m, x, pos), 10, 2),
           "latent_form_ms": _time_ms(lambda: MLA.apply_mla_latent(p, m, x, pos), 5, 1)}
    say(f"MLA (a) one layer at B={b} S={s} bf16: the decompressed form on the kernel "
        f"(D={m.qk_nope_dim + m.qk_rope_dim}) against the plain latent form max|d| "
        f"{err:.3e} of max|latent| (tol {MLA_LAYER_TOL:g}); the layer "
        f"{out['kernel_form_ms']:.4f} ms against {out['latent_form_ms']:.4f} ms")
    return out


def _mla_probe(gaps):
    """``flash_attention_plain`` with the kernel run beside it on the same
    q, k and v, their bf16 gap (phase 3's rule) appended to ``gaps``; it
    returns the plain output, so the run stays the plain one."""
    from repro_torch.kernels import attention

    plain = attention.flash_attention_plain

    def probe(q, k, v, *, causal=True, **kw):
        want = plain(q, k, v, causal=causal, **kw)
        gaps.append(attention.bf16_gap(attention.flash_attention(q, k, v, causal=causal),
                                       want))
        return want
    return probe


def _mla_control(q, k, v, *, causal=True, **kw):
    """The control attention of (a): unblocked f32 scores and P·V, rounded
    once (``attention.bf16_control``, causal)."""
    from repro_torch.kernels import attention

    return attention.bf16_control(q, k, v)


def _mla_attend_as(fn, run):
    """``run()`` with MLA's plain attention replaced by ``fn``."""
    from repro_torch.models import mla as MLA

    plain = MLA.flash_attention_plain
    MLA.flash_attention_plain = fn
    try:
        return run()
    finally:
        MLA.flash_attention_plain = plain


def _mla_f32(cfg, model, tokens):
    """(a) in f32 (the same f32 params, no cast), prompt MLA_F32_PROMPT,
    MLA_F32_GEN tokens: the kernel's run against the plain attention's,
    teacher-forced and pinned, every step's logits gap."""
    import dataclasses

    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    prompt = tokens[:, :MLA_F32_PROMPT]
    r, record = _record(lambda: serve.generate(cfg32, T.RunCfg(), model, prompt,
                                               MLA_F32_GEN, keep_logits=True))
    p, flips = _replay(lambda: serve.generate(
        cfg32, T.RunCfg(plain_attention=True), model, prompt, MLA_F32_GEN,
        forced=r["tokens"], keep_logits=True), record)
    gaps = _logit_gaps(r["logits"], p["logits"])
    return {"gaps": gaps, "flips": flips, "tol": LM_TOL_F32,
            "prefill_ms": r["prefill_ms"]}


def _mla_serve_1x1(smi):
    """(a): deepseek-v2-lite at full width and depth, bf16, B=8, prompt
    2048, 32 tokens through ``launch/serve.py``'s ``generate`` at capacity
    factor 1.25: one ``flash_attention`` launch a layer (D=192), no plain
    call, no pad copy.  Then the plain attention's run of the first
    MLA_CHECK_GEN tokens, teacher-forced and its expert choices pinned,
    every layer's kernel output beside the
    plain one on the same q, k, v (phase 3's bf16 rule), and the
    control's run (:func:`_mla_control`) the same way: the kernel run's
    logits gap to the plain run within MLA_DRIFT_RATIO times the
    control's (or LM_TOL_BF16), a bound the broken attentions of
    MLA_BROKEN are held to; the f32 runs (:func:`_mla_f32`) within
    LM_TOL_F32; then the one-layer check.  Returns the results and the
    kernel's launches."""
    import torch

    from repro_torch.kernels import attention
    from repro_torch.launch import serve
    from repro_torch.models import common as cm
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg = _mla_cfg()
    run, plain_run = T.RunCfg(), T.RunCfg(plain_attention=True)
    model = T.init_model(cfg, seed=0, device="cuda")
    params = sum(p.numel() for p in model.parameters())
    tokens = serve.prompt_tokens(cfg, MLA_BATCH, MLA_PROMPT, "cuda")
    serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.launches = attention.plain_calls = attention.pad_copies = 0
    (r, record), dropped = MOE.count_drops(lambda: _record(lambda: serve.generate(
        cfg, run, model, tokens, MLA_GEN, keep_logits=True)))
    counts = {"flash_attention": attention.launches,
              "flash_attention_plain": attention.plain_calls,
              "pad_copies": attention.pad_copies}
    peak = torch.cuda.max_memory_allocated()
    steps = MLA_GEN - 1
    m = cfg.mla
    t = MLA_PROMPT + MLA_GEN
    cache_bytes = sum(r["cache"][k].numel() * r["cache"][k].element_size()
                      for k in ("k", "v"))
    full_kv = cfg.n_layers * MLA_BATCH * t * cfg.n_heads * (
        m.qk_nope_dim + m.qk_rope_dim + m.v_head_dim) * 2
    out = {"arch": MLA_ARCH, "layers": cfg.n_layers, "params": params, "counts": counts,
           "prefill_ms": r["prefill_ms"], "decode_ms_per_step": r["decode_ms"] / steps,
           "tok_per_s": steps * MLA_BATCH / (r["decode_ms"] / 1e3), "peak_bytes": peak,
           "dropped": dropped, "cache_bytes": cache_bytes,
           "decompressed_cache_bytes": full_kv}
    say(f"[{smi}] MLA (a) {MLA_ARCH} ({cfg.n_layers} layers, {params / 1e9:.3f} B params, "
        f"f32) 1x1 bf16 B={MLA_BATCH} prompt={MLA_PROMPT} gen={MLA_GEN}, capacity factor "
        f"{cfg.moe.capacity_factor}: prefill {r['prefill_ms']:.3f} ms, decode "
        f"{out['decode_ms_per_step']:.3f} ms/step ({out['tok_per_s']:.1f} tok/s), peak "
        f"{peak / 2**30:.3f} GiB, {dropped:.4%} of the pairs dropped; the compressed cache "
        f"{cache_bytes} B at T={t} (a decompressed {cfg.n_heads}-head K at D="
        f"{m.qk_nope_dim + m.qk_rope_dim} and V at D={m.v_head_dim}: {full_kv} B); "
        f"counts {counts}")
    if counts != {"flash_attention": cfg.n_layers, "flash_attention_plain": 0,
                  "pad_copies": 0}:
        fail(f"MLA (a): counts {counts}, want {cfg.n_layers} launches, no plain call")
    if tuple(r["tokens"].shape) != (MLA_BATCH, MLA_GEN) or not all(
            bool(torch.isfinite(x).all()) for x in r["logits"]) or \
            tuple(r["logits"][0].shape) != (MLA_BATCH, 1, cfg.vocab):
        fail(f"MLA (a): tokens {tuple(r['tokens'].shape)}, logits "
             f"{tuple(r['logits'][0].shape)} or not finite")
    def plain_run_of():
        return serve.generate(cfg, plain_run, model, tokens, MLA_CHECK_GEN,
                              forced=r["tokens"][:, :MLA_CHECK_GEN], keep_logits=True)

    record = record[:len(record) // MLA_GEN * MLA_CHECK_GEN]  # those tokens' choices
    layer_gaps = []
    p, flips = _mla_attend_as(_mla_probe(layer_gaps), lambda: _replay(plain_run_of, record))
    gaps = _logit_gaps(r["logits"], p["logits"])
    c, c_flips = _mla_attend_as(_mla_control, lambda: _replay(plain_run_of, record))
    c_gaps = _logit_gaps(c["logits"], p["logits"])
    del c
    bound = max(LM_TOL_BF16, MLA_DRIFT_RATIO * max(c_gaps))
    broken = {}
    for label, kw, _ in MLA_BROKEN:
        def attend(q, k, v, *, causal=True, kw=kw, **_):
            return attention.bf16_control(q, k, v, **kw)
        b_run, _ = _mla_attend_as(attend, lambda: _replay(plain_run_of, record))
        broken[label] = max(_logit_gaps(b_run["logits"], p["logits"]))
        del b_run
    worst = max(layer_gaps, key=lambda g: g["worst"])
    out.update(gap_prefill=gaps[0], gap_decode_max=max(gaps[1:]), flips=flips,
               control_gap_prefill=c_gaps[0], control_gap_decode_max=max(c_gaps[1:]),
               control_flips=c_flips, bound=bound, drift_ratio=MLA_DRIFT_RATIO,
               layer_gaps=layer_gaps, broken=broken)
    say(f"MLA (a) kernel vs plain attention (bf16, teacher-forced), the plain run's "
        f"expert choices pinned to the kernel run's: logits gap prefill {gaps[0]:.3e}, "
        f"decode steps max {max(gaps[1:]):.3e} of max|logit|; its own top-6 differed for "
        f"{flips:.3%} of the tokens a layer.  The control (unblocked f32 attention, "
        f"rounded once) vs plain the same way: prefill {c_gaps[0]:.3e}, decode max "
        f"{max(c_gaps[1:]):.3e} ({c_flips:.3%} flips); the bound max({LM_TOL_BF16:g}, "
        f"{MLA_DRIFT_RATIO:g} x control) = {bound:.3e}; broken attentions (every "
        f"layer's) against it: "
        + ", ".join(f"{k} {g:.3e} ({'refused' if g > bound else 'accepted'})"
                    for k, g in broken.items())
        + "; the kernel's own gates: every layer's output (below) and the f32 run")
    say(f"MLA (a) every layer's kernel output on the plain run's q, k, v "
        f"({len(layer_gaps)} calls): worst {worst['worst']:.3f} of the element bound, "
        f"mismatch up to {max(g['mismatch'] for g in layer_gaps):.3%}; "
        f"{sum(g['ok'] for g in layer_gaps)} pass phase 3's bf16 rule")
    f32 = _mla_f32(cfg, model, tokens)
    out["f32"] = f32
    say(f"MLA (a) f32 (prompt {MLA_F32_PROMPT}, {MLA_F32_GEN} tokens, the same params): "
        f"kernel vs plain logits gap prefill {f32['gaps'][0]:.3e}, decode max "
        f"{max(f32['gaps'][1:]):.3e} of max|logit| (tol {LM_TOL_F32:g}); the plain run's "
        f"own top-6 differed for {f32['flips']:.3%}; kernel prefill {f32['prefill_ms']:.3f} ms")
    bad = []
    if max(gaps) > bound:
        bad.append(f"bf16 logits gap {max(gaps):.3e} > {bound:.3e}")
    for label, _, refuse in MLA_BROKEN:
        if refuse and not broken[label] > bound:
            bad.append(f"the bf16 bound {bound:.3e} accepts the broken attention ({label}: "
                       f"{broken[label]:.3e})")
    if len(layer_gaps) != cfg.n_layers or not all(g["ok"] for g in layer_gaps):
        bad.append(f"{len(layer_gaps)} layer checks, {sum(g['ok'] for g in layer_gaps)} pass")
    if max(f32["gaps"]) > LM_TOL_F32:
        bad.append(f"f32 logits gap {max(f32['gaps']):.3e} > {LM_TOL_F32:g}")
    block = model.first_blocks[0]
    p0 = {n: w.detach().bfloat16() for n, w in block.attn.named_parameters()}
    x = cm.rms_norm(model.embed[tokens.long()].bfloat16(), block.ln1.w)
    del model, r, p, record
    torch.cuda.empty_cache()
    out["layer"] = _mla_layer_check(cfg, p0, x)
    if not out["layer"]["ok"]:
        bad.append(f"one layer's forms {out['layer']['err']:.3e} apart")
    del p0, x
    torch.cuda.empty_cache()
    out["faults"] = [f"(a) {b}" for b in bad]
    return out, counts["flash_attention"]


def _mla_train_1x1(smi):
    """(b): deepseek-v2-lite cut to MLA_TRAIN_LAYERS, B=8, S=512, remat:
    step 0's gradients through the kernel path against the plain
    attention's (phase 12's gate; the expert choices pinned),
    MLA_TIMED_STEPS steps at 1.25 (ms/step, tokens/s, peak, the share
    dropped); then (c)'s references at MLA_GATE_CF, where no pair drops:
    serving in bf16 and in f32 (tokens, logits, expert choices) and
    MLA_GATE_STEPS bf16 steps."""
    import dataclasses
    import math
    import statistics

    import torch

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels import attention
    from repro_torch.launch import serve
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T

    cfg, cfg8 = _mla_cfg(MLA_TRAIN_LAYERS), _mla_cfg(MLA_TRAIN_LAYERS, MLA_GATE_CF)
    run = T.RunCfg(remat=False)  # a replay pins each MoE call once, in order
    model = T.init_model(cfg, seed=0, device="cuda")
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    tokens = torch.from_numpy(pipe.batch_for_step(0)["tokens"]).cuda()
    attention.launches = attention.plain_calls = 0
    (loss, got), record = _record(lambda: _train_grads(cfg, run, model, tokens))
    counts = [attention.launches, attention.plain_calls]
    (loss_p, want), flips = _replay(lambda: _train_grads(
        cfg, T.RunCfg(plain_attention=True, remat=False), model, tokens), record)
    ok, grads = _check_grads("bfloat16, the plain run's expert choices pinned to the "
                             "kernel run's", got, want, loss, loss_p,
                             TRAIN_GRAD_TOL["bfloat16"], stage="MLA (b)")
    grads.update(counts=counts, flips=flips)
    del got, want
    model.requires_grad_(False)
    # (c)'s serving references (bf16; f32 at MLA_F32_PROMPT), their expert
    # choices recorded for the ranks; the 4 layers' own bf16 drift: the
    # plain attention's run against the kernel's, pinned
    prompt = serve.prompt_tokens(cfg, MLA_BATCH, MLA_PROMPT, "cuda")
    (r8, record8), dropped8 = MOE.count_drops(lambda: _record(lambda: serve.generate(
        cfg8, T.RunCfg(), model, prompt, MLA_GEN, keep_logits=True)))
    p8, flips8 = _replay(lambda: serve.generate(
        cfg8, T.RunCfg(plain_attention=True), model, prompt, MLA_GEN, forced=r8["tokens"],
        keep_logits=True), record8)
    gaps8 = _logit_gaps(r8["logits"], p8["logits"])
    say(f"MLA (b) serving {MLA_TRAIN_LAYERS} layers 1x1 at capacity factor {MLA_GATE_CF:g} "
        f"(bf16; {dropped8:.4%} of the pairs dropped), kernel vs plain attention pinned: "
        f"logits gap prefill {gaps8[0]:.3e}, decode max {max(gaps8[1:]):.3e}; {flips8:.3%} of "
        f"the plain run's own top-6 differ")
    kept = {"tokens": r8["tokens"].cpu(), "logits": [x.float().cpu() for x in r8["logits"]],
            "routing": [t.cpu().numpy() for t in record8], "plain_gaps": gaps8,
            "dropped": dropped8}
    del r8, p8, record8
    cfg32 = dataclasses.replace(cfg8, compute_dtype="float32")
    r32, record32 = _record(lambda: serve.generate(
        cfg32, T.RunCfg(), model, prompt[:, :MLA_F32_PROMPT], MLA_F32_GEN, keep_logits=True))
    kept["f32"] = {"tokens": r32["tokens"].cpu(), "logits": [x.cpu() for x in r32["logits"]],
                   "routing": [t.cpu().numpy() for t in record32]}
    del r32, record32
    # (c)'s pinned reading: step 0's f32 gradient norms a leaf, its routing
    (loss0, g0), record0 = _record(lambda: _train_grads(cfg32, run, model, tokens))
    kept["grad0"] = {"loss": loss0, "routing": [t.cpu().numpy() for t in record0],
                     "norms": {n: float(g.double().norm()) for n, g in g0.items()}}
    del model, g0, record0
    torch.cuda.empty_cache()
    bad = []
    if counts != [cfg.n_layers, 0]:
        bad.append(f"the kernel path made {counts} launches and plain calls, "
                   f"want [{cfg.n_layers}, 0]")
    if not ok:
        bad.append("the kernel path's gradients fail the gate")
    per_step = T.block_forwards(cfg, T.RunCfg(remat=cfg.remat))
    timed, dropped = MOE.count_drops(lambda: _shard_steps(None, cfg, MLA_TIMED_STEPS))
    timed["dropped"] = dropped
    ms = statistics.median(timed["step_ms"][1:])
    gate, gate_dropped = MOE.count_drops(lambda: _shard_steps(None, cfg8, MLA_GATE_STEPS))
    gate["dropped"] = gate_dropped
    gate32, gate32_dropped = MOE.count_drops(lambda: _shard_steps(None, cfg32, MLA_GATE_STEPS))
    gate32["dropped"] = gate32_dropped
    launches = counts[0] + sum(part["counts"]["flash_attention"]
                               for part in (timed, gate, gate32))
    out = {"grads": grads, "timed": timed, "gate": gate, "gate32": gate32, "ms_per_step": ms,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (ms / 1e3),
           "launches_per_step": per_step}
    say(f"[{smi}] MLA (b) training 1x1 ({MLA_TRAIN_LAYERS} layers) bf16 remat "
        f"B={TRAIN_BATCH} S={TRAIN_SEQ}, capacity factor {cfg.moe.capacity_factor}: "
        f"{ms:.3f} ms/step (median of {MLA_TIMED_STEPS - 1}; "
        f"{', '.join(f'{t:.3f}' for t in timed['step_ms'])}), "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {timed['peak_bytes'] / 2**30:.3f} GiB, "
        f"{timed['dropped']:.4%} of the pairs dropped, losses "
        f"{[round(x, 4) for x in timed['losses']]}; flash_attention "
        f"{timed['counts']['flash_attention'] / MLA_TIMED_STEPS:g} launches a step "
        f"(want {per_step}); the plain run's own top-6 differed for {flips:.3%} of the "
        f"tokens a layer")
    for label, part in (("bf16", gate), ("f32", gate32)):
        say(f"MLA (b) at capacity factor {MLA_GATE_CF:g}, {label}: losses {part['losses']}, "
            f"gnorms {part['gnorms']}, the params' change {part['moved']}, "
            f"{part['dropped']:.4%} of the pairs dropped; "
            f"{', '.join(f'{t:.3f}' for t in part['step_ms'])} ms a step")
    if not all(math.isfinite(x) for x in timed["losses"] + gate["losses"] + gate32["losses"]):
        bad.append(f"losses {timed['losses']}, {gate['losses']}, {gate32['losses']}")
    if dropped8 or gate_dropped or gate32_dropped:
        bad.append(f"pairs dropped at capacity factor {MLA_GATE_CF:g}: {dropped8:.4%}, "
                   f"{gate_dropped:.4%}, {gate32_dropped:.4%}")
    for part, n in ((timed, MLA_TIMED_STEPS), (gate, MLA_GATE_STEPS),
                    (gate32, MLA_GATE_STEPS)):
        if part["counts"]["flash_attention"] != n * per_step or \
                part["counts"]["flash_attention_plain"]:
            bad.append(f"counts {part['counts']}")
    out["faults"] = [f"(b) {b}" for b in bad]
    return out, kept, launches


def mla_lm(smi):
    """Phase 15's runs on one card: (a) serving at full depth, (b)
    training cut to MLA_TRAIN_LAYERS and (c)'s 1x1 references.  Returns
    the results, what (c) compares with, and the kernel's launches."""
    t0 = time.perf_counter()
    served, flash_a = _mla_serve_1x1(smi)
    trained, kept, flash_b = _mla_train_1x1(smi)
    out = {"serve_1x1": served, "train_1x1": trained,
           "one_card_s": time.perf_counter() - t0}
    say(f"[{smi}] MLA: (a) and (b) on one card in {out['one_card_s']:.3f} s")
    kept["train_gate"], kept["train_gate32"] = trained["gate"], trained["gate32"]
    return out, kept, flash_a + flash_b


def _mla_pinned_grads(ctx, cfg, routing0):
    """(c)'s pinned reading on this rank: step 0's gradients of ``cfg``
    (f32 at MLA_GATE_CF) with the expert choices pinned to the 1x1 run's
    (``routing0``; remat off, so that the replay meets each MoE call once);
    each leaf's norm over the mesh (its shards' squares summed over the
    axes that cut it)."""
    import math

    import torch

    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.distributed import collectives as C
    from repro_torch.launch import mesh as M
    from repro_torch.models import transformer as T
    from repro_torch.training.train_loop import cut_axes

    run, model, _ = M.rank_setup(cfg, ctx, None, remat=False)
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH))
    tokens = torch.from_numpy(pipe.batch_for_step(0)["tokens"]).cuda()
    (loss, grads), flips = _replay(
        lambda: _train_grads(cfg, run, model, T.local_rows(tokens, run)),
        [torch.from_numpy(a) for a in routing0])
    cut = cut_axes(cfg, run)
    groups: dict = {}
    for name in grads:
        groups.setdefault(tuple(cut[name]), []).append(name)
    norms = {}
    for axes, names in groups.items():
        sq = torch.stack([grads[n].double().square().sum() for n in names])
        sq = C.all_reduce(sq, axes, "sum") if axes else sq
        norms.update({n: math.sqrt(float(x)) for n, x in zip(names, sq)})
    del model, grads
    torch.cuda.empty_cache()
    return {"loss": loss, "norms": norms, "flips": flips}


def _mla_ranks_part(ctx, forced8, routing8, f32, routing0):
    """(c) on one rank of the 2x2 spawn: serving at MLA_GATE_CF,
    teacher-forced with (b)'s 1x1 tokens and its expert choices pinned,
    in bf16 and (``f32``: the 1x1 f32 run's tokens and choices) in f32;
    then MLA_GATE_STEPS training steps at MLA_GATE_CF in bf16 and in f32,
    the f32 control's MLA_CONTROL_STEPS, and the pinned reading of step
    0's gradients (``routing0``, :func:`_mla_pinned_grads`)."""
    from repro_torch.models import moe as MOE

    import dataclasses

    import torch

    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve

    cfg8 = _mla_cfg(MLA_TRAIN_LAYERS, MLA_GATE_CF)
    cfg32 = dataclasses.replace(cfg8, compute_dtype="float32")
    out = {"free_at_start": torch.cuda.mem_get_info()[0]}
    run, model, _ = M.rank_setup(cfg8, ctx, None)
    tokens = serve.prompt_tokens(cfg8, MLA_BATCH, MLA_PROMPT, ctx.device)
    serve.generate(cfg8, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_shard_counts()
    (r8, flips), dropped = MOE.count_drops(lambda: _replay(lambda: serve.generate(
        cfg8, run, model, tokens, MESH_GEN,
        forced=torch.from_numpy(forced8[:, :MESH_GEN]).to(ctx.device), keep_logits=True),
        [torch.from_numpy(a) for a in _first_steps(routing8, MLA_GEN)]))
    out["serve8"] = {"counts": _shard_counts(), "flips": flips, "dropped": dropped,
                     "prefill_ms": r8["prefill_ms"],
                     "decode_ms_per_step": r8["decode_ms"] / (MESH_GEN - 1),
                     "peak_bytes": torch.cuda.max_memory_allocated()}
    r32, flips32 = _replay(lambda: serve.generate(
        cfg32, run, model, tokens[:, :MLA_F32_PROMPT], MLA_F32_GEN,
        forced=torch.from_numpy(f32[0]).to(ctx.device), keep_logits=True),
        [torch.from_numpy(a) for a in f32[1]])
    out["serve32"] = {"flips": flips32}
    if ctx.rank == 0:  # numpy: a rank's result crosses to the parent pickled
        out["serve8"]["logits"] = [x.float().cpu().numpy() for x in r8["logits"]]
        out["serve32"]["logits"] = [x.cpu().numpy() for x in r32["logits"]]
    del model, r8, r32
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["train8"], out["train_dropped"] = MOE.count_drops(
        lambda: _shard_steps(ctx, cfg8, MLA_GATE_STEPS))
    out["train32"], out["train32_dropped"] = MOE.count_drops(
        lambda: _shard_steps(ctx, cfg32, MLA_GATE_STEPS))
    out["control32"] = _mla_latents_unsummed(ctx, cfg32, MLA_CONTROL_STEPS)
    out["grad0"] = _mla_pinned_grads(ctx, cfg32, routing0)
    return out


def _mla_latents_unsummed(ctx, cfg, steps):
    """(c)'s control: the steps with MLA's latent weights' gradients left
    unsummed over ``model`` (``mla._shared`` left out: each rank's share
    from its own heads only)."""
    from repro_torch.models import mla as MLA

    shared = MLA._shared
    MLA._shared = lambda p, tp: p
    try:
        return _shard_steps(ctx, cfg, steps)
    finally:
        MLA._shared = shared


def _mla_rank_args(kept):
    """The ranks' inputs of (c) from :func:`mla_lm`'s ``kept``: the 1x1
    runs' forced tokens and expert choices, bf16 and f32 (numpy: they
    cross to the ranks pickled)."""
    return (kept["tokens"].numpy(), kept["routing"],
            (kept["f32"]["tokens"].numpy(), kept["f32"]["routing"]),
            kept["grad0"]["routing"])


def _mla_ranks(ctx, forced8, routing8, f32, routing0):
    """``--mla-only``'s spawn: (c) alone."""
    import torch.distributed as tdist

    from repro_torch.kernels import ring_rdma

    part = _mla_ranks_part(ctx, forced8, routing8, f32, routing0)
    wires = dict(ctx.wires())
    return {"rank": ctx.rank, "mla": part,
            "wires": sorted(f"{k}: {type(w).__name__}" for k, w in wires.items()),
            "wires_ipc": all(isinstance(w, ring_rdma.IpcWire) for w in wires.values()),
            "backend": tdist.get_backend()}


def _pinned_reading(smi, one, two) -> dict:
    """(c)'s pinned reading: step 0's f32 gradient norms a leaf on 2x2
    (``two``) against 1x1's (``one``), both with the 1x1 run's expert
    choices; prints the gnorm's and the loss's gaps, the leaves that part
    most and the first leaf (in the model's order) that parts by more than
    MLA_PINNED_GAP."""
    import math

    names = list(one["norms"])
    gaps = {n: abs(two["norms"][n] - one["norms"][n]) / max(one["norms"][n], 1e-30)
            for n in names}
    g1 = math.sqrt(sum(x * x for x in one["norms"].values()))
    g2 = math.sqrt(sum(two["norms"][n] ** 2 for n in names))
    first = next((n for n in names if gaps[n] > MLA_PINNED_GAP), None)
    worst = sorted(names, key=gaps.get, reverse=True)[:5]
    out = {"gnorm_gap": abs(g2 - g1) / g1, "loss_gap": abs(two["loss"] - one["loss"]) /
           abs(one["loss"]), "leaf_gaps": gaps, "first_over": first,
           "worst": {n: gaps[n] for n in worst}, "flips": two["flips"],
           "fault": max(gaps.values()) > MLA_PINNED_GAP}
    say(f"[{smi}] MLA (c) step 0's f32 gradients on 2x2 with the expert choices pinned "
        f"to 1x1's (rank 0's own top-6 differed for {two['flips']:.3%} of its tokens): "
        f"gnorm gap {out['gnorm_gap']:.3e}, loss gap {out['loss_gap']:.3e}; leaves that "
        f"part most {[f'{n} {g:.2e}' for n, g in out['worst'].items()]}; the first over "
        f"{MLA_PINNED_GAP:g}: {first}")
    return out


def mla_mesh(smi, out, kept, ranks):
    """Phase 15 (c)'s gates on the ranks' results (``ranks``, each with
    its ``mla`` part), at MLA_GATE_CF with no pair dropped: the serving
    within LM_TOL_BF16 · max|logit| of the 1x1 run (bf16) and within
    LM_TOL_F32 (f32), teacher-forced and pinned; the training steps'
    loss and params' change under phase 14's (d) gates against the 1x1
    steps, their gnorm shown (MLA_GATE_CF's comment); the counts.
    Then fails with any fault of phase 15, (a) and (b)'s included: every
    reading is printed before the gates fail.  Returns the kernels'
    launches (flash_attention, ring_send, ring_land)."""
    import statistics

    import torch

    from repro_torch.models import transformer as T

    cfg = _mla_cfg(MLA_TRAIN_LAYERS)
    r0 = ranks[0]["mla"]
    bad = []
    sv = r0["serve8"]
    got8 = [torch.from_numpy(x) for x in sv["logits"]]
    gaps8 = _logit_gaps(kept["logits"], got8)
    first = kept["logits"][0]  # the prefill's, by row
    rows = ((first[:, -1] - got8[0][:, -1].float()).abs().amax(-1)
            / first.abs().max()).tolist()
    gaps32 = _logit_gaps(kept["f32"]["logits"],
                         [torch.from_numpy(x) for x in r0["serve32"]["logits"]])
    say(f"[{smi}] MLA (c) serving 2x2 ({MLA_TRAIN_LAYERS} layers, EP, 4 ranks on one "
        f"card) at capacity factor {MLA_GATE_CF:g}, teacher-forced with the 1x1 run's "
        f"tokens and its expert choices pinned.  bf16: logits gap prefill {gaps8[0]:.3e} "
        f"(by row {[f'{g:.2e}' for g in rows]}), decode max {max(gaps8[1:]):.3e} of "
        f"max|logit| (1x1 kernel vs plain attention: {kept['plain_gaps'][0]:.3e}, "
        f"{max(kept['plain_gaps'][1:]):.3e}); rank 0's own top-6 differed for "
        f"{sv['flips']:.3%} of its tokens a layer; prefill {sv['prefill_ms']:.3f} ms, "
        f"decode {sv['decode_ms_per_step']:.3f} ms/step on rank 0; peak GiB by rank "
        f"{[round(r['mla']['serve8']['peak_bytes'] / 2**30, 3) for r in ranks]}.  f32 "
        f"(prompt {MLA_F32_PROMPT}, {MLA_F32_GEN} tokens): gap prefill {gaps32[0]:.3e}, "
        f"decode max {max(gaps32[1:]):.3e} (tol {LM_TOL_F32:g}); "
        f"{r0['serve32']['flips']:.3%} flips")
    if not max(gaps8) <= LM_TOL_BF16:
        bad.append(f"bf16 serving logits gap {max(gaps8):.3e} > {LM_TOL_BF16:g}")
    if not max(gaps32) <= LM_TOL_F32:
        bad.append(f"f32 serving logits gap {max(gaps32):.3e} > {LM_TOL_F32:g}")
    d, ref = r0["train8"], kept["train_gate"]
    per = {k: v / MLA_GATE_STEPS for k, v in d["counts"].items()}
    ms = statistics.median(d["step_ms"][1:])
    say(f"[{smi}] MLA (c) training 2x2 at capacity factor {MLA_GATE_CF:g}: "
        + _steps_line("against 1x1", d, ref, "1x1")
        + f" (tol loss {MOE_LOSS_TOL:g}, change {MOE_MOVED_TOL:g}; the bf16 gnorm shown, "
        f"gated in f32 below); "
        f"{ms:.3f} ms/step on rank 0 (median of {MLA_GATE_STEPS - 1}; "
        f"{', '.join(f'{t:.3f}' for t in d['step_ms'])}); peak GiB by rank "
        f"{[round(r['mla']['train8']['peak_bytes'] / 2**30, 3) for r in ranks]} (free GiB "
        f"as each began {[round(r['mla']['free_at_start'] / 2**30, 3) for r in ranks]}); a "
        f"step on rank 0: all_to_all {per['collectives.all_to_all']:g}, wire bytes "
        f"{per['wire_bytes']:.0f}, ring_send {per['ring_send']:g}, ring_land "
        f"{per['ring_land']:g}, flash {per['flash_attention']:g}; pairs dropped: serving "
        f"{sv['dropped']:.4%}, training {r0['train_dropped']:.4%}")
    bad += _step_faults("training", d, ref, MOE_LOSS_TOL, float("inf"), MOE_MOVED_TOL)
    out["ms_per_step_2x2"] = ms
    d32, ref32, ctl = r0["train32"], kept["train_gate32"], r0["control32"]
    tol = dict(zip(("loss", "gnorm", "change"), MLA_F32_TOLS))
    say(f"[{smi}] MLA (c) training 2x2 f32 at capacity factor {MLA_GATE_CF:g}: "
        + _steps_line("against 1x1", d32, ref32, "1x1")
        + f" (tol {tol}); {', '.join(f'{t:.3f}' for t in d32['step_ms'])} ms a step on "
        f"rank 0; peak GiB by rank "
        f"{[round(r['mla']['train32']['peak_bytes'] / 2**30, 3) for r in ranks]}")
    refused = _step_faults("control", ctl, ref32, *MLA_F32_TOLS)
    say(f"[{smi}] MLA (c) control f32, the latent weights' gradients left unsummed over "
        f"model: " + _steps_line("against 1x1", ctl, ref32, "1x1")
        + f"; {'refused: ' + '; '.join(refused) if refused else 'PASSED'}")
    bad += _step_faults("f32 training", d32, ref32, *MLA_F32_TOLS)
    if not refused:
        bad.append("the f32 gates pass the run with the latents' gradients unsummed")
    out["refused"] = refused
    if any(r["mla"]["serve8"]["dropped"] or r["mla"]["train_dropped"] or
           r["mla"]["train32_dropped"] for r in ranks):
        bad.append(f"pairs dropped at capacity factor {MLA_GATE_CF:g}")
    want_flash = T.block_forwards(cfg, T.RunCfg(remat=cfg.remat))
    launches = {"flash_attention": 0, "ring_send": 0, "ring_land": 0}
    for r in ranks:
        c = r["mla"]["serve8"]["counts"]
        if c["flash_attention"] != cfg.n_layers or c["flash_attention_plain"] or \
                c["pad_copies"] or not c["collectives.all_to_all"] or \
                not (c["ring_send"] > 0 and c["ring_land"] > 0):
            bad.append(f"serving rank {r['rank']}: counts {c}")
        for part, n in (("train8", MLA_GATE_STEPS), ("train32", MLA_GATE_STEPS),
                        ("control32", MLA_CONTROL_STEPS)):
            c = r["mla"][part]["counts"]
            if c["flash_attention"] != n * want_flash or c["flash_attention_plain"] or \
                    not c["collectives.all_to_all"] or not c["ring_land"]:
                bad.append(f"{part} rank {r['rank']}: counts {c}")
        if not r["wires_ipc"] or r["backend"] != "gloo":
            bad.append(f"rank {r['rank']}: wires {r['wires']}, default group "
                       f"{r['backend']}: a CUDA tensor's collective off the peer-mapped wire")
        for part in ("serve8", "train8", "train32", "control32"):
            for k in launches:
                launches[k] += r["mla"][part]["counts"][k]
        for part in ("serve8", "serve32"):
            r["mla"][part].pop("logits", None)
    out["pinned_grad0"] = _pinned_reading(smi, kept["grad0"], r0["grad0"])
    out["mesh"] = {"ranks": [r["mla"] for r in ranks], "serve_gaps": gaps8,
                   "serve_gaps_by_row": rows, "serve_gaps_f32": gaps32}
    # (a) and (b)'s faults too: every reading of phase 15 is printed first
    faults = out["serve_1x1"]["faults"] + out["train_1x1"]["faults"] + \
        [f"(c) {b}" for b in bad]
    if faults:
        fail("MLA " + "; ".join(faults))
    return launches


# ---------------------------------------------------------------------------
# phase 16: RWKV (rwkv6-3b) served at full width and depth on one card, a
# long prompt decoded from its O(1) state, and on 2x2 inside phase 13's spawn
# ---------------------------------------------------------------------------

RWKV_ARCH = "rwkv6-3b"
# (a) phase 8's batch, prompt and gen.  Every layer's kernel output (y and
# the final state) within RWKV_LAYER_TOL·max of the plain recurrence's on
# the same inputs, in f32 (the same arithmetic in another summation order);
# a control passing u = 0 to the kernel must be refused by that gate.  The
# bf16 logits within LM_TOL_BF16·max|logit| of the plain recurrence's run,
# teacher-forced; f32 at LM_PROMPT_F32, RWKV_F32_GEN tokens: identical greedy
# tokens and logits within LM_TOL_F32
RWKV_LAYER_TOL = 1e-5
RWKV_F32_GEN = 8
# (a) the bf16 logits of a correct recurrence drift far past LM_TOL_BF16
# through 32 layers of random weights: a 1e-7 relative change of each
# layer's y moves them by 0.7 % at 2 layers and 2.5 % at 8 (S=256 on the
# CPU).  So the bf16 gate is calibrated on a correct control, the
# recurrence in f64 rounded once: the kernel run's gap to the plain run at
# most RWKV_DRIFT_RATIO times the control's, or LM_TOL_BF16, a bound that
# the kernel with u = 0 in every layer must exceed.  The plain and control
# runs serve RWKV_CHECK_GEN tokens, teacher-forced
RWKV_DRIFT_RATIO = 2.0
RWKV_CHECK_GEN = MESH_GEN
# (b) long_500k's positions (src/repro/configs/base.py:105) at B=1, then
# RWKV_LONG_GEN decode steps; at layer 0 the kernel over the whole prompt
# equals its two halves with the state carried, bit for bit, and the plain
# loop over the last RWKV_TAIL steps from the kernel's state there is
# within RWKV_LAYER_TOL of the kernel's
RWKV_LONG, RWKV_LONG_GEN, RWKV_TAIL = 524288, 8, 2048
# (c) on 2x2: MESH_GEN tokens in bf16 within a bound of (a)'s logits
# calibrated on 2x2's own arithmetic: max(LM_TOL_BF16, RWKV_DRIFT_RATIO x
# the gap of a correct 1x1 control whose row-parallel products (``Wo``,
# the channel mix's ``Wv``) run in two halves of their rows, each rounded
# to bf16 and summed in rank order, as the two ranks of ``model`` do).  The
# same bf16 run with every rank taking the first heads' decay is shown
# beside it, not gated: at init ``w0`` is zero in every column, so the
# fault changes each layer's decay by the LoRA's share only, and in bf16 it
# lands within twice a correct run's drift (PERF.md).  f32 at LM_PROMPT_F32
# for RWKV_MESH_F32_GEN tokens within LM_TOL_F32 of (a)'s f32 run, a gate
# that the same control must fail: f32 carries the heads' slices
RWKV_MESH_F32_GEN = 2
RWKV_ONLY = "--rwkv-only"


def _wkv_counts() -> dict:
    from repro_torch.kernels import wkv

    return {"wkv6": wkv.launches, "wkv6_plain": wkv.plain_calls,
            "wkv6_bwd": wkv.bwd_launches, "wkv6_plain_bwd": wkv.plain_bwd_calls}


def _zero_wkv_counts() -> None:
    from repro_torch.kernels import wkv

    wkv.launches = wkv.plain_calls = wkv.bwd_launches = wkv.plain_bwd_calls = 0


def _forward_only(n: int) -> dict:
    """The counts of a run that launches the forward kernel ``n`` times and
    nothing else."""
    return {"wkv6": n, "wkv6_plain": 0, "wkv6_bwd": 0, "wkv6_plain_bwd": 0}


def _patched(module, name: str, wrap, body):
    """``body()`` with ``module.<name>`` replaced by ``wrap(original)``."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        return body()
    finally:
        setattr(module, name, original)


def _kernel_beside(gaps: list):
    """A wrapper of ``wkv6_plain`` that also runs the kernel on the same
    inputs, and with u = 0 (the control), and records each call's gaps to
    the plain version (device scalars: no synchronisation a call)."""
    import torch

    from repro_torch.kernels import wkv

    def wrap(plain):
        def both(r, k, v, w, u, state):
            y, s = plain(r, k, v, w, u, state)
            yk, sk = wkv.wkv6(r, k, v, w, u, state)
            y0, _ = wkv.wkv6(r, k, v, w, torch.zeros_like(u), state)
            ym, sm = y.abs().max(), s.abs().max()
            d = (yk - y).abs().max()
            gaps.append(torch.stack([d / ym, (sk - s).abs().max() / sm,
                                     (y0 - y).abs().max() / ym, d,
                                     torch.tensor(float(r.shape[1]), device=y.device)]))
            return y, s
        return both
    return wrap


def _wkv_f64(_plain):
    """(a)'s correct control in place of ``wkv6_plain``: the same step loop
    in f64, its y and state rounded to f32 once (also under autograd: phase
    17 (a))."""
    import torch

    def f64(r, k, v, w, u, state):
        rd, vd = r.double().unsqueeze(-2), v.double().unsqueeze(-2)
        kd, wd = k.double().unsqueeze(-1), w.double().unsqueeze(-1)
        st, uu = state.double(), u.double()[None, :, :, None]
        ys = []
        for t in range(r.shape[1]):
            kv = kd[:, t] * vd[:, t]
            ys.append(torch.matmul(rd[:, t], st + uu * kv))
            st = wd[:, t] * st + kv
        return torch.stack(ys, 1).squeeze(-2).float(), st.float()
    return f64


def _without_bonus(kernel):
    """(a)'s broken control in place of ``wkv6``: the kernel with u = 0."""
    import torch

    return lambda r, k, v, w, u, state: kernel(r, k, v, w, torch.zeros_like(u), state)


def _rows_in_halves(_row_parallel):
    """(c)'s correct control, run on 1x1 in place of ``row_parallel``: the
    product in two halves of ``w``'s rows, each rounded to the compute
    dtype, summed in rank order: the 2x2 ranks' arithmetic."""
    def halves(x, w, axes):
        n = w.shape[0] // 2
        return x[..., :n].contiguous() @ w[:n] + x[..., n:].contiguous() @ w[n:]
    return halves


def _first_heads(decay):
    """The control of (c): every rank's decay from the first heads' columns."""
    return lambda p, xw, cols: decay(p, xw, slice(0, cols.stop - cols.start))


def _wkv_timing(gen) -> list:
    """``wkv6`` at the prefill shape (B=8, S=2048, 40 heads of 64, bf16 r,
    k, v) and at a decode step's (S=1): the kernel (median of 7 CUDA-event
    timings), its plain version, and the bound: the larger of
    :func:`repro_torch.kernels.wkv.wkv6_bytes` over 3.35 TB/s and
    :func:`~repro_torch.kernels.wkv.wkv6_flops` over the f32 CUDA cores'
    67 TFLOP/s.  No single PyTorch call computes the recurrence: no
    library time."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv

    cfg = get_config(RWKV_ARCH)
    h, k = cfg.n_heads, cfg.d_model // cfg.n_heads
    out = []
    for s in (LM_PROMPT, 1):
        b = LM_BATCH
        r, kk, v = (_rand((b, s, h, k), torch.float32, gen).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(_rand((b, s, h, k), torch.float32, gen) - 1))
        u = _rand((h, k), torch.float32, gen) * 0.5
        st = _rand((b, h, k, k), torch.float32, gen) * 0.3
        ms, lo, hi = _median_ms(lambda: wkv.wkv6(r, kk, v, w, u, st), 10, 2)
        plain_ms = _time_ms(lambda: wkv.wkv6_plain(r, kk, v, w, u, st), 1, 1)
        moved, flops = wkv.wkv6_bytes(b, s, h, k, 2), wkv.wkv6_flops(b, s, h, k)
        bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
        rec = {"kernel": "wkv6", "shape": [b, s, h, k], "dtype": "bfloat16", "ms": ms,
               "ms_spread": [lo, hi], "plain_ms": plain_ms, "library_ms": None,
               "bytes": moved, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
        say(f"timing wkv6 B={b} S={s} H={h} K={k} bf16 r, k, v: kernel {ms:.4f} ms "
            f"({lo:.4f}-{hi:.4f}), plain {plain_ms:.3f} ms, library none; bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {moved} B {bytes_ms:.4f} ms, "
            f"{flops:.4g} flop {ops_ms:.4f} ms), {rec['bound_ms'] / ms:.1%} of the bound")
        out.append(rec)
        del r, kk, v, w, st
    torch.cuda.empty_cache()
    return out


def _rwkv_layer0_inputs(cfg, model, tokens) -> dict:
    """The inputs of layer 0's recurrence over the whole of ``tokens``: the
    block run alone (in its chunks of the time axis), each chunk's r, k, v
    and w copied into whole-prompt buffers as it reaches ``wkv6``."""
    import torch

    from repro_torch.models import rwkv as RW
    from repro_torch.models import transformer as T

    run, cd = T.RunCfg(), T._dt(cfg)
    top = T._top_params(model, cfg, run)
    x = T._apply_norm(top["ln0"], T._embed_tokens(top, cfg, run, tokens), cfg)
    p0 = T._block_params(model.blocks[0], cfg, run, cd)
    b, s = tokens.shape
    hs = cfg.d_model // cfg.n_heads
    shape = (b, s, cfg.n_heads, hs)
    rec = {n: torch.empty(shape, dtype=cd if n != "w" else torch.float32, device="cuda")
           for n in "rkvw"}
    at = [0]

    def record(kernel):
        def copy_then_run(r, k, v, w, u, state):
            n = r.shape[1]
            for name, t in zip("rkvw", (r, k, v, w)):
                rec[name][:, at[0]:at[0] + n] = t
            rec["u"] = u.clone()
            at[0] += n
            return kernel(r, k, v, w, u, state)
        return copy_then_run

    zero = {k: torch.zeros(sh[1:], dtype=T.cache_dtypes(cfg)[k], device="cuda")
            for k, sh in T.cache_shapes(cfg, b, 0).items()}
    _patched(RW, "wkv6", record, lambda: T._rwkv_block_fwd(p0, cfg, run, x, zero))
    if at[0] != s:
        fail(f"RWKV (b): layer 0's recurrence saw {at[0]} of {s} positions")
    return rec


def _rwkv_layer0_checks(cfg, model, tokens) -> dict:
    """(b)'s gates at layer 0: the kernel over the whole prompt against its
    two halves with the state carried (bitwise), and the plain loop over
    the last RWKV_TAIL steps from the kernel's state at S - RWKV_TAIL."""
    import torch

    from repro_torch.kernels import wkv

    ins = _rwkv_layer0_inputs(cfg, model, tokens)
    r, k, v, w, u = (ins[n] for n in "rkvwu")
    b, s, h, hs = r.shape
    zero = torch.zeros((b, h, hs, hs), dtype=torch.float32, device="cuda")
    t0 = time.perf_counter()
    y, st = wkv.wkv6(r, k, v, w, u, zero)
    torch.cuda.synchronize()
    whole_s = time.perf_counter() - t0

    def part(lo, hi, state):
        return wkv.wkv6(*(x[:, lo:hi].contiguous() for x in (r, k, v, w)), u, state)

    half = s // 2
    y1, s1 = part(0, half, zero)
    same = bool(torch.equal(y[:, :half], y1))
    del y1
    y2, s2 = part(half, s, s1)
    same = same and bool(torch.equal(y[:, half:], y2)) and bool(torch.equal(st, s2))
    del y2, s1, s2
    cut = s - RWKV_TAIL
    _, s_cut = part(0, cut, zero)
    yp, sp = wkv.wkv6_plain(*(x[:, cut:].contiguous() for x in (r, k, v, w)), u, s_cut)
    tail = {"y": float((y[:, cut:] - yp).abs().max() / yp.abs().max()),
            "state": float((st - sp).abs().max() / sp.abs().max())}
    del ins, r, k, v, w, y, yp, sp, s_cut
    torch.cuda.empty_cache()
    return {"halves_bitwise": same, "tail": tail, "whole_s": whole_s}


def _rwkv_long(smi, cfg, model, a) -> dict:
    """(b): B=1 at RWKV_LONG positions, then RWKV_LONG_GEN decode steps."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    run = T.RunCfg()
    tokens = serve.prompt_tokens(cfg, 1, RWKV_LONG, "cuda")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_wkv_counts()
    r = serve.generate(cfg, run, model, tokens, RWKV_LONG_GEN + 1, keep_logits=True)
    counts = _wkv_counts()
    chunks = -(-RWKV_LONG // T.SEQ_CHUNK_TOKENS)
    out = {"positions": RWKV_LONG, "counts": counts, "chunks": chunks,
           "prefill_s": r["prefill_ms"] / 1e3,
           "decode_ms_per_step": r["decode_ms"] / RWKV_LONG_GEN,
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": _cache_bytes(r["cache"]),
           "finite": all(bool(torch.isfinite(x).all()) for x in r["logits"]),
           "sample": r["tokens"][0].tolist()}
    del r
    out.update(_rwkv_layer0_checks(cfg, model, tokens))
    say(f"[{smi}] RWKV (b) {RWKV_ARCH} B=1 prompt={RWKV_LONG} (long_500k's positions, "
        f"{chunks} chunks of {T.SEQ_CHUNK_TOKENS} a layer) then {RWKV_LONG_GEN} decode "
        f"steps: prefill {out['prefill_s']:.3f} s, decode {out['decode_ms_per_step']:.3f} "
        f"ms/step ((a) at B={LM_BATCH}: {a['decode_ms_per_step']:.3f}), peak "
        f"{out['peak_bytes'] / 2**30:.3f} GiB, state {out['state_bytes']} B; counts {counts}; "
        f"logits finite {out['finite']}; layer 0: whole prompt in one launch "
        f"{out['whole_s']:.3f} s, its two halves with the state carried bitwise "
        f"{out['halves_bitwise']}, the plain loop over the last {RWKV_TAIL} steps from the "
        f"kernel's state: y {out['tail']['y']:.3e}, state {out['tail']['state']:.3e} of max "
        f"(tol {RWKV_LAYER_TOL:g})")
    bad = []
    if counts != _forward_only(cfg.n_layers * (chunks + RWKV_LONG_GEN)):
        bad.append(f"counts {counts}, want {cfg.n_layers} launches a chunk and a step")
    if not out["finite"]:
        bad.append("non-finite logits")
    if not out["halves_bitwise"]:
        bad.append("the kernel over two halves is not the whole prompt's, bit for bit")
    if max(out["tail"].values()) > RWKV_LAYER_TOL:
        bad.append(f"the plain tail parts by {out['tail']}")
    if bad:
        fail("RWKV (b): " + "; ".join(bad))
    return out


def rwkv_lm(smi):
    """Phase 16 (a) and (b) on one card: rwkv6-3b at full width and depth
    (32 layers, d 2560, 40 heads of 64, d_ff 8960, vocab 65536; 3.07 B
    params, 12.29 GB in f32), bf16, random weights from seed 0; then phase
    17 (a) (:func:`rwkv_train`).  Returns (results, what 16 (c) and 17 (b)
    compare with, the main path's launches of ``wkv6`` and ``wkv6_bwd``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import rwkv as RW
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = get_config(RWKV_ARCH)
    run, plain_run = T.RunCfg(), T.RunCfg(plain_wkv=True)
    model = T.init_model(cfg, seed=0, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, "cuda")
    serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_wkv_counts()
    r = serve.generate(cfg, run, model, tokens, LM_GEN, keep_logits=True)
    counts = _wkv_counts()
    steps = LM_GEN - 1
    out = {"arch": RWKV_ARCH, "params": n_params, "batch": LM_BATCH, "prompt": LM_PROMPT,
           "gen": LM_GEN, "counts": counts, "prefill_ms": r["prefill_ms"],
           "decode_ms_per_step": r["decode_ms"] / steps,
           "tok_per_s": steps * LM_BATCH / (r["decode_ms"] / 1e3),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "state_bytes": _cache_bytes(r["cache"]), "sample": r["tokens"][0, :16].tolist()}
    launches = counts["wkv6"]
    # one more prefill and one decode step, each counted alone and profiled
    _zero_wkv_counts()
    prof_prefill = _profile(lambda: T.prefill(cfg, run, model, {"tokens": tokens}),
                            f"RWKV prefill {RWKV_ARCH} B={LM_BATCH} S={LM_PROMPT}")
    out["prefill_counts"] = _wkv_counts()
    cache, tok = r["cache"], r["tokens"][:, -1:]
    _zero_wkv_counts()
    prof_decode = _profile(lambda: T.decode_step(cfg, run, model, cache, tok),
                           f"RWKV decode step {RWKV_ARCH} B={LM_BATCH}")
    out["step_counts"] = _wkv_counts()
    out["breakdown"] = [prof_prefill, prof_decode]
    kept = {"tokens": r["tokens"].cpu(), "logits": [x.float().cpu() for x in r["logits"]]}
    del cache, tok
    say(f"[{smi}] RWKV (a) {RWKV_ARCH} ({n_params} params, f32) bf16 B={LM_BATCH} "
        f"prompt={LM_PROMPT} gen={LM_GEN}: prefill {out['prefill_ms']:.3f} ms, decode "
        f"{out['decode_ms_per_step']:.3f} ms/step ({out['tok_per_s']:.1f} tok/s), peak "
        f"{out['peak_bytes'] / 2**30:.3f} GiB, decode state {out['state_bytes']} B at any "
        f"length; counts {counts}, a prefill {out['prefill_counts']}, a decode step "
        f"{out['step_counts']}; sample {out['sample']}")
    for line in prof_prefill["lines"] + prof_decode["lines"]:
        say(line)

    # the plain recurrence's run, teacher-forced; every call of it also
    # runs the kernel on the same inputs, and with u = 0
    gaps = []
    forced = r["tokens"][:, :RWKV_CHECK_GEN]
    p = _patched(RW, "wkv6_plain", _kernel_beside(gaps), lambda: serve.generate(
        cfg, plain_run, model, tokens, RWKV_CHECK_GEN, forced=forced, keep_logits=True))
    g = torch.stack(gaps).cpu()
    prefill_rows = g[:, 4] > 1
    layer = {"calls": len(gaps), "prefill_calls": int(prefill_rows.sum()),
             "y_max": float(g[:, 0].max()), "state_max": float(g[:, 1].max()),
             "prefill_y_max": float(g[prefill_rows, 0].max()),
             "max_abs": float(g[:, 3].max()), "u0_min": float(g[:, 2].min()),
             "u0_refused": int((g[:, 2] > RWKV_LAYER_TOL).sum())}
    # a correct recurrence in other roundings (f64) and a broken one (u = 0
    # in every layer's kernel), the same tokens forced
    c = _patched(RW, "wkv6_plain", _wkv_f64, lambda: serve.generate(
        cfg, plain_run, model, tokens, RWKV_CHECK_GEN, forced=forced, keep_logits=True))
    u0 = _patched(RW, "wkv6", _without_bonus, lambda: serve.generate(
        cfg, run, model, tokens, RWKV_CHECK_GEN, forced=forced, keep_logits=True))
    # (c)'s bound: the 2x2 ranks' row-parallel roundings, on 1x1
    halves = _patched(RW, "row_parallel", _rows_in_halves, lambda: serve.generate(
        cfg, run, model, tokens, MESH_GEN, forced=r["tokens"][:, :MESH_GEN],
        keep_logits=True))
    logit_gaps = _logit_gaps(p["logits"], r["logits"])
    drift = _logit_gaps(p["logits"], c["logits"])
    broken = _logit_gaps(p["logits"], u0["logits"])
    bound = max(LM_TOL_BF16, RWKV_DRIFT_RATIO * max(drift))
    mesh_drift = _logit_gaps(r["logits"], halves["logits"])
    mesh_bound = max(LM_TOL_BF16, RWKV_DRIFT_RATIO * max(mesh_drift))
    kept["halves_logits"] = [x.float().cpu() for x in halves["logits"]]
    out.update(layer=layer, gap_prefill=logit_gaps[0], gap_decode_max=max(logit_gaps[1:]),
               drift_prefill=drift[0], drift_max=max(drift), u0_gap_max=max(broken),
               bound=bound, mesh_drift=mesh_drift, mesh_bound=mesh_bound,
               plain_prefill_ms=p["prefill_ms"],
               plain_decode_ms_per_step=p["decode_ms"] / (RWKV_CHECK_GEN - 1))
    del r, p, c, u0, halves
    say(f"[{smi}] RWKV (a) every call of the recurrence in the plain run ({layer['calls']}: "
        f"{layer['prefill_calls']} at S={LM_PROMPT}, the rest decode steps) against the "
        f"kernel on the same inputs: y {layer['y_max']:.3e} (the prefill's "
        f"{layer['prefill_y_max']:.3e}), state {layer['state_max']:.3e} of max (tol "
        f"{RWKV_LAYER_TOL:g}; max |d| {layer['max_abs']:.3e}); control, u = 0: the "
        f"smallest gap {layer['u0_min']:.3e}, refused in {layer['u0_refused']} of "
        f"{layer['calls']} calls")
    say(f"[{smi}] RWKV (a) bf16 logits against the plain recurrence's run ({RWKV_CHECK_GEN} "
        f"tokens, teacher-forced): the kernel prefill {logit_gaps[0]:.3e}, max "
        f"{max(logit_gaps):.3e}; a correct control (the recurrence in f64, rounded once) "
        f"prefill {drift[0]:.3e}, max {max(drift):.3e}; bound max({LM_TOL_BF16:g}, "
        f"{RWKV_DRIFT_RATIO:g} x the control's) = {bound:.3e}; the kernel with u = 0 in every "
        f"layer {max(broken):.3e}: {'refused' if max(broken) > bound else 'PASSED'}; plain "
        f"prefill {out['plain_prefill_ms']:.1f} ms, decode "
        f"{out['plain_decode_ms_per_step']:.1f} ms/step")
    say(f"[{smi}] RWKV (a) for (c): the kernel run against a correct control with 2x2's "
        f"row-parallel roundings (Wo, the channel mix's Wv in two halves of their rows, "
        f"each rounded to bf16, summed in rank order; {MESH_GEN} tokens): prefill "
        f"{mesh_drift[0]:.3e}, max {max(mesh_drift):.3e}; (c)'s bf16 bound max("
        f"{LM_TOL_BF16:g}, {RWKV_DRIFT_RATIO:g} x that) = {mesh_bound:.3e}")

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    t32 = tokens[:, :LM_PROMPT_F32]
    _zero_wkv_counts()
    k32 = serve.generate(cfg32, run, model, t32, RWKV_F32_GEN, keep_logits=True)
    n32 = _wkv_counts()
    p32 = serve.generate(cfg32, plain_run, model, t32, RWKV_F32_GEN, keep_logits=True)
    gaps32 = _logit_gaps(k32["logits"], p32["logits"])
    same = bool(torch.equal(k32["tokens"], p32["tokens"]))
    out["f32"] = {"prompt": LM_PROMPT_F32, "gen": RWKV_F32_GEN, "counts": n32,
                  "prefill_ms": k32["prefill_ms"], "plain_prefill_ms": p32["prefill_ms"],
                  "same_tokens": same, "gap_max": max(gaps32)}
    kept.update(f32_tokens=k32["tokens"].cpu(),
                f32_logits=[x.float().cpu() for x in k32["logits"]])
    launches += n32["wkv6"]
    del k32, p32
    say(f"[{smi}] RWKV (a) f32 (prompt {LM_PROMPT_F32}, {RWKV_F32_GEN} tokens): kernel "
        f"prefill {out['f32']['prefill_ms']:.3f} ms, plain {out['f32']['plain_prefill_ms']:.3f}"
        f" ms; greedy tokens {'identical' if same else 'DIFFER'}, logits gap max "
        f"{max(gaps32):.3e} of max|logit| (tol {LM_TOL_F32:g}); counts {n32}")
    out["timing"] = _wkv_timing(torch.Generator(device="cuda").manual_seed(16))
    out["long"] = _rwkv_long(smi, cfg, model, out)
    launches += out["long"]["counts"]["wkv6"]
    t_train = time.perf_counter()
    checks = _rwkv_train_checks(smi, cfg, model)
    del model
    torch.cuda.empty_cache()
    out["train"], kept["train_ref"] = rwkv_train(smi, cfg, checks, t_train)

    n = cfg.n_layers
    bad = []
    if counts != _forward_only(n * LM_GEN) or out["prefill_counts"] != _forward_only(n) \
            or out["step_counts"] != _forward_only(n):
        bad.append(f"counts {counts}, a prefill {out['prefill_counts']}, a step "
                   f"{out['step_counts']}: want {n} launches a prefill and {n} a step, no "
                   "plain call")
    if layer["y_max"] > RWKV_LAYER_TOL or layer["state_max"] > RWKV_LAYER_TOL:
        bad.append(f"a layer's kernel output parts from the plain recurrence by "
                   f"{max(layer['y_max'], layer['state_max']):.3e}")
    if layer["u0_refused"] != layer["calls"]:
        bad.append(f"the gate passes the u = 0 control in "
                   f"{layer['calls'] - layer['u0_refused']} calls")
    if max(logit_gaps) > bound or not all(bool(torch.isfinite(x).all())
                                          for x in kept["logits"]):
        bad.append(f"logits gap {max(logit_gaps):.3e} > {bound:.3e}, or non-finite")
    if out["u0_gap_max"] <= bound:
        bad.append(f"the logits bound passes the kernel with u = 0 ({out['u0_gap_max']:.3e})")
    if not same or max(gaps32) > LM_TOL_F32 or n32 != _forward_only(n * RWKV_F32_GEN):
        bad.append(f"f32: same tokens {same}, gap {max(gaps32):.3e}, counts {n32}")
    if tuple(kept["tokens"].shape) != (LM_BATCH, LM_GEN) or \
            tuple(kept["logits"][0].shape) != (LM_BATCH, 1, cfg.vocab):
        bad.append(f"tokens {tuple(kept['tokens'].shape)}, prefill logits "
                   f"{tuple(kept['logits'][0].shape)}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] RWKV: 16 (a), (b) and 17 (a) on one card in {out['phase_s']:.3f} s")
    if bad:
        fail("RWKV (a): " + "; ".join(bad))
    out["max_abs_err"] = layer["max_abs"]
    return out, kept, {"wkv6": launches + out["train"]["counts"]["wkv6"],
                       "wkv6_bwd": out["train"]["counts"]["wkv6_bwd"]}


def _rwkv_ranks(ctx, forced, forced32):
    """Phase 16 (c) on this rank of 2x2: rwkv6-3b's shards (each rank its
    20 heads and their WKV state, FSDP over ``data``), served from phase
    8's prompts teacher-forced with (a)'s tokens: bf16 MESH_GEN tokens, f32
    at LM_PROMPT_F32, and both again with the control taking the first
    heads' decay; then phase 17 (b) (:func:`_rwkv_train_ranks`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch import serve
    from repro_torch.models import rwkv as RW
    from repro_torch.models import transformer as T

    cfg = get_config(RWKV_ARCH)
    run, model, _ = M.rank_setup(cfg, ctx, None)
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, ctx.device)
    out = {"heads": T.rwkv_tp(cfg, run).heads,
           "bf16": _serve_part(ctx, cfg, run, model, tokens, forced, MESH_GEN)}
    out["bf16_control"] = _patched(RW, "decay", _first_heads, lambda: _serve_part(
        ctx, cfg, run, model, tokens, forced, MESH_GEN, timed=False))
    cfg32, t32 = dataclasses.replace(cfg, compute_dtype="float32"), tokens[:, :LM_PROMPT_F32]
    out["f32"] = _serve_part(ctx, cfg32, run, model, t32, forced32, RWKV_MESH_F32_GEN,
                             timed=False)
    out["control"] = _patched(RW, "decay", _first_heads, lambda: _serve_part(
        ctx, cfg32, run, model, t32, forced32, RWKV_MESH_F32_GEN, timed=False))
    del model
    out["train"] = _rwkv_train_ranks(ctx)
    return out


def _rwkv_rank_args(kept):
    """The arguments (c)'s ranks take: (a)'s tokens, bf16 and f32."""
    return (kept["tokens"].numpy(), kept["f32_tokens"].numpy())


def rwkv_mesh(smi, one, kept, ranks):
    """Phase 16 (c)'s gates, then phase 17 (b)'s (:func:`rwkv_train_mesh`),
    from the ranks' results: returns the launches of the main path's runs
    summed over the ranks."""
    import torch

    from repro_torch.configs import get_config

    cfg = get_config(RWKV_ARCH)
    r0 = ranks[0]
    logits = {k: [torch.from_numpy(x) for x in r0[k]["logits"]]
              for k in ("bf16", "bf16_control", "f32", "control")}
    gaps = {"bf16": _logit_gaps(kept["logits"][:MESH_GEN], logits["bf16"]),
            "bf16_control": _logit_gaps(kept["logits"][:MESH_GEN], logits["bf16_control"]),
            "bf16_vs_halves": _logit_gaps(kept["halves_logits"], logits["bf16"]),
            "f32": _logit_gaps(kept["f32_logits"][:RWKV_MESH_F32_GEN], logits["f32"]),
            "control": _logit_gaps(kept["f32_logits"][:RWKV_MESH_F32_GEN],
                                   logits["control"])}
    b = r0["bf16"]
    say(f"[{smi}] RWKV (c) serving 2x2 (4 ranks on one card, 20 heads a rank) bf16 "
        f"B={LM_BATCH} prompt={LM_PROMPT} gen={MESH_GEN}, teacher-forced with (a)'s tokens: "
        f"prefill {b['prefill_ms']:.3f} ms, decode {b['decode_ms_per_step']:.3f} ms/step on "
        f"rank 0 ((a) at 1x1: {one['decode_ms_per_step']:.3f}); state a rank "
        f"{b['cache_bytes']} B {b['cache_shape']} ((a) whole: {one['state_bytes']} B); a "
        f"decode step's {b['decode_step_counts']}; counts {b['counts']}; heads by rank "
        f"{[r['heads'] for r in ranks]}")
    refused = max(gaps["control"]) > LM_TOL_F32
    above16 = max(gaps["bf16_control"]) > one["mesh_bound"]
    say(f"[{smi}] RWKV (c) logits against (a)'s 1x1: bf16 prefill {gaps['bf16'][0]:.3e}, "
        f"decode max {max(gaps['bf16'][1:]):.3e} (bound {one['mesh_bound']:.3e} of "
        f"max|logit|, from (a)'s control with 2x2's row-parallel roundings, whose gap is "
        f"{max(one['mesh_drift']):.3e}; against that control itself "
        f"{max(gaps['bf16_vs_halves']):.3e}); the same bf16 run with every rank the first "
        f"heads' decay: max {max(gaps['bf16_control']):.3e} (shown, not gated: "
        f"{'above' if above16 else 'within'} the bound); f32 (prompt {LM_PROMPT_F32}, "
        f"{RWKV_MESH_F32_GEN} tokens) max {max(gaps['f32']):.3e} (tol {LM_TOL_F32:g}); "
        f"control, the same f32 run with every rank the first heads' decay: max "
        f"{max(gaps['control']):.3e}: {'refused' if refused else 'PASSED'}")
    bad = []
    launches = {"wkv6": 0, "ring_send": 0, "ring_land": 0}
    for r in ranks:
        for key, gen in (("bf16", MESH_GEN), ("f32", RWKV_MESH_F32_GEN)):
            c = r[key]["counts"]
            if c["wkv6"] != cfg.n_layers * gen or c["wkv6_plain"]:
                bad.append(f"{key} rank counts {c}: want {cfg.n_layers * gen} launches")
            for k in launches:
                launches[k] += c[k]
    if max(gaps["bf16"]) > one["mesh_bound"]:
        bad.append(f"bf16 logits gap {max(gaps['bf16']):.3e} > {one['mesh_bound']:.3e}")
    if max(gaps["f32"]) > LM_TOL_F32:
        bad.append(f"f32 logits gap {max(gaps['f32']):.3e} > {LM_TOL_F32}")
    if not refused:
        bad.append("the gate passes the control whose ranks take the first heads' decay")
    half = cfg.n_heads // 2  # rank i's model coordinate is i % 2
    if [r["heads"] for r in ranks] != [(i % 2 * half, half) for i in range(len(ranks))]:
        bad.append(f"heads by rank {[r['heads'] for r in ranks]}")
    one["mesh"] = {"gaps": gaps, "refused": refused, "bf16_control_above_bound": above16,
                   **{k: {kk: vv for kk, vv in r0[k].items() if kk not in ("logits", "tokens")}
                      for k in ("bf16", "bf16_control", "f32", "control")}}
    if bad:
        fail("RWKV (c): " + "; ".join(bad))
    one["train"]["mesh"], trained = rwkv_train_mesh(smi, kept["train_ref"], ranks)
    launches["wkv6_bwd"] = 0
    for k, n in trained.items():
        launches[k] += n
    return launches


# ---------------------------------------------------------------------------
# phase 17: RWKV (rwkv6-3b) trained at full width and depth on one card, and
# cut to RWKV_MESH_LAYERS layers on 2x2 inside phase 13's spawn
# ---------------------------------------------------------------------------

# (a) launch/train.py's batch and sequence and the config's 2 microbatches
# (train_microbatches), bf16 compute, f32 params and moments, remat in
# groups of 8 (92 block forwards a microbatch).  RWKV_TRAIN_STEPS steps
# through launch/train.py: the first, the timed ones, the last profiled
RWKV_TRAIN_BATCH, RWKV_TRAIN_SEQ, RWKV_TRAIN_MB = 8, 512, 2
RWKV_TRAIN_STEPS = 4
# (a) step 0's wkv6_bwd calls against wkv6_backward_plain on the same
# inputs, dy and dS: each output within RWKV_BWD_TOL of its max.  The plain
# backward takes ~0.26 s a call: the first and last layer of each remat
# group are held (16 of the 64 calls).  A backward with dw = 0, and one
# with du = 0, must be refused
RWKV_BWD_TOL = 1e-5
# (a) step 0's gradients in one microbatch of the batch (RWKV_GATE_SEQ), each leaf's
# ||g - g_plain|| / ||g_plain|| against the plain recurrence's run
# (RunCfg(plain_wkv=True): torch's autograd through its step loop) at most
# max(floor, RWKV_DRIFT_RATIO x a correct control's largest gap on that
# kind of leaf over the layers, the recurrence in f64 rounded once), bounds
# that the kernel with dw = 0 must exceed on some leaf: in bf16 (floor
# RWKV_GRAD_FLOOR) at RWKV_GATE_LAYERS layers, in f32 (floor
# TRAIN_GRAD_TOL["float32"]) at RWKV_F32_LAYERS.  A correct control is
# needed in both: on the H100 through 32 random layers in bf16 the bonus's
# gradient parts from the plain run's by 1.5 of its norm (the control's as
# far), and in f32 at 4 layers by 2e-5 (so does the control's); one leaf's
# gap is too noisy a measure in bf16 (at 12 layers one bonus leaf read 1.06
# against its control's 0.25), the largest over a kind's 12 layers is not.
# The plain run took 88 s at full depth in two microbatches: hence the
# gate's 12 layers (two remat groups of 6) in one microbatch.  In bf16 the
# kinds whose control drifts by half their norm or more (the bonus `u`,
# the lerps `mu`, `ln1`) get a bound of 1 or more, which a zero gradient
# passes: there only the decay LoRA's kinds (`w0`, `wA`, `wB`) are checked,
# so the bf16 gate plants dw = 0 alone; the f32 gate plants dw = 0 and du =
# 0, so each of the kernel's gradients has a whole-model fault refused
RWKV_GRAD_FLOOR = TRAIN_GRAD_TOL["bfloat16"]
RWKV_GATE_LAYERS, RWKV_F32_LAYERS = 12, 4
RWKV_BF16_CONTROLS = ("dw",)
# ... and on the first RWKV_GATE_SEQ positions of the batch's rows: the
# plain run's autograd through its loop costs ~1 s a layer at 512 steps,
# two such runs (the plain recurrence's, the f64 control's) a gate
RWKV_GATE_SEQ = 256
# (b) on 2x2, rwkv6-3b cut to RWKV_MESH_LAYERS layers: RWKV_MESH_STEPS f32
# steps to phase 13's gates against 1x1 (loss, gnorm, the params' change),
# RWKV_MESH_STEPS bf16 steps shown; after each step every leaf whole over
# model the same bits on both ranks of model; two controls refused: the
# time mix's sliced leaves without their gradients summed over model, and
# the receptance gathered with no autograd
RWKV_MESH_LAYERS, RWKV_MESH_STEPS = 4, 3


def _rwkv_cut(cfg, model, n: int):
    """(cfg, model) cut to the first ``n`` layers, sharing the parameters."""
    import copy
    import dataclasses

    from torch import nn

    cut = copy.copy(model)
    cut._modules = dict(model._modules)
    cut._modules["blocks"] = nn.ModuleList(list(model.blocks)[:n])
    return dataclasses.replace(cfg, n_layers=n), cut


def _rwkv_grads(cfg, run, model, tokens, microbatches: int):
    """Step 0's (loss, {name: gradient}) as the train step takes them:
    ``microbatches`` of ``tokens``, the gradients summed in f32 and scaled."""
    import torch

    from repro_torch.models import transformer as T

    names, leaves = zip(*model.named_parameters())
    acc, total = None, 0.0
    model.requires_grad_(True)
    try:
        for part in tokens.chunk(microbatches):
            loss = T.lm_loss(cfg, run, model, {"tokens": part})
            grads = torch.autograd.grad(loss, leaves)
            total += loss.item()
            if acc is None:
                acc = list(grads)
            else:
                torch._foreach_add_(acc, grads)
            del grads, loss
    finally:
        model.requires_grad_(False)
    torch._foreach_mul_(acc, 1.0 / microbatches)
    return total / microbatches, dict(zip(names, acc))


#: the elements of a leaf :func:`_leaf_gaps` casts to f32 at once
GAP_CHUNK = 1 << 26


def _leaf_gaps(got: dict, want: dict) -> dict:
    """{name: ||got - want|| / ||want||} of every leaf, in f32, a flat
    chunk of at most :data:`GAP_CHUNK` elements at a time (Jamba's stacked
    ``in_proj`` whole would take 22 GB of f32 temporaries beside three
    models' worth of gradients)."""
    import torch

    def norm(chunks):
        return torch.stack([torch.linalg.vector_norm(c) for c in chunks]).square().sum().sqrt()

    names = list(want)
    gaps = []
    for n in names:
        g, w = got[n].reshape(-1), want[n].reshape(-1)
        cut = range(0, w.numel(), GAP_CHUNK)
        gaps.append(norm(g[i:i + GAP_CHUNK].float() - w[i:i + GAP_CHUNK].float() for i in cut)
                    / norm(w[i:i + GAP_CHUNK].float() for i in cut).clamp_min(1e-30))
    return dict(zip(names, torch.stack(gaps).tolist()))


def _max_gap(got, want):
    return (got - want).abs().max() / want.abs().max().clamp_min(1e-30)


def _bwd_beside(rec: dict, n_layers: int, first: int):
    """A wrapper of ``wkv6_bwd`` that holds, among its ``first`` calls, those
    of the first and last layer of each remat group against
    ``wkv6_backward_plain`` on the same inputs: each output's max gap over
    its max, the same with dw and with du set to zero (the controls), and
    the largest |d| (device scalars)."""
    import torch

    from repro_torch.kernels import wkv
    from repro_torch.models import transformer as T

    group = T._remat_group(n_layers)

    def wrap(kernel_bwd):
        def both(r, k, v, w, u, ck, dy, ds=None):
            got = kernel_bwd(r, k, v, w, u, ck, dy, ds)
            layer = n_layers - 1 - rec["calls"] % n_layers  # backward: last layer first
            rec["calls"] += 1
            if rec["calls"] <= first and layer % group in (0, group - 1):
                want = wkv.wkv6_backward_plain(r, k, v, w, u, ck, dy, ds)
                zero = [_max_gap(torch.zeros_like(want[i]), want[i]) for i in (3, 4)]
                rec["gaps"].append(torch.stack(
                    [_max_gap(a, b) for a, b in zip(got, want)] + zero
                    + [max((a - b).abs().max() for a, b in zip(got, want))]))
                rec["layers"].append(layer)
            return got
        return both
    return wrap


#: (a)'s broken controls in place of ``wkv6_bwd``: the name of the output
#: each sets to zero and its place in the kernel's outputs
RWKV_ZEROED = {"dw": 3, "du": 4}


def _without(grad: str):
    """(a)'s broken control ``grad`` = 0 in place of ``wkv6_bwd``."""
    import torch

    def wrap(kernel_bwd):
        def bwd(*args):
            out = list(kernel_bwd(*args))
            out[RWKV_ZEROED[grad]] = torch.zeros_like(out[RWKV_ZEROED[grad]])
            return tuple(out)
        return bwd
    return wrap


def _rwkv_grad_gate(smi, cfg, model, tokens, floor: float, controls) -> dict:
    """Step 0's gradients of ``cfg`` (one microbatch of ``tokens``) through
    the kernels against the plain recurrence's run, each leaf's
    ||g - g_plain|| / ||g_plain|| within max(``floor``, RWKV_DRIFT_RATIO x a
    correct control's largest gap on that kind of leaf, the recurrence in
    f64 rounded once); the same bounds must refuse the kernel with each of
    ``controls`` (names of :data:`RWKV_ZEROED`) set to zero.  A kind whose
    bound is 1 or more passes a zero gradient: it is listed as
    unchecked."""
    import torch

    from repro_torch.kernels import wkv
    from repro_torch.models import rwkv as RW
    from repro_torch.models import transformer as T

    run, plain = T.RunCfg(), T.RunCfg(plain_wkv=True)
    t0 = time.perf_counter()
    loss_p, want = _rwkv_grads(cfg, plain, model, tokens, 1)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    loss_k, got = _rwkv_grads(cfg, run, model, tokens, 1)
    kernel = _leaf_gaps(got, want)
    del got
    loss_c, ctrl = _patched(RW, "wkv6_plain", _wkv_f64,
                            lambda: _rwkv_grads(cfg, plain, model, tokens, 1))
    control = _leaf_gaps(ctrl, want)
    del ctrl
    broken = {}
    for grad in controls:
        _, zero = _patched(wkv, "wkv6_bwd", _without(grad),
                           lambda: _rwkv_grads(cfg, run, model, tokens, 1))
        broken[grad] = _leaf_gaps(zero, want)
        del zero
    del want
    torch.cuda.empty_cache()
    # one bound a kind of leaf (a block's leaf, any layer), from the control's
    # largest gap over the layers: one leaf's drift is too noisy a measure
    kinds: dict = {}
    for name, gap in control.items():
        kind = _leaf_kind(name)
        kinds[kind] = max(kinds.get(kind, 0.0), gap)
    bound = {n: max(floor, RWKV_DRIFT_RATIO * kinds[_leaf_kind(n)]) for n in control}
    worst = max(kernel, key=lambda n: kernel[n] / bound[n])
    caught = {g: max(b, key=lambda n: b[n] / bound[n]) for g, b in broken.items()}
    table = {}
    for name in control:
        row = table.setdefault(_leaf_kind(name), [0.0] * (2 + len(broken)))
        for i, g in enumerate([kernel[name], control[name]]
                              + [b[name] for b in broken.values()]):
            row[i] = max(row[i], g)
    unchecked = sorted({_leaf_kind(n) for n, b in bound.items() if b >= 1.0})
    out = {"layers": cfg.n_layers, "dtype": cfg.compute_dtype, "plain_s": plain_s,
           "loss": loss_k, "loss_plain": loss_p, "loss_f64": loss_c,
           "kernel_max": max(kernel.values()), "control_max": max(control.values()),
           "worst_leaf": worst, "worst": [kernel[worst], bound[worst]],
           "passes": all(kernel[n] <= bound[n] for n in kernel),
           "controls": {g: {"leaf": caught[g], "gap": [b[caught[g]], bound[caught[g]]],
                            "refused": any(b[n] > bound[n] for n in b)}
                        for g, b in broken.items()},
           "leaves_over_floor": sum(b > floor for b in bound.values()), "leaves": len(bound),
           "unchecked_kinds": unchecked, "by_kind": table}
    say(f"[{smi}] RWKV training (a) {cfg.compute_dtype} gradients at {cfg.n_layers} layers, "
        f"B={tokens.shape[0]} S={tokens.shape[1]} in one microbatch, against the plain "
        f"recurrence's run ({plain_s:.3f} s; loss {loss_k:.7f} against {loss_p:.7f}, f64 "
        f"control {loss_c:.7f}): each leaf within max({floor:g}, {RWKV_DRIFT_RATIO:g} x a "
        f"correct control's largest gap on its kind of leaf, the recurrence in f64 "
        f"rounded once; "
        f"{out['leaves_over_floor']} of {out['leaves']} bounds above the floor): the kernel's "
        f"largest gap {out['kernel_max']:.3e}, the control's {out['control_max']:.3e}; "
        f"closest to its bound {worst} {kernel[worst]:.3e} of {bound[worst]:.3e}: "
        f"{'passes' if out['passes'] else 'FAILS'}; " + "; ".join(
            f"the kernel with {g} = 0 at {c['leaf']} {c['gap'][0]:.3e} against "
            f"{c['gap'][1]:.3e}: {'refused' if c['refused'] else 'PASSED'}"
            for g, c in out["controls"].items()))
    say(f"  by kind of leaf, the largest gap of the kernel / the f64 control / "
        f"{' / '.join(f'{g} = 0' for g in broken)}: " + "; ".join(
            f"{k} " + "/".join(f"{x:.2e}" for x in row) for k, row in sorted(table.items())))
    say(f"  kinds whose bound is 1 or more, where a zero gradient passes and this gate "
        f"checks nothing: {unchecked or 'none'}")
    return out


def _leaf_kind(name: str) -> str:
    """A leaf's name without its layer: ``blocks.tm.u`` for ``blocks.6.tm.u``."""
    parts = name.split(".")
    return ".".join(p for i, p in enumerate(parts) if not (i == 1 and p.isdigit()))


def _rwkv_train_checks(smi, cfg, model) -> dict:
    """Phase 17 (a)'s gates at step 0 on phase 16's model: every leaf's
    gradient against the plain recurrence's run (:func:`_rwkv_grad_gate`)
    in bf16 at RWKV_GATE_LAYERS layers and in f32 at RWKV_F32_LAYERS."""
    import dataclasses

    import torch

    from repro_torch.data.pipeline import DataConfig, Pipeline

    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=RWKV_TRAIN_SEQ,
                               global_batch=RWKV_TRAIN_BATCH))
    tokens = torch.from_numpy(pipe.batch_for_step(0)["tokens"][:, :RWKV_GATE_SEQ].copy()).cuda()
    gcfg, gmodel = _rwkv_cut(cfg, model, RWKV_GATE_LAYERS)
    out = {"bfloat16": _rwkv_grad_gate(smi, gcfg, gmodel, tokens, RWKV_GRAD_FLOOR,
                                       RWKV_BF16_CONTROLS)}
    c32, m32 = _rwkv_cut(dataclasses.replace(cfg, compute_dtype="float32"), model,
                         RWKV_F32_LAYERS)
    out["float32"] = _rwkv_grad_gate(smi, c32, m32, tokens, TRAIN_GRAD_TOL["float32"],
                                     tuple(RWKV_ZEROED))
    del gmodel, m32
    torch.cuda.empty_cache()
    bad = []
    for dt in ("bfloat16", "float32"):
        if not out[dt]["passes"]:
            bad.append(f"{dt} gradients: {out[dt]['worst_leaf']} {out[dt]['worst']}")
        for grad, c in out[dt]["controls"].items():
            if not c["refused"]:
                bad.append(f"the {dt} bounds pass the kernel with {grad} = 0")
    if bad:
        fail("RWKV training (a): " + "; ".join(bad))
    return out


def _held_calls(smi, rec: dict, n_layers: int) -> dict:
    """(a)'s gate on the ``wkv6_bwd`` calls held by :func:`_bwd_beside` in
    step 0 of ``launch/train.py``'s run; fatal if one parts from the plain
    backward or a control passes."""
    import torch

    from repro_torch.models import transformer as T

    g = torch.stack(rec["gaps"]).cpu()
    calls = {"calls": RWKV_TRAIN_MB * n_layers, "held": len(rec["layers"]),
             "layers": sorted(set(rec["layers"])),
             "max": dict(zip(("dr", "dk", "dv", "dw", "du", "dstate0"),
                             g[:, :6].max(0).values.tolist())),
             "dw0_min": float(g[:, 6].min()), "du0_min": float(g[:, 7].min()),
             "max_abs": float(g[:, 8].max()),
             "dw0_refused": int((g[:, 6] > RWKV_BWD_TOL).sum()),
             "du0_refused": int((g[:, 7] > RWKV_BWD_TOL).sum())}
    say(f"[{smi}] RWKV training (a) step 0's wkv6_bwd: {calls['held']} of "
        f"{calls['calls']} calls (the first and last layer of each remat group: "
        f"{calls['layers']}) against wkv6_backward_plain on their inputs: max gaps "
        f"{ {k: f'{v:.3e}' for k, v in calls['max'].items()} } of max (tol "
        f"{RWKV_BWD_TOL:g}; max |d| {calls['max_abs']:.3e}); controls: dw = 0 refused in "
        f"{calls['dw0_refused']}, du = 0 in {calls['du0_refused']} of {calls['held']} "
        f"(smallest gaps {calls['dw0_min']:.3e}, {calls['du0_min']:.3e})")
    group = T._remat_group(n_layers)
    bad = []
    if calls["held"] != RWKV_TRAIN_MB * sum(layer % group in (0, group - 1)
                                            for layer in range(n_layers)):
        bad.append(f"{calls['held']} of {calls['calls']} calls held")
    if max(calls["max"].values()) > RWKV_BWD_TOL:
        bad.append(f"a wkv6_bwd call parts from the plain backward by {calls['max']}")
    if calls["dw0_refused"] != calls["held"] or calls["du0_refused"] != calls["held"]:
        bad.append("the per-call gate passes a backward with dw = 0 or du = 0")
    if bad:
        fail("RWKV training (a): " + "; ".join(bad))
    return calls


def _timed_train_steps(rec: dict, label: str, steps: int = RWKV_TRAIN_STEPS):
    """A wrapper of ``make_train_step`` whose ``steps`` steps are
    synchronised and timed on the host clock (the last one under
    ``torch.profiler``), their gnorms kept."""
    import torch

    def wrap(make):
        def factory(*args, **kw):
            step = make(*args, **kw)

            def timed(*a):
                torch.cuda.synchronize()
                if len(rec["ms"]) == steps - 1:
                    got = {}
                    rec["prof"] = _profile(lambda: got.setdefault("r", step(*a)), label,
                                           top=12)
                    r, ms = got["r"], rec["prof"]["wall_ms"]
                else:
                    t0 = time.perf_counter()
                    r = step(*a)
                    torch.cuda.synchronize()
                    ms = (time.perf_counter() - t0) * 1e3
                rec["ms"].append(ms)
                rec["gnorms"].append(float(r[1]["grad_norm"]))
                return r
            return timed
        return factory
    return wrap


def _rwkv_train_steps(smi, cfg) -> dict:
    """Phase 17 (a): RWKV_TRAIN_STEPS steps of rwkv6-3b at full width and
    depth through ``launch/train.py``, counts from 0: step 0's held
    ``wkv6_bwd`` calls (:func:`_held_calls`), finite losses and gnorms, the
    kernels' launches (the plain backward's calls those of the held ones),
    ms/step, tokens/s, peak, a profiled step."""
    import math
    import statistics

    import torch

    from repro_torch.kernels import wkv
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    argv = ["--arch", RWKV_ARCH, "--steps", str(RWKV_TRAIN_STEPS), "--batch",
            str(RWKV_TRAIN_BATCH), "--seq", str(RWKV_TRAIN_SEQ), "--microbatches",
            str(RWKV_TRAIN_MB), "--log-every", "1"]
    rec = {"ms": [], "gnorms": [], "prof": None}
    label = f"training step {RWKV_ARCH} B={RWKV_TRAIN_BATCH} S={RWKV_TRAIN_SEQ}"
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_wkv_counts()
    held = {"calls": 0, "gaps": [], "layers": []}
    t0 = time.perf_counter()
    losses = _patched(train, "make_train_step", _timed_train_steps(rec, label),
                      lambda: _patched(wkv, "wkv6_bwd", _bwd_beside(
                          held, cfg.n_layers, RWKV_TRAIN_MB * cfg.n_layers),
                          lambda: train.main(argv)))
    wall = time.perf_counter() - t0
    counts = _wkv_counts()
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    ms = statistics.median(rec["ms"][1:-1])
    per_step = T.block_forwards(cfg, T.RunCfg(remat=cfg.remat))
    want = {"wkv6": RWKV_TRAIN_STEPS * RWKV_TRAIN_MB * per_step, "wkv6_plain": 0,
            "wkv6_bwd": RWKV_TRAIN_STEPS * RWKV_TRAIN_MB * cfg.n_layers,
            "wkv6_plain_bwd": len(held["layers"])}
    out = {"calls": _held_calls(smi, held, cfg.n_layers), "losses": losses, "gnorms": rec["gnorms"], "step_ms": rec["ms"],
           "ms_per_step": ms, "tokens_per_s": RWKV_TRAIN_BATCH * RWKV_TRAIN_SEQ / (ms / 1e3),
           "peak_bytes": peak, "wall_s": wall, "counts": counts,
           "breakdown": rec["prof"]}
    say(f"[{smi}] RWKV training (a) {RWKV_ARCH} at full width and depth through "
        f"launch/train.py: {RWKV_TRAIN_STEPS} steps, B={RWKV_TRAIN_BATCH} "
        f"S={RWKV_TRAIN_SEQ}, {RWKV_TRAIN_MB} microbatches, bf16, remat: {wall:.3f} s; "
        f"losses {[round(x, 4) for x in losses]}, gnorms "
        f"{[round(x, 4) for x in rec['gnorms']]}; {ms:.3f} ms/step (steps "
        f"{', '.join(f'{t:.3f}' for t in rec['ms'])}; the first, then timed, the last "
        f"profiled), {out['tokens_per_s']:.1f} tokens/s, peak {peak / 2**30:.3f} GiB; "
        f"counts {counts} (want {want}: the plain backward's calls step 0's held ones)")
    for line in rec["prof"]["lines"]:
        say(line)
    if len(losses) != RWKV_TRAIN_STEPS or \
            not all(math.isfinite(x) for x in losses + rec["gnorms"]):
        fail(f"RWKV training (a): losses {losses}, gnorms {rec['gnorms']}")
    if counts != want:
        fail(f"RWKV training (a): counts {counts}, want {want}")
    return out


def _wkv_train_timing(gen) -> list:
    """``wkv6`` with checkpoints and ``wkv6_bwd`` at the training shape (a
    microbatch's B=4 and the whole batch's B=8, S=512, 40 heads of 64,
    bf16 r, k, v): each kernel (median of 7 CUDA-event timings), its plain
    version and its bound (bytes over 3.35 TB/s or f32 flops over 67
    TFLOP/s, the larger).  No single PyTorch call computes either."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import wkv

    cfg = get_config(RWKV_ARCH)
    h, k = cfg.n_heads, cfg.d_model // cfg.n_heads
    s = RWKV_TRAIN_SEQ
    out = []
    for b in (RWKV_TRAIN_BATCH // RWKV_TRAIN_MB, RWKV_TRAIN_BATCH):
        r, kk, v = (_rand((b, s, h, k), torch.float32, gen).bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(_rand((b, s, h, k), torch.float32, gen) - 1))
        u = _rand((h, k), torch.float32, gen) * 0.5
        st = _rand((b, h, k, k), torch.float32, gen) * 0.3
        dy = _rand((b, s, h, k), torch.float32, gen)
        ds = _rand((b, h, k, k), torch.float32, gen)
        _, _, ck = wkv._kernel(r, kk, v, w, u, st, checkpoints=True)
        cases = (
            ("wkv6 with checkpoints", lambda: wkv._kernel(r, kk, v, w, u, st, checkpoints=True),
             lambda: wkv.wkv6_plain(r, kk, v, w, u, st, checkpoints=True),
             wkv.wkv6_bytes(b, s, h, k, 2), wkv.wkv6_flops(b, s, h, k)),
            ("wkv6_bwd", lambda: wkv.wkv6_bwd(r, kk, v, w, u, ck, dy, ds),
             lambda: wkv.wkv6_backward_plain(r, kk, v, w, u, ck, dy, ds),
             wkv.wkv6_bwd_bytes(b, s, h, k, 2), wkv.wkv6_bwd_flops(b, s, h, k)))
        for name, kernel, plain, moved, flops in cases:
            ms, lo, hi = _median_ms(kernel, 10, 2)
            plain_ms = _time_ms(plain, 1, 1)
            bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
            rec = {"kernel": name, "shape": [b, s, h, k], "dtype": "bfloat16", "ms": ms,
                   "ms_spread": [lo, hi], "plain_ms": plain_ms, "library_ms": None,
                   "bytes": moved, "flops": flops, "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
            say(f"timing {name} B={b} S={s} H={h} K={k} bf16 r, k, v: kernel {ms:.4f} ms "
                f"({lo:.4f}-{hi:.4f}), plain {plain_ms:.3f} ms, library none; bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {moved} B {bytes_ms:.4f} ms, "
                f"{flops:.4g} flop {ops_ms:.4f} ms), {rec['bound_ms'] / ms:.1%} of the bound")
            out.append(rec)
        del r, kk, v, w, st, dy, ds, ck
    torch.cuda.empty_cache()
    return out


def _rwkv_mesh_cfg(dtype: str):
    """(b)'s config: rwkv6-3b cut to RWKV_MESH_LAYERS layers, ``dtype`` compute."""
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(RWKV_ARCH), n_layers=RWKV_MESH_LAYERS,
                               compute_dtype=dtype)


def rwkv_train(smi, cfg, checks: dict, t_phase: float) -> tuple:
    """Phase 17 (a) on one card after its gates at step 0 (``checks``, on
    phase 16's model, freed by then: ``launch/train.py`` makes its own),
    then (b)'s 1x1 runs; returns (the results, (b)'s 1x1 runs)."""
    import torch

    out = {"checks": checks}
    out.update(_rwkv_train_steps(smi, cfg))
    out["timing"] = _wkv_train_timing(torch.Generator(device="cuda").manual_seed(17))
    refs = {dt: _shard_steps(None, _rwkv_mesh_cfg(dt), RWKV_MESH_STEPS)
            for dt in ("float32", "bfloat16")}
    for dt, r in refs.items():
        say(f"[{smi}] RWKV training (b)'s 1x1 run, {RWKV_MESH_LAYERS} layers {dt}: losses "
            f"{[round(x, 6) for x in r['losses']]}, gnorms {[round(x, 6) for x in r['gnorms']]}, "
            f"{r['step_ms'][-1]:.3f} ms the last step")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] RWKV training: 17 (a) on one card in {out['phase_s']:.3f} s")
    return out, refs


def _whole_over_model(cfg, run, model) -> int:
    """A fingerprint of this rank's shards of the leaves whole over
    ``model``: their bits as int32, weighted by position and summed in
    int64 (one element's change always changes it)."""
    import torch

    from repro_torch.distributed import sharding as SH
    from repro_torch.models import transformer as T

    specs = T.param_specs(cfg, run.mesh)
    bits = torch.cat([p.detach().reshape(-1).view(torch.int32).long()
                      for n, p in model.named_parameters()
                      if "model" not in SH.spec_axes(specs[n])])
    pos = torch.arange(1, bits.numel() + 1, device=bits.device, dtype=torch.int64)
    return int((bits * pos).sum())


def _no_grad_gather(_gather_from):
    """(b)'s control in place of ``gather_from``: ``all_gather``, no autograd."""
    from repro_torch.distributed import collectives as C

    return lambda x, axes, dim=-1: C.all_gather(x, axes, dim=dim)


def _rwkv_train_ranks(ctx) -> dict:
    """Phase 17 (b) on this rank of 2x2: RWKV_MESH_STEPS steps of the cut
    model in f32 and in bf16, and the two controls in f32, each leaf whole
    over ``model`` fingerprinted after every step."""
    from repro_torch.distributed import collectives as C
    from repro_torch.models import rwkv as RW

    c32 = _rwkv_mesh_cfg("float32")
    out = {dt: _shard_steps(ctx, _rwkv_mesh_cfg(dt), RWKV_MESH_STEPS,
                            after_step=_whole_over_model)
           for dt in ("float32", "bfloat16")}
    out["unsummed"] = _patched(RW, "SHARED", lambda _: (), lambda: _shard_steps(
        ctx, c32, RWKV_MESH_STEPS, after_step=_whole_over_model))
    out["all_gather"] = _patched(C, "gather_from", _no_grad_gather, lambda: _shard_steps(
        ctx, c32, RWKV_MESH_STEPS, after_step=_whole_over_model))
    return out


def rwkv_train_mesh(smi, refs, ranks) -> tuple:
    """Phase 17 (b)'s gates, from the ranks' results and (a)'s 1x1 runs:
    returns (the readings, the launches of the sound runs summed over the
    ranks)."""
    import statistics

    from repro_torch.models import transformer as T

    c32 = _rwkv_mesh_cfg("float32")
    runs = [r["train"] for r in ranks]
    tols = (SHARD_LOSS_TOL, SHARD_GNORM_TOL, SHARD_MOVED_TOL)

    def same_bits(key):  # ranks 2m and 2m + 1 differ in their model coordinate only
        return all(runs[i][key]["after_step"] == runs[i + 1][key]["after_step"]
                   for i in range(0, len(runs), 2))

    r0 = runs[0]
    b = r0["bfloat16"]
    steps = RWKV_MESH_STEPS
    per_step = {k: v / steps for k, v in b["counts"].items()
                if k.startswith("collectives.") or k in ("wire_bytes", "ring_send")}
    say(f"[{smi}] RWKV training (b) {RWKV_ARCH} cut to {RWKV_MESH_LAYERS} layers on 2x2 (4 "
        f"ranks on one card), B={TRAIN_BATCH} S={TRAIN_SEQ}: bf16 "
        f"{statistics.median(b['step_ms'][1:]):.3f} ms/step on rank 0 (steps "
        f"{', '.join(f'{t:.3f}' for t in b['step_ms'])}), peak a rank "
        f"{max(r['bfloat16']['peak_bytes'] for r in runs) / 2**30:.3f} GiB; a step's "
        f"exchanges and wire bytes {per_step}")
    say(_steps_line("RWKV training (b) f32 2x2 rank 0", r0["float32"], refs["float32"], "1x1"))
    say(_steps_line("RWKV training (b) bf16 2x2 rank 0 (shown)", b, refs["bfloat16"], "1x1"))
    out = {"ms_per_step_bf16": statistics.median(b["step_ms"][1:]),
           "peak_bytes": max(r["bfloat16"]["peak_bytes"] for r in runs),
           "per_step": per_step, "same_bits": {k: same_bits(k) for k in r0}}
    bad = _step_faults("f32 rank 0", r0["float32"], refs["float32"], *tols)
    for key in ("unsummed", "all_gather"):
        faults = _step_faults(key, r0[key], refs["float32"], *tols)
        out[key] = {"refused": bool(faults) or not out["same_bits"][key],
                    "faults": faults, "losses": r0[key]["losses"],
                    "gnorms": r0[key]["gnorms"], "moved": r0[key]["moved"]}
        say(_steps_line(f"RWKV training (b) control, {key}, rank 0", r0[key],
                        refs["float32"], "1x1")
            + f"; leaves whole over model the same bits on its ranks: "
            f"{out['same_bits'][key]}: {'refused' if out[key]['refused'] else 'PASSED'}")
        if not out[key]["refused"]:
            bad.append(f"the gates pass the control {key}")
    say(f"[{smi}] RWKV training (b): leaves whole over model the same bits on both ranks "
        f"of model after every step: f32 {out['same_bits']['float32']}, bf16 "
        f"{out['same_bits']['bfloat16']}")
    for dt in ("float32", "bfloat16"):
        if not out["same_bits"][dt]:
            bad.append(f"{dt}: the leaves whole over model part across its ranks")
    if not all(x == x and abs(x) < float("inf") for x in b["losses"] + b["gnorms"]):
        bad.append("bf16: a loss or gnorm not finite")
    fwd = T.block_forwards(c32, T.RunCfg(remat=c32.remat))
    launches = {"wkv6": 0, "wkv6_bwd": 0, "ring_send": 0, "ring_land": 0}
    for r in runs:
        for dt in ("float32", "bfloat16"):
            c = r[dt]["counts"]
            if (c["wkv6"], c["wkv6_bwd"], c["wkv6_plain"], c["wkv6_plain_bwd"]) != \
                    (steps * fwd, steps * RWKV_MESH_LAYERS, 0, 0):
                bad.append(f"{dt} rank counts {c}")
            for k in launches:
                launches[k] += c[k]
    if bad:
        fail("RWKV training (b): " + "; ".join(bad))
    return out, launches


# ---------------------------------------------------------------------------
# phase 18: Jamba (jamba-1.5-large-398b) served at full width on one card:
# one superblock, the card holding 8 of each MoE layer's 16 experts
# ---------------------------------------------------------------------------

JAMBA_ARCH = "jamba-1.5-large-398b"
# one superblock of its 72 layers (the least depth that keeps the 1:7
# attention:Mamba period and the MoE every other layer) holds 45.24 B
# params with the embedding and head, 90.5 GB in bf16 against the card's
# 80: the card holds experts 0-7 of each MoE layer's 16, its share of a
# deployment that puts them over 2 chips, expert-parallel, everything else
# whole on both (25.91 B params, 51.8 GB); capacity factor 1.25 (the
# config's)
JAMBA_LAYERS = 8
JAMBA_EXPERTS = (0, 8)
# (a) phase 8's batch, prompt and gen.  (b) the plain scan's and plain
# attention's run, teacher-forced for JAMBA_CHECK_GEN tokens with the
# expert choices pinned to (a)'s (``moe.routing``: bf16 routing flips
# under roundoff); every call of the recurrence in it also runs the kernel
# on the same inputs: y and the final state within JAMBA_LAYER_TOL of max
# (both f32: roundoff and ex2), a gate that must refuse the kernel reading
# B of the step before (the likely fault of a staged chunk) in every call.
# The bf16 logits within max(LM_TOL_BF16, JAMBA_DRIFT_RATIO x the gap of a
# correct control, the scan in f64 rounded once) of the plain run's, a
# bound that the off-by-one kernel in every layer must exceed.  (c) f32 at
# LM_PROMPT_F32, JAMBA_F32_GEN tokens, the plain run pinned to the
# kernel run's routing and teacher-forced with its tokens: logits within
# LM_TOL_F32
JAMBA_LAYER_TOL = 1e-5
JAMBA_DRIFT_RATIO = 2.0
JAMBA_CHECK_GEN = MESH_GEN  # _first_steps cuts the routing to MESH_GEN
JAMBA_F32_GEN = 8
JAMBA_ONLY = "--jamba-only"
# the special function units' ex2 rate, 16 a clock an SM (CUDA C++
# Programming Guide, arithmetic instructions, compute capability 9.0)
SFU_PER_CLOCK = 16
H100_SMS = 132
# FMA-pipe instructions of a 2^x at f32 accuracy without the special
# function units: a round and a subtract to split off the exponent, a
# degree-6 polynomial of the fraction by Horner (the exponent's scaling
# an integer add, on the integer pipe)
POLY_EXP2_FMA_INSTR = 8


def _arith_ms(flops_ms: float, sfu_ms: float, poly_ms: float) -> float:
    """The least time of the arithmetic when each exponential may run on
    the special function units (``sfu_ms`` for all of them) or as a
    polynomial on the FMA pipes (``poly_ms`` for all), beside the other f32
    work there (``flops_ms``): the share moved to the FMA pipes that
    levels the two."""
    moved = min(1.0, max(0.0, (sfu_ms - flops_ms) / (poly_ms + sfu_ms)))
    return max(flops_ms + moved * poly_ms, (1 - moved) * sfu_ms)


def scan_ptxas(log: str) -> list:
    """Phase 2, ``selective_scan``: registers and spill bytes of each
    instantiation of the forward and of the backward (f32 and bf16 x,
    d_state 8 and 16); fatal on a spill or a missing one."""
    dtype = {"f": "float32", "13__nv_bfloat16": "bfloat16"}
    out = []
    # the forward with (Lb1) and without (Lb0) its checkpoints, the backward
    for kernel, keep, n in (("selective_scan_kernel", r"ELb([01])", 8),
                            ("selective_scan_bwd_kernel", "", 4)):
        ks = _ptxas_entries(log, rf"\d{kernel}I(f|13__nv_bfloat16)Li(\d+){keep}E")
        say(f"  ptxas {kernel}, registers / spill bytes: " + ", ".join(
            f"<{dtype[k['groups'][0]]}, d_state={k['groups'][1]}"
            f"{', checkpoints' if k['groups'][2:] == ['1'] else ''}>: {k['registers']}/"
            f"{k['spill_bytes']}" for k in ks))
        if len(ks) != n or any(k["spill_bytes"] != 0 for k in ks):
            fail(f"{kernel} instantiations: {ks}")
        out += [{"source": "selective_scan", "kernel": kernel,
                 "dtype": dtype[k["groups"][0]], "d_state": int(k["groups"][1]),
                 "checkpoints": k["groups"][2:] == ["1"],
                 "registers": k["registers"], "spill_bytes": k["spill_bytes"]} for k in ks]
    return out


def _scan_counts() -> dict:
    from repro_torch.kernels import attention
    from repro_torch.kernels import selective_scan as SS

    return {"selective_scan": SS.launches, "selective_scan_plain": SS.plain_calls,
            "flash_attention": attention.launches,
            "flash_attention_plain": attention.plain_calls}


def _zero_scan_counts() -> None:
    from repro_torch.kernels import attention
    from repro_torch.kernels import selective_scan as SS

    SS.launches = SS.plain_calls = attention.launches = attention.plain_calls = 0


def _scan_only(scans: int, flash: int) -> dict:
    """The counts of a run that launches the scan ``scans`` times and the
    flash kernel ``flash`` times, and calls no plain version."""
    return {"selective_scan": scans, "selective_scan_plain": 0, "flash_attention": flash,
            "flash_attention_plain": 0}


def _b_of_the_step_before(b):
    """B (rows, S, d_state) as the off-by-one control reads it: each step
    B of the step before, zeros before the first."""
    import torch

    return torch.cat([torch.zeros_like(b[:, :1]), b[:, :-1]], 1)


def _scan_beside(gaps: list):
    """A wrapper of ``selective_scan_plain`` that also runs the kernel on
    the same inputs, and the kernel reading B of the step before (the
    control), and records each call's gaps to the plain version (device
    scalars: no synchronisation a call)."""
    import torch

    from repro_torch.kernels import selective_scan as SS

    def wrap(plain):
        def both(dt, x, b, c, a_log, d, h0):
            y, h = plain(dt, x, b, c, a_log, d, h0)
            yk, hk = SS.selective_scan(dt, x, b, c, a_log, d, h0)
            yo, _ = SS.selective_scan(dt, x, _b_of_the_step_before(b), c, a_log, d, h0)
            ym, hm = y.abs().max(), h.abs().max()
            dy, dh = (yk - y).abs().max(), (hk - h).abs().max()
            gaps.append(torch.stack([dy / ym, dh / hm, (yo - y).abs().max() / ym,
                                     torch.maximum(dy, dh),
                                     torch.tensor(float(dt.shape[1]), device=y.device)]))
            return y, h
        return both
    return wrap


def _scan_f64(_plain):
    """(b)'s correct control in place of ``selective_scan_plain``: the same
    step loop in f64, its y and state rounded to f32 once."""
    import torch

    def f64(dt, x, b, c, a_log, d, h0):
        dtd, xd, bd, cd = dt.double(), x.double(), b.double(), c.double()
        a, h = -torch.exp(a_log.double()), h0.double()
        dtx = dtd * xd
        ys = []
        for t in range(dt.shape[1]):
            h = torch.exp(dtd[:, t, :, None] * a) * h + dtx[:, t, :, None] * bd[:, t, None, :]
            ys.append(torch.matmul(h, cd[:, t, :, None])[..., 0])
        return (torch.stack(ys, 1) + xd * d.double()).float(), h.float()
    return f64


def _off_by_one(kernel):
    """(b)'s broken control in place of ``selective_scan``: the kernel
    reading B of the step before."""
    return lambda dt, x, b, c, a_log, d, h0: kernel(dt, x, _b_of_the_step_before(b), c,
                                                    a_log, d, h0)


def _sm_clock_mhz() -> tuple:
    """(max, current) SM clock in MHz, as ``nvidia-smi`` reads them."""
    got = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    top, now = (float(v) for v in got.split(","))
    return top, now


def _scan_timing(gen, clock_mhz: float) -> list:
    """``selective_scan`` at the prefill shape (B=8, S=2048, d_inner 16384,
    d_state 16, bf16 x) and at a decode step's (S=1): the kernel (median of
    7 CUDA-event timings), its plain version, and the bound: the larger of
    :func:`selective_scan_bytes` over 3.35 TB/s and the arithmetic
    (:func:`_arith_ms`: :func:`selective_scan_flops` over the f32 CUDA
    cores' 67 TFLOP/s, :func:`selective_scan_exps` split between the
    special function units' ex2 rate at the card's max SM clock and
    :data:`POLY_EXP2_FMA_INSTR` FMA-pipe instructions each; ``bound_by``
    "operations" where it decides).  The exponentials on the special
    function units alone (``exps_sfu``) are printed beside it.  No single
    PyTorch call computes the recurrence: no library time."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.models import transformer as T

    md = T.mamba_dims(get_config(JAMBA_ARCH))
    di, ds = md.d_inner, md.d_state
    sfu_per_s = SFU_PER_CLOCK * H100_SMS * clock_mhz * 1e6
    out = []
    for s in (LM_PROMPT, 1):
        b = LM_BATCH
        dt = torch.nn.functional.softplus(_rand((b, s, di), torch.float32, gen) - 1)
        x = _rand((b, s, di), torch.float32, gen).bfloat16()
        bm, cm = (_rand((b, s, ds), torch.float32, gen) for _ in range(2))
        a_log = _rand((di, ds), torch.float32, gen) * 0.5
        d = _rand((di,), torch.float32, gen)
        h0 = _rand((b, di, ds), torch.float32, gen) * 0.3
        args = (dt, x, bm, cm, a_log, d, h0)
        ms, lo, hi = _median_ms(lambda: SS.selective_scan(*args), 10, 2)
        plain_ms = _time_ms(lambda: SS.selective_scan_plain(*args), 1, 1)
        moved = SS.selective_scan_bytes(b, s, di, ds, 2)
        flops, exps = SS.selective_scan_flops(b, s, di, ds), SS.selective_scan_exps(b, s, di, ds)
        terms = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "flops": flops / FP32_FLOPS * 1e3,
                 "exps_sfu": exps / sfu_per_s * 1e3,
                 "exps_poly": exps * 2 * POLY_EXP2_FMA_INSTR / FP32_FLOPS * 1e3}
        terms["arith"] = _arith_ms(terms["flops"], terms["exps_sfu"], terms["exps_poly"])
        decides = "bytes" if terms["bytes"] >= terms["arith"] else "arith"
        rec = {"kernel": "selective_scan", "shape": [b, s, di, ds], "dtype": "bfloat16",
               "ms": ms, "ms_spread": [lo, hi], "plain_ms": plain_ms, "library_ms": None,
               "bytes": moved, "flops": flops, "exps": exps, "clock_mhz": clock_mhz,
               "terms_ms": terms, "decides": decides, "bound_ms": terms[decides],
               "bound_by": "bytes" if decides == "bytes" else "operations"}
        say(f"timing selective_scan B={b} S={s} d_inner={di} d_state={ds} bf16 x: kernel "
            f"{ms:.4f} ms ({lo:.4f}-{hi:.4f}), plain {plain_ms:.3f} ms, library none; bound "
            f"{rec['bound_ms']:.4f} ms ({decides}: {moved} B {terms['bytes']:.4f} ms; "
            f"arithmetic {terms['arith']:.4f} ms: {flops:.4g} flop {terms['flops']:.4f} ms "
            f"beside {exps:.4g} exps split between the SFU, {SFU_PER_CLOCK} a clock on "
            f"{H100_SMS} SMs at {clock_mhz:.0f} MHz ({terms['exps_sfu']:.4f} ms for all), "
            f"and the FMA pipes, {POLY_EXP2_FMA_INSTR} instructions each "
            f"({terms['exps_poly']:.4f} ms for all)), {rec['bound_ms'] / ms:.1%} of the "
            f"bound, {terms['exps_sfu'] / ms:.1%} of the exps' time on the SFU alone")
        out.append(rec)
        del args, dt, x, bm, cm, h0
    torch.cuda.empty_cache()
    return out


def _state_bytes(cache) -> dict:
    """A Jamba decode cache's bytes: the Mamba layers' states (conv and
    ssm) and the attention layer's k and v."""
    nbytes = {k: t.numel() * t.element_size() for k, t in cache.items() if k != "len"}
    return {"mamba": nbytes["conv"] + nbytes["ssm"], "conv": nbytes["conv"],
            "ssm": nbytes["ssm"], "kv": nbytes["k"] + nbytes["v"]}


def jamba_lm(smi):
    """Phase 18 on one card: jamba-1.5-large-398b at full width (d 8192, 64
    heads on 8 kv heads of 128, d_ff 24576, 16 experts top-2 at d_ff 24576
    every other layer, Mamba d_state 16, d_conv 4, d_inner 16384, vocab
    65536), one superblock (72 -> 8 layers), experts 0-7 of each MoE
    layer's 16 held, bf16, random weights from seed 0.  Returns (results,
    the main path's launches of ``selective_scan`` and
    ``flash_attention``)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import mamba as MB
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    clock_mhz, clock_now = _sm_clock_mhz()
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    run = T.RunCfg()
    nm = T.stack_sizes(cfg)["blocks"] * (cfg.hybrid_period - 1)  # its Mamba layers
    # the launcher's own command (README's), in this process: its model made
    # and freed before (a)'s
    argv = ["--arch", JAMBA_ARCH, "--layers", str(JAMBA_LAYERS), "--experts",
            f"{JAMBA_EXPERTS[0]}:{JAMBA_EXPERTS[1]}", "--batch", str(LM_BATCH),
            "--prompt-len", str(LM_PROMPT), "--gen", str(LM_GEN)]
    _zero_scan_counts()
    t0 = time.perf_counter()
    launched = serve.main(argv).cpu()
    launcher = {"argv": argv, "counts": _scan_counts(), "s": time.perf_counter() - t0}
    torch.cuda.empty_cache()
    plain_run = dataclasses.replace(run, plain_scan=True, plain_attention=True)
    t0 = time.perf_counter()
    model = T.init_model(cfg, seed=0, device="cuda", experts=JAMBA_EXPERTS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    tokens = serve.prompt_tokens(cfg, LM_BATCH, LM_PROMPT, "cuda")
    serve.generate(cfg, run, model, tokens[:, :64], 2)  # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_scan_counts()
    r, record = _record(lambda: serve.generate(cfg, run, model, tokens, LM_GEN,
                                               keep_logits=True))
    counts = _scan_counts()
    steps = LM_GEN - 1
    out = {"arch": JAMBA_ARCH, "layers": JAMBA_LAYERS, "experts_held": list(JAMBA_EXPERTS),
           "params": n_params, "param_bytes": param_bytes, "init_s": init_s,
           "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN, "counts": counts,
           "prefill_ms": r["prefill_ms"], "decode_ms_per_step": r["decode_ms"] / steps,
           "tok_per_s": steps * LM_BATCH / (r["decode_ms"] / 1e3),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "held_before": before, "state_bytes": _state_bytes(r["cache"]),
           "sample": r["tokens"][0, :16].tolist(), "clock_mhz": [clock_mhz, clock_now]}
    launcher["agree"] = float((launched == r["tokens"].cpu()).float().mean())
    out["launcher"] = launcher
    say(f"[{smi}] Jamba launcher: python3 -m repro_torch.launch.serve {' '.join(argv)} in "
        f"{launcher['s']:.1f} s: counts {launcher['counts']}; its tokens {tuple(launched.shape)} "
        f"agree with (a)'s on {launcher['agree']:.2%}")
    # one more prefill and one decode step, each counted alone and profiled
    _zero_scan_counts()
    prof_prefill = _profile(lambda: T.prefill(cfg, run, model, {"tokens": tokens},
                                              t_max=LM_PROMPT + LM_GEN),
                            f"Jamba prefill {JAMBA_ARCH} 1 superblock B={LM_BATCH} "
                            f"S={LM_PROMPT}")
    out["prefill_counts"] = _scan_counts()
    cache, tok = r["cache"], r["tokens"][:, -1:]
    _zero_scan_counts()
    prof_decode = _profile(lambda: T.decode_step(cfg, run, model, cache, tok),
                           f"Jamba decode step {JAMBA_ARCH} B={LM_BATCH}")
    out["step_counts"] = _scan_counts()
    out["breakdown"] = [prof_prefill, prof_decode]
    st = out["state_bytes"]
    say(f"[{smi}] Jamba (a) {JAMBA_ARCH}, 1 superblock ({JAMBA_LAYERS} of 72 layers), "
        f"experts {JAMBA_EXPERTS[0]}-{sum(JAMBA_EXPERTS) - 1} of each MoE layer's "
        f"{cfg.moe.n_experts} held: {n_params} params, {param_bytes / 1e9:.2f} GB bf16 "
        f"(made in {init_s:.1f} s; {before / 2**30:.2f} GiB held before); bf16 "
        f"B={LM_BATCH} prompt={LM_PROMPT} gen={LM_GEN}: prefill {out['prefill_ms']:.3f} ms, "
        f"decode {out['decode_ms_per_step']:.3f} ms/step ({out['tok_per_s']:.1f} tok/s), "
        f"peak {out['peak_bytes'] / 2**30:.3f} GiB; decode state: Mamba's conv + ssm "
        f"{st['mamba']} B ({st['conv']} + {st['ssm']}) at any length, the attention "
        f"layer's k + v {st['kv']} B at {LM_PROMPT + LM_GEN} positions; counts {counts}, "
        f"a prefill {out['prefill_counts']}, a decode step {out['step_counts']}; sample "
        f"{out['sample']}")
    for line in prof_prefill["lines"] + prof_decode["lines"]:
        say(line)
    del cache, tok

    # (b) the plain run, teacher-forced, the routing pinned to (a)'s; every
    # call of the recurrence in it also runs the kernel on the same inputs
    forced, pinned = r["tokens"][:, :JAMBA_CHECK_GEN], _first_steps(record, LM_GEN)
    kernel_logits = r["logits"][:JAMBA_CHECK_GEN]
    kept_tokens = r["tokens"].cpu()
    del r, record

    def teacher(run_):
        return serve.generate(cfg, run_, model, tokens, JAMBA_CHECK_GEN, forced=forced,
                              keep_logits=True)

    gaps = []
    p, flips = _replay(lambda: _patched(MB, "selective_scan_plain", _scan_beside(gaps),
                                        lambda: teacher(plain_run)), pinned)
    g = torch.stack(gaps).cpu()
    prefill_rows = g[:, 4] > 1
    layer = {"calls": len(gaps), "prefill_calls": int(prefill_rows.sum()),
             "y_max": float(g[:, 0].max()), "state_max": float(g[:, 1].max()),
             "prefill_y_max": float(g[prefill_rows, 0].max()),
             "max_abs": float(g[:, 3].max()), "shifted_min": float(g[:, 2].min()),
             "shifted_refused": int((g[:, 2] > JAMBA_LAYER_TOL).sum()),
             "pinned_flips": flips}
    # a correct recurrence in other roundings (f64; the flash kernel's
    # attention, as the kernel run's) and a broken one (B of the step
    # before in every layer's kernel), the same tokens forced and routing
    # pinned
    c, _ = _replay(lambda: _patched(MB, "selective_scan_plain", _scan_f64, lambda: teacher(
        dataclasses.replace(run, plain_scan=True))), pinned)
    o, _ = _replay(lambda: _patched(MB, "selective_scan", _off_by_one,
                                    lambda: teacher(run)), pinned)
    logit_gaps = _logit_gaps(p["logits"], kernel_logits)
    drift = _logit_gaps(p["logits"], c["logits"])
    broken = _logit_gaps(p["logits"], o["logits"])
    bound = max(LM_TOL_BF16, JAMBA_DRIFT_RATIO * max(drift))
    finite = all(bool(torch.isfinite(x).all()) for x in kernel_logits)
    out.update(layer=layer, gap_prefill=logit_gaps[0], gap_max=max(logit_gaps),
               drift_prefill=drift[0], drift_max=max(drift), shifted_gap_max=max(broken),
               bound=bound, plain_prefill_ms=p["prefill_ms"],
               plain_decode_ms_per_step=p["decode_ms"] / (JAMBA_CHECK_GEN - 1))
    del p, c, o, kernel_logits
    say(f"[{smi}] Jamba (b) every call of the recurrence in the plain run ({layer['calls']}: "
        f"{layer['prefill_calls']} at S={LM_PROMPT}, the rest decode steps; expert choices "
        f"pinned to (a)'s, its own differing on {flips:.2%} of the tokens) against the "
        f"kernel on the same inputs: y {layer['y_max']:.3e} (the prefill's "
        f"{layer['prefill_y_max']:.3e}), state {layer['state_max']:.3e} of max (tol "
        f"{JAMBA_LAYER_TOL:g}; max |d| {layer['max_abs']:.3e}); control, B of the step "
        f"before: the smallest gap {layer['shifted_min']:.3e}, refused in "
        f"{layer['shifted_refused']} of {layer['calls']} calls")
    say(f"[{smi}] Jamba (b) bf16 logits against the plain run (plain scan and attention, "
        f"{JAMBA_CHECK_GEN} tokens, teacher-forced, routing pinned): the kernel run prefill "
        f"{logit_gaps[0]:.3e}, max {max(logit_gaps):.3e}; a correct control (the scan in "
        f"f64, rounded once) prefill {drift[0]:.3e}, max {max(drift):.3e}; bound max("
        f"{LM_TOL_BF16:g}, {JAMBA_DRIFT_RATIO:g} x the control's) = {bound:.3e}; the kernel "
        f"reading B of the step before in every layer {max(broken):.3e}: "
        f"{'refused' if max(broken) > bound else 'PASSED'}; plain prefill "
        f"{out['plain_prefill_ms']:.1f} ms, decode {out['plain_decode_ms_per_step']:.1f} "
        f"ms/step")

    # (c) f32 at LM_PROMPT_F32: the kernel run, then the plain run pinned to
    # its routing and teacher-forced with its tokens
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    t32 = tokens[:, :LM_PROMPT_F32]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _zero_scan_counts()
    k32, rec32 = _record(lambda: serve.generate(cfg32, run, model, t32, JAMBA_F32_GEN,
                                                keep_logits=True))
    n32 = _scan_counts()
    peak32 = torch.cuda.max_memory_allocated()
    p32, flips32 = _replay(lambda: serve.generate(
        cfg32, plain_run, model, t32, JAMBA_F32_GEN, forced=k32["tokens"],
        keep_logits=True), rec32)
    gaps32 = _logit_gaps(k32["logits"], p32["logits"])
    same = bool(torch.equal(k32["tokens"], p32["tokens"]))
    out["f32"] = {"prompt": LM_PROMPT_F32, "gen": JAMBA_F32_GEN, "counts": n32,
                  "prefill_ms": k32["prefill_ms"], "plain_prefill_ms": p32["prefill_ms"],
                  "decode_ms_per_step": k32["decode_ms"] / (JAMBA_F32_GEN - 1),
                  "peak_bytes": peak32, "same_tokens": same, "gap_max": max(gaps32),
                  "pinned_flips": flips32}
    del k32, p32, rec32
    say(f"[{smi}] Jamba (c) f32 (prompt {LM_PROMPT_F32}, {JAMBA_F32_GEN} tokens; each "
        f"sub-layer's params cast to f32 as it runs): kernel prefill "
        f"{out['f32']['prefill_ms']:.3f} ms, decode {out['f32']['decode_ms_per_step']:.3f} "
        f"ms/step, plain prefill {out['f32']['plain_prefill_ms']:.3f} ms, peak "
        f"{peak32 / 2**30:.3f} GiB; the plain run pinned to the kernel run's routing (its "
        f"own differing on {flips32:.2%}) and teacher-forced: greedy tokens "
        f"{'identical' if same else 'DIFFER'}, logits gap max {max(gaps32):.3e} of "
        f"max|logit| (tol {LM_TOL_F32:g}); counts {n32}")
    del model
    torch.cuda.empty_cache()
    out["timing"] = _scan_timing(torch.Generator(device="cuda").manual_seed(18), clock_mhz)

    bad = []
    if launcher["counts"] != _scan_only(nm * LM_GEN, 1) \
            or tuple(launched.shape) != (LM_BATCH, LM_GEN):
        bad.append(f"the launcher: counts {launcher['counts']}, tokens "
                   f"{tuple(launched.shape)}: want {nm * LM_GEN} scan launches, 1 flash "
                   f"launch, no plain call, ({LM_BATCH}, {LM_GEN}) tokens")
    if counts != _scan_only(nm * LM_GEN, 1) or out["prefill_counts"] != _scan_only(nm, 1) \
            or out["step_counts"] != _scan_only(nm, 0):
        bad.append(f"counts {counts}, a prefill {out['prefill_counts']}, a step "
                   f"{out['step_counts']}: want {nm} scan launches a prefill and {nm} a "
                   "step, 1 flash launch a prefill, no plain call")
    if layer["y_max"] > JAMBA_LAYER_TOL or layer["state_max"] > JAMBA_LAYER_TOL:
        bad.append(f"a layer's kernel output parts from the plain recurrence by "
                   f"{max(layer['y_max'], layer['state_max']):.3e}")
    if layer["shifted_refused"] != layer["calls"]:
        bad.append(f"the gate passes the kernel reading B of the step before in "
                   f"{layer['calls'] - layer['shifted_refused']} calls")
    if max(logit_gaps) > bound or not finite:
        bad.append(f"logits gap {max(logit_gaps):.3e} > {bound:.3e}, or non-finite")
    if out["shifted_gap_max"] <= bound:
        bad.append(f"the logits bound passes the off-by-one kernel "
                   f"({out['shifted_gap_max']:.3e})")
    if max(gaps32) > LM_TOL_F32 or n32 != _scan_only(nm * JAMBA_F32_GEN, 1):
        bad.append(f"f32: gap {max(gaps32):.3e}, counts {n32}")
    if tuple(kept_tokens.shape) != (LM_BATCH, LM_GEN):
        bad.append(f"tokens {tuple(kept_tokens.shape)}")
    say(f"[{smi}] Jamba: phase 18 (a)-(c) on one card in "
        f"{time.perf_counter() - t_phase:.3f} s")
    if bad:
        fail("Jamba: " + "; ".join(bad))
    out["max_abs_err"] = layer["max_abs"]
    main = [launcher["counts"], counts, out["prefill_counts"], out["step_counts"], n32]
    launches = {k: sum(c[k] for c in main) for k in ("selective_scan", "flash_attention")}
    out["train"], trained = jamba_train(smi, clock_mhz)
    for k, n in trained.items():
        launches[k] = launches.get(k, 0) + n
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] Jamba: phase 18 on one card in {out['phase_s']:.3f} s")
    return out, launches


# phase 18 (d): Jamba trained at full width on one card, one superblock,
# the card holding expert 0 of each MoE layer's 16: one chip's share of a
# deployment that puts each MoE layer's experts over 16 chips, one expert
# each, expert-parallel, everything else whole on every chip (9.00 B params;
# bf16 params, gradients and both moments, the config's dtypes: 72.0 GB);
# the launcher's default one microbatch (the config's 8 would add an f32
# accumulator, 36 GB)
JAMBA_TRAIN_EXPERTS = (0, 1)
JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, JAMBA_TRAIN_STEPS = 8, 512, 4
# step 0's selective_scan_bwd calls (all 7) against the plain backward on
# the same inputs: each output within JAMBA_BWD_TOL of its max (f32: the
# same arithmetic summed in another order); two controls made from the
# kernel's own result, dC of the step before and dA_log = 0, refused in
# every call.  The forward with checkpoints on the same inputs too: y, the
# final state and every checkpoint (the kernel's again and those the run
# kept) within JAMBA_LAYER_TOL of max; the run's checkpoints a step late
# refused in every call
JAMBA_BWD_TOL = 1e-5
# step 0's gradients at B=JAMBA_GATE_BATCH, S=JAMBA_GATE_SEQ (the first rows
# and positions of the step's batch) against the plain scan's run (torch's
# autograd through its step loop), the expert choices pinned to the kernel
# run's: each leaf's ||g - g_plain|| / ||g_plain|| within max(floor,
# JAMBA_DRIFT_RATIO x a correct control's gap on its kind of leaf, the scan
# in f64 rounded once), bounds that each planted fault (JAMBA_FAULTS) must
# exceed on some leaf.  Fewer positions than the steps': the plain loop's
# autograd keeps ~4 (B, d_inner, d_state) f32 tensors a step of a Mamba
# layer (16 GB at B=8, S=512) beside the model and two runs' gradients
# (18 GB each), and its time goes with S (a few launches a step); one
# run's gradients are compared and freed before the next
JAMBA_GATE_BATCH, JAMBA_GATE_SEQ = 8, 128
JAMBA_GRAD_FLOOR = TRAIN_GRAD_TOL["bfloat16"]


def _dc_of_the_step_before(dc):
    """dC (rows, S, d_state) as the control reads it: each step the step
    before's, zeros before the first."""
    import torch

    return torch.cat([torch.zeros_like(dc[:, :1]), dc[:, :-1]], 1)


def _scan_bwd_kept(rec: dict, first: int):
    """A wrapper of ``selective_scan_bwd`` that keeps its ``first`` calls'
    inputs and outputs on the host, for :func:`_held_scan_calls` to hold
    against the plain backward once the run has freed the card: the plain
    backward's temporaries beside a step's would raise the run's peak."""

    def host(t):
        return None if t is None else t.to("cpu", copy=True)

    def wrap(kernel_bwd):
        def both(*args):
            got = kernel_bwd(*args)
            rec["calls"] += 1
            if rec["calls"] <= first:
                rec["kept"].append(([host(t) for t in args], [host(t) for t in got]))
            return got
        return both
    return wrap


#: the gradients the kernel returns, in order
SCAN_GRADS = ("d(dt)", "dx", "dB", "dC", "dA_log", "dD", "dh0")


def _scan_bwd_fault(name: str):
    """(d)'s planted faults in place of ``selective_scan_bwd``: ``"dA_log =
    0"`` or ``"dC of the step before"``."""
    import torch

    def wrap(kernel_bwd):
        def bwd(*args):
            out = list(kernel_bwd(*args))
            if name == "dA_log = 0":
                out[4] = torch.zeros_like(out[4])
            else:
                out[3] = _dc_of_the_step_before(out[3])
            return tuple(out)
        return bwd
    return wrap


JAMBA_FAULTS = ("dA_log = 0", "dC of the step before")


def _jamba_grad_gate(smi, cfg, tokens) -> dict:
    """(d)'s model gate at step 0 on a model of its own (seed 0, the held
    expert): the kernel run's gradients, the plain scan's and the f64
    control's with the kernel run's expert choices pinned, and each
    planted fault's."""
    import torch

    from repro_torch.kernels import selective_scan as SS
    from repro_torch.models import mamba as MB
    from repro_torch.models import transformer as T

    run, plain = T.RunCfg(), T.RunCfg(plain_scan=True)
    model = T.init_model(cfg, seed=0, device="cuda", experts=JAMBA_TRAIN_EXPERTS)
    (loss_k, got), record = _record(lambda: _rwkv_grads(cfg, run, model, tokens, 1))
    t0 = time.perf_counter()
    (loss_p, want), flips = _replay(lambda: _rwkv_grads(cfg, plain, model, tokens, 1), record)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    kernel = _leaf_gaps(got, want)
    del got
    (loss_c, ctrl), _ = _replay(lambda: _patched(
        MB, "selective_scan_plain", _scan_f64,
        lambda: _rwkv_grads(cfg, plain, model, tokens, 1)), record)
    control = _leaf_gaps(ctrl, want)
    del ctrl
    broken = {}
    for fault in JAMBA_FAULTS:
        (_, bad), _ = _replay(lambda: _patched(
            SS, "selective_scan_bwd", _scan_bwd_fault(fault),
            lambda: _rwkv_grads(cfg, run, model, tokens, 1)), record)
        broken[fault] = _leaf_gaps(bad, want)
        del bad
    del want, model
    torch.cuda.empty_cache()
    kinds: dict = {}
    for name, gap in control.items():
        kind = _leaf_kind(name)
        kinds[kind] = max(kinds.get(kind, 0.0), gap)
    bound = {n: max(JAMBA_GRAD_FLOOR, JAMBA_DRIFT_RATIO * kinds[_leaf_kind(n)])
             for n in control}
    worst = max(kernel, key=lambda n: kernel[n] / bound[n])
    caught = {f: max(b, key=lambda n: b[n] / bound[n]) for f, b in broken.items()}
    out = {"batch": list(tokens.shape), "plain_s": plain_s, "loss": loss_k,
           "loss_plain": loss_p, "loss_f64": loss_c, "pinned_flips": flips,
           "kernel_max": max(kernel.values()), "control_max": max(control.values()),
           "worst_leaf": worst, "worst": [kernel[worst], bound[worst]],
           "passes": all(kernel[n] <= bound[n] for n in kernel),
           "faults": {f: {"leaf": caught[f], "gap": [b[caught[f]], bound[caught[f]]],
                          "refused": any(b[n] > bound[n] for n in b)}
                      for f, b in broken.items()},
           "leaves_over_floor": sum(b > JAMBA_GRAD_FLOOR for b in bound.values()),
           "leaves": len(bound),
           "by_leaf": {n: [kernel[n], control[n], bound[n]] + [b[n] for b in broken.values()]
                       for n in control}}
    say(f"[{smi}] Jamba training (d) step 0's gradients at B={tokens.shape[0]} "
        f"S={tokens.shape[1]} against the plain scan's run ({plain_s:.3f} s; expert "
        f"choices pinned to the kernel run's, its own differing on {flips:.2%}; loss "
        f"{loss_k:.7f} against {loss_p:.7f}, f64 control {loss_c:.7f}): each leaf within "
        f"max({JAMBA_GRAD_FLOOR:g}, {JAMBA_DRIFT_RATIO:g} x the f64 control's gap on its "
        f"kind; {out['leaves_over_floor']} of {out['leaves']} bounds above the floor): the "
        f"kernel's largest gap {out['kernel_max']:.3e}, the control's "
        f"{out['control_max']:.3e}; closest to its bound {worst} {kernel[worst]:.3e} of "
        f"{bound[worst]:.3e}: {'passes' if out['passes'] else 'FAILS'}; " + "; ".join(
            f"{f} at {c['leaf']} {c['gap'][0]:.3e} against {c['gap'][1]:.3e}: "
            f"{'refused' if c['refused'] else 'PASSED'}" for f, c in out["faults"].items()))
    say("  by leaf, the gap of the kernel / the f64 control / the bound / " + " / ".join(
        JAMBA_FAULTS) + ": " + "; ".join(
        f"{n[len('blocks.0.'):] if n.startswith('blocks.0.') else n} "
        + "/".join(f"{x:.2e}" for x in row) for n, row in out["by_leaf"].items()))
    return out


def _checkpoints_a_step_late(ck, dt, x, b, a_log):
    """The checkpoints ``ck`` (B, n, d_inner, d_state) as a forward that
    kept the state one step too late would hold them (the control of
    :func:`_held_scan_calls`): each taken one step of the recurrence on,
    from the kernel's own."""
    import torch

    from repro_torch.kernels import selective_scan as SS

    at = torch.arange(0, dt.shape[1], SS.CKPT_STEPS, device=dt.device)
    dts = dt[:, at, :, None]
    return (torch.exp(dts * -torch.exp(a_log)) * ck
            + dts * x[:, at, :, None].float() * b[:, at, None, :])


#: the forward's outputs :func:`_held_scan_calls` holds, in order
SCAN_FWD_OUTS = ("y", "h", "checkpoints", "the run's checkpoints")


def _held_scan_calls(smi, rec: dict, n_mamba: int) -> dict:
    """(d)'s per-call gate on step 0's ``selective_scan_bwd`` calls kept by
    :func:`_scan_bwd_kept`: each against ``selective_scan_backward_plain``
    on the same inputs, back on the card a call at a time: each output's
    max gap over its max, the controls' (dC of the step before, dA_log = 0,
    made from the kernel's result), the largest |d|.  The forward with
    checkpoints too, on each call's inputs from the state its checkpoints
    begin with, against ``selective_scan_plain(checkpoints=True)``: y, the
    final state and every checkpoint, the kernel's again and those the
    run's forward kept (the call's own), and the control: the run's
    checkpoints a step late.  Fatal if a call parts from its plain version
    or a control passes."""
    import torch

    from repro_torch.kernels import selective_scan as SS

    gaps, fwd = [], []
    while rec["kept"]:
        args, got = ([None if t is None else t.cuda() for t in ts]
                     for ts in rec["kept"].pop(0))
        want = SS.selective_scan_backward_plain(*args)
        gaps.append(torch.stack(
            [_max_gap(g, w) for g, w in zip(got, want)]
            + [_max_gap(_dc_of_the_step_before(got[3]), want[3]),
               _max_gap(torch.zeros_like(want[4]), want[4]),
               max((g - w).abs().max() for g, w in zip(got, want))]).cpu())
        del got, want
        dt, x, b, c, a_log, d, ck = args[:7]
        inputs = (dt, x, b, c, a_log, d, ck[:, 0].contiguous())
        again = SS._kernel(*inputs, checkpoints=True) + (ck,)
        want = SS.selective_scan_plain(*inputs, checkpoints=True)
        want += (want[2],)
        fwd.append(torch.stack(
            [_max_gap(g, w) for g, w in zip(again, want)]
            + [_max_gap(_checkpoints_a_step_late(ck, dt, x, b, a_log), want[2]),
               max((g - w).abs().max() for g, w in zip(again, want))]).cpu())
        del args, again, want, inputs, ck
    torch.cuda.empty_cache()
    rec["gaps"], rec["fwd_gaps"] = gaps, fwd
    g, f = torch.stack(gaps), torch.stack(fwd)
    n, m = len(SCAN_GRADS), len(SCAN_FWD_OUTS)
    calls = {"held": len(rec["gaps"]), "max": dict(zip(SCAN_GRADS, g[:, :n].max(0).values.tolist())),
             "dc_shifted_min": float(g[:, n].min()), "da0_min": float(g[:, n + 1].min()),
             "max_abs": float(g[:, n + 2].max()),
             "dc_shifted_refused": int((g[:, n] > JAMBA_BWD_TOL).sum()),
             "da0_refused": int((g[:, n + 1] > JAMBA_BWD_TOL).sum()),
             "fwd_max": dict(zip(SCAN_FWD_OUTS, f[:, :m].max(0).values.tolist())),
             "late_min": float(f[:, m].min()), "fwd_max_abs": float(f[:, m + 1].max()),
             "late_refused": int((f[:, m] > JAMBA_LAYER_TOL).sum())}
    say(f"[{smi}] Jamba training (d) step 0's selective_scan_bwd: {calls['held']} calls "
        f"against selective_scan_backward_plain on their inputs: max gaps "
        f"{ {k: f'{v:.3e}' for k, v in calls['max'].items()} } of max (tol "
        f"{JAMBA_BWD_TOL:g}; max |d| {calls['max_abs']:.3e}); controls: dC of the step "
        f"before refused in {calls['dc_shifted_refused']}, dA_log = 0 in "
        f"{calls['da0_refused']} of {calls['held']} (smallest gaps "
        f"{calls['dc_shifted_min']:.3e}, {calls['da0_min']:.3e}); the forward with "
        f"checkpoints on their inputs against selective_scan_plain(checkpoints=True): max "
        f"gaps { {k: f'{v:.3e}' for k, v in calls['fwd_max'].items()} } of max (tol "
        f"{JAMBA_LAYER_TOL:g}; max |d| {calls['fwd_max_abs']:.3e}); control, the run's "
        f"checkpoints a step late, refused in {calls['late_refused']} of {calls['held']} "
        f"(smallest gap {calls['late_min']:.3e})")
    bad = []
    if calls["held"] != n_mamba:
        bad.append(f"{calls['held']} calls held, want {n_mamba}")
    if max(calls["max"].values()) > JAMBA_BWD_TOL:
        bad.append(f"a selective_scan_bwd call parts from the plain backward: {calls['max']}")
    if max(calls["fwd_max"].values()) > JAMBA_LAYER_TOL:
        bad.append("a forward with checkpoints parts from the plain version: "
                   f"{calls['fwd_max']}")
    if calls["dc_shifted_refused"] != calls["held"] or calls["da0_refused"] != calls["held"] \
            or calls["late_refused"] != calls["held"]:
        bad.append("the per-call gate passes a control")
    if bad:
        fail("Jamba training (d): " + "; ".join(bad))
    return calls


def _jamba_train_timing(clock_mhz: float) -> list:
    """``selective_scan`` with checkpoints and ``selective_scan_bwd`` at the
    training shape (B=8, S=512, d_inner 16384, d_state 16, bf16 x): each
    kernel (median of 7 CUDA-event timings), its plain version and its
    bound, the larger of its bytes and its arithmetic (as
    :func:`_scan_timing`'s: f32 flops on the FMA pipes, the exps split
    between the SFU and a polynomial there).  No single PyTorch call
    computes either."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.models import transformer as T

    md = T.mamba_dims(get_config(JAMBA_ARCH))
    b, s, di, ds = JAMBA_TRAIN_BATCH, JAMBA_TRAIN_SEQ, md.d_inner, md.d_state
    gen = torch.Generator(device="cuda").manual_seed(180)
    sfu_per_s = SFU_PER_CLOCK * H100_SMS * clock_mhz * 1e6
    dt = torch.nn.functional.softplus(_rand((b, s, di), torch.float32, gen) - 1)
    x = _rand((b, s, di), torch.float32, gen).bfloat16()
    bm, cm = (_rand((b, s, ds), torch.float32, gen) for _ in range(2))
    a_log = _rand((di, ds), torch.float32, gen) * 0.5
    d = _rand((di,), torch.float32, gen)
    h0 = _rand((b, di, ds), torch.float32, gen) * 0.3
    dy = _rand((b, s, di), torch.float32, gen)
    dh = _rand((b, di, ds), torch.float32, gen)
    args = (dt, x, bm, cm, a_log, d, h0)
    _, _, ck = SS._kernel(*args, checkpoints=True)
    cases = (
        ("selective_scan with checkpoints", lambda: SS._kernel(*args, checkpoints=True),
         lambda: SS.selective_scan_plain(*args, checkpoints=True),
         SS.selective_scan_bytes(b, s, di, ds, 2), SS.selective_scan_flops(b, s, di, ds),
         SS.selective_scan_exps(b, s, di, ds)),
        ("selective_scan_bwd", lambda: SS.selective_scan_bwd(*args[:6], ck, dy, dh),
         lambda: SS.selective_scan_backward_plain(*args[:6], ck, dy, dh),
         SS.selective_scan_bwd_bytes(b, s, di, ds, 2), SS.selective_scan_bwd_flops(b, s, di, ds),
         SS.selective_scan_bwd_exps(b, s, di, ds)))
    out = []
    for name, kernel, plain, moved, flops, exps in cases:
        ms, lo, hi = _median_ms(kernel, 10, 2)
        plain_ms = _time_ms(plain, 1, 1)
        terms = {"bytes": moved / HBM_BYTES_PER_S * 1e3, "flops": flops / FP32_FLOPS * 1e3,
                 "exps_sfu": exps / sfu_per_s * 1e3,
                 "exps_poly": exps * 2 * POLY_EXP2_FMA_INSTR / FP32_FLOPS * 1e3}
        terms["arith"] = _arith_ms(terms["flops"], terms["exps_sfu"], terms["exps_poly"])
        decides = "bytes" if terms["bytes"] >= terms["arith"] else "arith"
        rec = {"kernel": name, "shape": [b, s, di, ds], "dtype": "bfloat16", "ms": ms,
               "ms_spread": [lo, hi], "plain_ms": plain_ms, "library_ms": None,
               "bytes": moved, "flops": flops, "exps": exps, "clock_mhz": clock_mhz,
               "terms_ms": terms, "bound_ms": terms[decides],
               "bound_by": "bytes" if decides == "bytes" else "operations"}
        say(f"timing {name} B={b} S={s} d_inner={di} d_state={ds} bf16 x: kernel {ms:.4f} ms "
            f"({lo:.4f}-{hi:.4f}), plain {plain_ms:.3f} ms, library none; bound "
            f"{rec['bound_ms']:.4f} ms ({decides}: {moved} B {terms['bytes']:.4f} ms; "
            f"arithmetic {terms['arith']:.4f} ms: {flops:.4g} flop {terms['flops']:.4f} ms "
            f"beside {exps:.4g} exps, {terms['exps_sfu']:.4f} ms on the SFU alone at "
            f"{clock_mhz:.0f} MHz), {rec['bound_ms'] / ms:.1%} of the bound")
        out.append(rec)
    del args, dt, x, bm, cm, h0, dy, dh, ck
    torch.cuda.empty_cache()
    return out


def jamba_train(smi, clock_mhz: float) -> tuple:
    """Phase 18 (d): jamba-1.5-large-398b trained at full width, one
    superblock, expert 0 of each MoE layer's 16 held, bf16, through
    ``launch/train.py``'s own command in this process; step 0's gates (the
    model's gradients against the plain scan's run, each
    ``selective_scan_bwd`` call against the plain backward), ms/step,
    tokens/s, peak, a profiled step, both kernels timed at the training
    shape.  Returns (results, the launches of ``selective_scan``,
    ``selective_scan_bwd`` and ``flash_attention`` in the launcher's run)."""
    import dataclasses
    import math
    import statistics

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.kernels import attention
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.launch import train
    from repro_torch.models import transformer as T

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(JAMBA_ARCH), n_layers=JAMBA_LAYERS)
    run = T.RunCfg(remat=cfg.remat)
    n_mamba = T.stack_sizes(cfg)["blocks"] * (cfg.hybrid_period - 1)
    n_attn = T.stack_sizes(cfg)["blocks"]
    torch.cuda.empty_cache()
    held_before = torch.cuda.memory_allocated()
    pipe = Pipeline(DataConfig(vocab=cfg.vocab, seq_len=JAMBA_TRAIN_SEQ,
                               global_batch=JAMBA_TRAIN_BATCH))
    tokens = torch.from_numpy(pipe.batch_for_step(0)["tokens"][
        :JAMBA_GATE_BATCH, :JAMBA_GATE_SEQ].copy()).cuda()
    t0 = time.perf_counter()
    gate = _jamba_grad_gate(smi, cfg, tokens)
    gate["s"] = time.perf_counter() - t0
    del tokens
    torch.cuda.empty_cache()

    argv = ["--arch", JAMBA_ARCH, "--layers", str(JAMBA_LAYERS), "--experts",
            f"{JAMBA_TRAIN_EXPERTS[0]}:{JAMBA_TRAIN_EXPERTS[1]}", "--batch",
            str(JAMBA_TRAIN_BATCH), "--seq", str(JAMBA_TRAIN_SEQ), "--steps",
            str(JAMBA_TRAIN_STEPS), "--log-every", "1"]
    rec = {"ms": [], "gnorms": [], "prof": None}
    label = (f"training step {JAMBA_ARCH} 1 superblock, expert 0 of 16 held, "
             f"B={JAMBA_TRAIN_BATCH} S={JAMBA_TRAIN_SEQ}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_scan_counts()
    SS.bwd_launches = SS.plain_bwd_calls = 0
    held = {"calls": 0, "kept": []}
    t0 = time.perf_counter()
    # the launcher's own run (on the card it allocates through expandable
    # segments: 72 GB of state beside a step's activations)
    losses = _patched(train, "make_train_step",
                      _timed_train_steps(rec, label, JAMBA_TRAIN_STEPS),
                      lambda: _patched(SS, "selective_scan_bwd",
                                       _scan_bwd_kept(held, n_mamba),
                                       lambda: train.main(argv)))
    wall = time.perf_counter() - t0
    counts = dict(_scan_counts(), selective_scan_bwd=SS.bwd_launches,
                  selective_scan_plain_bwd=SS.plain_bwd_calls)
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    calls = _held_scan_calls(smi, held, n_mamba)
    ms = statistics.median(rec["ms"][1:-1])
    steps = JAMBA_TRAIN_STEPS
    want = {"selective_scan": steps * T.scan_forwards(cfg, run), "selective_scan_plain": 0,
            "flash_attention": steps * n_attn * T.block_forwards(cfg, run),
            "flash_attention_plain": 0, "selective_scan_bwd": steps * n_mamba,
            "selective_scan_plain_bwd": 0}
    n_params = sum(p.numel() for p in T.init_model(
        cfg, device="meta", experts=JAMBA_TRAIN_EXPERTS).parameters())
    out = {"arch": JAMBA_ARCH, "layers": JAMBA_LAYERS,
           "experts_held": list(JAMBA_TRAIN_EXPERTS), "params": n_params,
           "batch": JAMBA_TRAIN_BATCH, "seq": JAMBA_TRAIN_SEQ, "argv": argv,
           "gate": gate, "calls": calls, "losses": losses, "gnorms": rec["gnorms"],
           "step_ms": rec["ms"], "ms_per_step": ms,
           "tokens_per_s": JAMBA_TRAIN_BATCH * JAMBA_TRAIN_SEQ / (ms / 1e3),
           "peak_bytes": peak, "held_before": held_before,
           "card_bytes": torch.cuda.get_device_properties(0).total_memory,
           "wall_s": wall, "counts": counts, "want": want, "breakdown": rec["prof"]}
    say(f"[{smi}] Jamba training (d) python3 -m repro_torch.launch.train {' '.join(argv)}: "
        f"{n_params} params ({JAMBA_LAYERS} layers, expert {JAMBA_TRAIN_EXPERTS[0]} of "
        f"{cfg.moe.n_experts} held), bf16, remat, {steps} steps in {wall:.3f} s; losses "
        f"{[round(x, 4) for x in losses]}, gnorms {[round(x, 4) for x in rec['gnorms']]}; "
        f"{ms:.3f} ms/step (steps {', '.join(f'{t:.3f}' for t in rec['ms'])}; the first, "
        f"then timed, the last profiled), {out['tokens_per_s']:.1f} tokens/s, peak "
        f"{peak / 2**30:.3f} GiB of {out['card_bytes'] / 2**30:.3f} ({held_before / 2**30:.3f} "
        f"GiB held before); counts {counts} (want {want})")
    for line in rec["prof"]["lines"]:
        say(line)
    out["timing"] = _jamba_train_timing(clock_mhz)
    bad = []
    if len(losses) != steps or not all(math.isfinite(x) for x in losses + rec["gnorms"]):
        bad.append(f"losses {losses}, gnorms {rec['gnorms']}")
    if counts != want:
        bad.append(f"counts {counts}, want {want}")
    if peak > out["card_bytes"]:
        bad.append(f"peak {peak} B over the card's {out['card_bytes']}")
    if not gate["passes"]:
        bad.append(f"gradients: {gate['worst_leaf']} {gate['worst']}")
    for fault, c in gate["faults"].items():
        if not c["refused"]:
            bad.append(f"the gradients' bounds pass the kernel with {fault}")
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"[{smi}] Jamba training: 18 (d) in {out['phase_s']:.3f} s (the model gate "
        f"{gate['s']:.3f} s, the launcher {wall:.3f} s)")
    if bad:
        fail("Jamba training (d): " + "; ".join(bad))
    return out, {k: counts[k] for k in ("selective_scan", "selective_scan_bwd",
                                        "flash_attention")}


REPLACES = {"flash_attention": "src/repro/kernels/attention.py:68",
            "fft_radix2": "src/repro/kernels/fft_radix2.py:90",
            "fft_mxu": "src/repro/kernels/fft_mxu.py:80",
            "ring_payload": "src/repro/kernels/ring_rdma.py:153",
            "ring_send": "src/repro/kernels/ring_rdma.py:88",
            "ring_land": "src/repro/kernels/ring_rdma.py:101",
            # no Pallas kernel: the reference's lax.scan of the recurrence
            # and, for the backward, jax.grad of it
            "wkv6": "src/repro/models/rwkv.py:90",
            "wkv6_bwd": "src/repro/models/rwkv.py:90",
            # the reference's lax.scan of Mamba's step (mamba.py:102) and,
            # for the backward, jax.grad of it
            "selective_scan": "src/repro/models/mamba.py:102",
            "selective_scan_bwd": "src/repro/models/mamba.py:102"}


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
        rwkv, rwkv_kept, _ = rwkv_lm(smi)
        jamba_lm(smi)
        trained, _ = training(smi)
        sharded, _ = sharded_lm(smi, trained, lm_kept, rwkv_kept)
        rwkv_mesh(smi, rwkv, rwkv_kept, sharded.pop("rwkv_ranks"))
        mla, mla_kept, _ = mla_lm(smi)
        moe, _ = moe_lm(smi, mla_kept)
        mla_mesh(smi, mla, mla_kept, moe.pop("mla_ranks"))
        return 0
    if argv == [MOE_ONLY]:
        moe_lm(smi)
        return 0
    if argv == [JAMBA_ONLY]:
        build()
        jamba_lm(smi)
        return 0
    if argv == [RWKV_ONLY]:
        from repro_torch import dist

        from repro_torch.kernels import _build

        _build.build_all(["wkv6"])
        wkv_ptxas(_build.build_log("wkv6"))
        rwkv, rwkv_kept, _ = rwkv_lm(smi)
        t0 = time.perf_counter()
        ranks = dist.run_ranks(_rwkv_ranks, 2, 2, device="cuda",
                               args=_rwkv_rank_args(rwkv_kept), timeout=900)
        say(f"RWKV (c): its own spawn in {time.perf_counter() - t0:.3f} s")
        rwkv_mesh(smi, rwkv, rwkv_kept, ranks)
        return 0
    if argv == [MLA_ONLY]:
        from repro_torch import dist

        mla, mla_kept, _ = mla_lm(smi)
        t0 = time.perf_counter()
        ranks = dist.run_ranks(_mla_ranks, 2, 2, device="cuda",
                               args=_mla_rank_args(mla_kept),
                               timeout=900)
        say(f"MLA (c): its own spawn in {time.perf_counter() - t0:.3f} s")
        mla_mesh(smi, mla, mla_kept, ranks)
        return 0
    phase_s = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            phase_s[label] = round(time.perf_counter() - t0, 3)

    _warm_profiler()  # beside the build and the checks, before the first timing
    flash_sass_counts, ptxas_build = timed("2 build", build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t_checks = time.perf_counter()
    max_abs = kernel_vs_plain(gen)
    max_abs.update(ring_vs_plain(gen))
    max_abs["flash_attention"], flash_rel, flash_gaps = flash_vs_plain(gen)
    phase_s["3 kernel vs plain"] = round(time.perf_counter() - t_checks, 3)
    phase_s["3 the profiler's warm-up, waited for"] = round(_warmed(), 3)
    t_timing = time.perf_counter()
    mma_rates = mma_probe()
    times = timing(gen)
    ring_times = ring_timing(gen)
    flash_times = flash_timing(gen)
    flash_time = flash_times[0]
    phase_s["4 timing"] = round(time.perf_counter() - t_timing, 3)
    os.makedirs(REF_DIR, exist_ok=True)
    runs, launches = timed("5 main path", main_path)
    observed = timed("5 observability", observability, runs)
    prof = timed("6 breakdown", lambda: [breakdown(BACKEND[k]) for k in KERNELS])
    tune_backends = timed("9 calibration (a)", calibrate_backends)
    ranks, ring_launches = timed("7 multi-rank", multi_rank, runs, tune_backends)
    staged_ranks, staged_launches = timed("7 2x2x2", staged_mesh)
    launches.update({k: n + staged_launches[k] for k, n in ring_launches.items()})
    lm, lm_kept = timed("8 LM serving", lm_serving, flash_rel)
    launches["flash_attention"] = lm["counts"]["flash_attention"] + \
        lm["int8"]["counts"]["flash_attention"]
    rwkv, rwkv_kept, rwkv_launches = timed("16 RWKV (a), (b) with 17 (a)", rwkv_lm, smi)
    launches.update(rwkv_launches)
    jamba, jamba_launches = timed("18 Jamba", jamba_lm, smi)
    launches["flash_attention"] += jamba_launches["flash_attention"]
    launches["selective_scan"] = jamba_launches["selective_scan"]
    launches["selective_scan_bwd"] = jamba_launches["selective_scan_bwd"]
    tuned = timed("9 tuning", tuning, runs, ranks, tune_backends)
    served, serve_launches = timed("10 serving", serving, smi)
    for k, n in serve_launches.items():
        launches[k] += n
    fleeted, fleet_launches = timed("11 fleet", fleet, smi)
    for k, n in fleet_launches.items():
        launches[k] += n
    trained, launches_trained = timed("12 training", training, smi)
    launches["flash_attention"] += launches_trained
    sharded, sharded_launches = timed("13 sharded LM with 16 (c), 10 (c)", sharded_lm, smi,
                                      trained, lm_kept, rwkv_kept, True)
    for k, n in sharded_launches.items():
        launches[k] += n
    served["2x2"], serve_grid_launches = timed("10 (c) gates", serve_grid_gates, smi,
                                               sharded.pop("serve_ranks"))
    for k, n in serve_grid_launches.items():
        launches[k] += n
    rwkv_mesh_launches = timed("16 (c) gates", rwkv_mesh, smi, rwkv, rwkv_kept,
                               sharded.pop("rwkv_ranks"))
    for k, n in rwkv_mesh_launches.items():
        launches[k] += n
    mla, mla_kept, mla_launches = timed("15 MLA (a), (b)", mla_lm, smi)
    launches["flash_attention"] += mla_launches
    moe, moe_launches = timed("14 MoE with 15 (c)", moe_lm, smi, mla_kept)
    for k, n in moe_launches.items():
        launches[k] += n
    mla_mesh_launches = timed("15 (c) gates", mla_mesh, smi, mla, mla_kept,
                              moe.pop("mla_ranks"))
    for k, n in mla_mesh_launches.items():
        launches[k] += n
    say(f"[{smi}] seconds by phase: {phase_s}")

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
    t = rwkv["timing"][0]  # the prefill shape
    kernels.append({
        "name": "wkv6", "route": "cuda", "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": REPLACES["wkv6"], "launches": launches["wkv6"],
        "max_abs_err": rwkv["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None})
    # a microbatch of the training step (B=4, S=512)
    t = next(t for t in rwkv["train"]["timing"] if t["kernel"] == "wkv6_bwd")
    kernels.append({
        "name": "wkv6_bwd", "route": "cuda", "source": "src/repro_torch/csrc/wkv6.cu",
        "replaces": REPLACES["wkv6_bwd"], "launches": launches["wkv6_bwd"],
        "max_abs_err": rwkv["train"]["calls"]["max_abs"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None})
    t = jamba["timing"][0]  # the prefill shape
    kernels.append({
        "name": "selective_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan.cu",
        "replaces": REPLACES["selective_scan"], "launches": launches["selective_scan"],
        # (b)'s calls and, with checkpoints, (d)'s
        "max_abs_err": max(jamba["max_abs_err"], jamba["train"]["calls"]["fwd_max_abs"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None})
    # the training shape (B=8, S=512)
    t = next(t for t in jamba["train"]["timing"] if t["kernel"] == "selective_scan_bwd")
    kernels.append({
        "name": "selective_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/selective_scan.cu",
        "replaces": REPLACES["selective_scan_bwd"],
        "launches": launches["selective_scan_bwd"],
        "max_abs_err": jamba["train"]["calls"]["max_abs"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None})
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
                   "training": trained, "sharded_lm": sharded, "moe": moe,
                   "mla": mla, "rwkv": rwkv, "jamba": jamba, "phase_s": phase_s},
                  f, indent=1)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [FLEET_WORKER]:
        sys.exit(fleet_worker(sys.argv[2:]))
    sys.exit(main(sys.argv[1:]))
