"""Command line of the port's batched spectral-simulation server.

    PYTHONPATH=src python -m repro_torch.serving.cli --case heat --n 16 \\
        --mesh 2x2 --requests 4 --max-batch 2 --validate --device cpu
    PYTHONPATH=src python -m repro_torch.serving.cli --case heat --n 512 \\
        --mesh 1x1 --dtype float64 --requests 8 --max-batch 4

Port of ``repro.serving.cli``, with the same flags plus ``--device``
(default ``cuda``; raises without a card).  Starts a
:class:`~repro_torch.serving.server.SimServer` on the ``Pu×Pv`` grid and
drives it with a load-generator schedule of ``--requests`` same-shape
requests (initial amplitudes spread per request so the lanes are distinct
trajectories).  Prints the per-request latency table and the
throughput/latency-tail summary; ``--validate`` replays each streamed
history through the case's analytic ``validate`` (non-zero exit on
failure).  ``--trace`` writes a Perfetto-loadable Chrome trace of the run:
``serve/admit`` admission spans, ``dispatch/serving.batch_step`` batch
steps, and the ``serving.*`` queue/batch counters and gauges.

A mesh of more than one rank spawns the rank processes
(:func:`repro_torch.dist.run_ranks`, as the solver CLI does): rank 0 runs
the server's scheduler and the load generator, prints and writes the
trace; the other ranks step each batch beside it
(:meth:`SimServer.follow`).

``python -m repro_torch.launch.serve --sim ...`` forwards here.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.serving.cli",
        description="Serve batched spectral-simulation requests on one grid.")
    ap.add_argument("--case", default="heat",
                    help="solver case (poisson | heat | navier_stokes | nls)")
    ap.add_argument("--n", type=int, default=16, help="cubic grid extent N")
    ap.add_argument("--steps", type=int, default=3,
                    help="time steps per request")
    ap.add_argument("--mesh", default="4x2", help="Pu x Pv pencil grid")
    ap.add_argument("--dtype", default="float32", help="state dtype")
    ap.add_argument("--requests", type=int, default=8,
                    help="load-generator request count")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="max same-fingerprint requests per batched step")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="queue depth bound (backpressure; default unbounded)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="arrival rate in requests/s (0 = burst all at once)")
    ap.add_argument("--comm-engine", default="",
                    help="pin the TransposeEngine for the fold "
                         "communications (switched | torus | overlap_ring | "
                         "pallas_ring | bidi_ring)")
    ap.add_argument("--validate", action="store_true",
                    help="replay each streamed history through the case's "
                         "analytic validate()")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-request latency lines")
    ap.add_argument("--trace", dest="trace_path", default="",
                    help="write a Chrome-trace JSON (Perfetto-loadable) of "
                         "the run: admission spans, batched steps, and the "
                         "serving.* queue/batch metrics (rank 0's)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    return ap


def _fail(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def _serve(args, grid, rank: int = 0) -> int:
    """Run the server on this rank: rank 0 schedules, prints and validates;
    the other ranks follow its batches."""
    import torch

    from repro_torch import obs
    from repro_torch.serving import SimRequest, SimServer, request_key, run_load

    if args.trace_path:
        obs.clear()
        obs.enable()
    server = SimServer(grid, device=args.device, max_batch=args.max_batch,
                       max_pending=args.max_pending)
    if rank != 0:
        server.follow()
        return 0

    plan_cfg = {"comm_engine": args.comm_engine} if args.comm_engine else None
    # distinct initial amplitudes: every lane is its own trajectory, but
    # all share one fingerprint so the scheduler batches them
    reqs = [SimRequest(case=args.case, n=args.n, steps=args.steps,
                       dtype=args.dtype, plan_cfg=plan_cfg,
                       scale=1.0 + 0.25 * i, request_id=f"req-{i}")
            for i in range(args.requests)]
    dev = server.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"serve: case={args.case} N={args.n}^3 mesh={grid.pu}x{grid.pv} "
          f"dtype={args.dtype} requests={args.requests} "
          f"steps={args.steps} max_batch={args.max_batch} "
          f"rate={'burst' if args.rate <= 0 else f'{args.rate:g}/s'} "
          f"fingerprint={request_key(reqs[0])} [{dev}: {where}]", flush=True)

    t0 = time.time()
    try:
        report = run_load(server, reqs, rate_hz=args.rate)
    finally:
        server.close()
    wall = time.time() - t0

    failed = [r for r in report.results if not r.ok]
    for r in report.results:
        if args.quiet:
            continue
        tail = (f"FAILED: {r.error}" if not r.ok else
                f"{len(r.history) - 1} steps  "
                f"final t={r.history[-1]['t']:.4f}")
        print(f"  {r.request.request_id:8s} batch={r.batch_size}  "
              f"latency={r.latency_s * 1e3:8.2f} ms  {tail}", flush=True)
    s = report.stats()
    print(f"served {s['n_requests']} requests in {wall:.2f} s  "
          f"({s['requests_per_s']:.2f} req/s incl. the kernel build)  "
          f"latency p50={s['p50_us'] / 1e3:.1f} ms "
          f"p95={s['p95_us'] / 1e3:.1f} ms p99={s['p99_us'] / 1e3:.1f} ms",
          flush=True)

    ok = not failed
    if args.validate and ok:
        for r in report.results:
            solver = server.registry.get(r.request)
            v_ok, lines = solver.validate(r.history)
            if not v_ok or not args.quiet:
                for line in lines:
                    print(f"  {r.request.request_id}: {line}")
            ok = ok and v_ok
        print(f"validate: {'OK' if ok else 'FAILED'} "
              f"({len(report.results)} streamed histories)")
    elif failed:
        print(f"serve: {len(failed)} request(s) FAILED "
              f"({failed[0].error})")

    if args.trace_path:
        obs.disable()
        obs.write_chrome_trace(args.trace_path, obs.tracer, obs.metrics,
                               meta={"mesh": f"{grid.pu}x{grid.pv}",
                                     "device": where})
        print(f"wrote trace {args.trace_path} "
              f"({len(obs.tracer.events())} spans)")
    return 0 if ok else 1


def _rank_main(ctx, args) -> int:
    return _serve(args, ctx.grid(), rank=ctx.rank)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        pu, pv = (int(p) for p in args.mesh.lower().split("x"))
    except ValueError:
        return _fail(f"--mesh must look like PUxPV, got {args.mesh!r}")

    from repro_torch import dist
    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.device import resolve_device
    from repro_torch.solvers import SOLVERS

    if args.case not in SOLVERS:
        return _fail(f"unknown case {args.case!r}; have {sorted(SOLVERS)}")
    if args.requests < 1:
        return _fail(f"--requests must be >= 1, got {args.requests}")
    resolve_device(args.device)  # raises here, before any rank starts
    try:
        grid = PencilGrid.from_mesh(pu, pv)
        grid.validate((args.n,) * 3)
    except ValueError as e:
        return _fail(f"invalid problem for mesh {args.mesh}: {e}")
    if grid.p == 1:
        return _serve(args, grid)
    try:
        rcs = dist.run_ranks(_rank_main, pu, pv, device=args.device,
                             args=(args,))
    except RuntimeError as e:
        return _fail(f"mesh {args.mesh}: {e}")
    return max(rcs)


if __name__ == "__main__":
    raise SystemExit(main())
