"""Command line of the port's solvers: run a registered case on a grid.

    PYTHONPATH=src python -m repro_torch.solvers.cli --case heat --n 512 \\
        --mesh 1x1 --backend pallas
    PYTHONPATH=src python -m repro_torch.solvers.cli --case heat --n 512 \\
        --mesh 1x1 --backend mxu
    PYTHONPATH=src python -m repro_torch.solvers.cli --case nls --n 512 \\
        --mesh 1x4 --backend pallas --comm-engine pallas_ring
    PYTHONPATH=src python -m repro_torch.solvers.cli --case heat --n 16 \\
        --mesh 2x2 --comm-engine pallas_ring --device cpu
    PYTHONPATH=src python -m repro_torch.solvers.cli --case heat --n 16 \\
        --steps 2 --mesh 2x2 --device cpu --trace trace.json

Takes the flags of ``repro.solvers.cli`` plus ``--device`` (default
``cuda``) and ``--backend`` (the plan's 1D FFT engine: ``pallas`` is the
radix-2 CUDA kernel, ``mxu`` the four-step CUDA kernel on the FP64 tensor
cores, ``ref`` the radix-2 plain version, ``jnp`` ``torch.fft``).
Runs ``--steps`` cycles printing the observables, then the case's analytic
validation (non-zero exit on failure).  ``--mesh PUxPV`` with more than
one rank spawns the ranks (:func:`repro_torch.dist.run_ranks`, one process
each; on the card they share it when there are fewer cards than ranks)
and rank 0 prints.  ``--trace PATH`` records the run through
``repro_torch.obs`` (``dispatch/solver.step`` spans, the fold phases' spans
and the wire counters) and rank 0 writes its Chrome trace and prints the
summary table: one rank's view, as the reference's per-shard counters
are.  The mesh is ``PUxPV``, as in the reference's CLI; 3-axis meshes
come in through ``make_fft3d`` and ``run_ranks``.  ``--autotune`` first
tunes the FFT plan against the case's whole step on the grid
(:func:`repro_torch.tuning.autotune_solver_step`, on every rank; the plan
cache at ``$REPRO_TORCH_PLAN_CACHE`` or ``~/.cache/repro_torch/``), then
runs the steps on the winner's plan; ``--comm-engine`` and ``--backend``
override the winner's.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.solvers.cli",
        description="Run a spectral-solver case on the PyTorch/CUDA port.")
    ap.add_argument("--case", required=True,
                    help="solver case (poisson | heat | navier_stokes | nls)")
    ap.add_argument("--n", type=int, default=32, help="cubic grid extent N")
    ap.add_argument("--steps", type=int, default=4, help="time steps to run")
    ap.add_argument("--mesh", default="1x1", help="Pu x Pv pencil grid")
    ap.add_argument("--dt", type=float, default=None,
                    help="time step (default: the case's own)")
    ap.add_argument("--dtype", default="float64", help="state dtype")
    ap.add_argument("--nu", type=float, default=None,
                    help="viscosity (navier_stokes only)")
    ap.add_argument("--comm-engine", default="",
                    help="TransposeEngine for the folds (switched | torus | "
                         "overlap_ring | pallas_ring | bidi_ring)")
    ap.add_argument("--backend", default="",
                    help="1D FFT engine: pallas (the radix-2 CUDA kernel) | "
                         "mxu (the four-step CUDA kernel) | ref | jnp "
                         "(default: the solver's plan default)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    ap.add_argument("--autotune", action="store_true",
                    help="tune the FFT plan against the whole step first "
                         "(cache key solver_<case>_...)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-step observable lines")
    ap.add_argument("--trace", dest="trace_path", default="",
                    help="write a Chrome-trace JSON (Perfetto-loadable) of "
                         "the run: dispatch/solver.step spans, the fold "
                         "phases' spans and the wire counters (rank 0's)")
    return ap


def _fail(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def _run(args, grid, plan_cfg, phys, rank: int = 0) -> int:
    """Build the solver on this rank, run it, validate; rank 0 prints."""
    import torch

    from repro_torch import obs
    from repro_torch.solvers import make_solver

    if args.trace_path:
        obs.clear()
        obs.enable()

    def say(line=""):
        if rank == 0:
            print(line, flush=True)

    if args.autotune:
        from repro_torch.tuning.solver import autotune_solver_step
        try:
            res = autotune_solver_step(grid, args.case, args.n,
                                       dtype=args.dtype, params=phys,
                                       device=args.device,
                                       verbose=not args.quiet)
        except ValueError as e:
            if rank == 0:
                print(f"invalid problem: {e}", file=sys.stderr)
            return 1
        hit = "cache hit" if res.cache_hit else "measured"
        say(f"autotuned solver step ({hit}): {res.best.name}  "
            f"{res.best_us:.1f} us/step")
        # an explicit engine or backend overrides the winner's
        plan_cfg = {**res.best_config, **plan_cfg}
    try:
        solver = make_solver(args.case, grid, args.n, device=args.device,
                             dtype=args.dtype, plan_cfg=plan_cfg or None,
                             **phys)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        if rank == 0:
            print(f"invalid problem: {e}", file=sys.stderr)
        return 1
    dev = solver.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"case={args.case} N={args.n}^3 mesh={grid.pu}x{grid.pv} "
        f"dtype={solver.dtype.name} dt={solver.dt:g} "
        f"plan={solver.plan.backend}/{solver.plan.schedule}"
        f"/{solver.plan.comm_engine} [{dev}: {where}]")

    def show(state, obs):
        if args.quiet:
            return
        vals = "  ".join(f"{k} = {v:.6e}" for k, v in sorted(obs.items())
                         if k != "t")
        say(f"step {state.n_steps:3d}  t = {obs['t']:.4f}  {vals}")

    t0 = time.perf_counter()
    _, history = solver.run(args.steps, callback=show)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    ok, lines = solver.validate(history)
    for line in lines:
        say(line)
    say(f"{args.case}: {'OK' if ok else 'FAILED'}   "
        f"{wall / max(args.steps, 1) * 1e3:.1f} ms/step "
        f"(incl. the kernel build and the observables)")
    if args.trace_path:
        obs.disable()
        if rank == 0:
            obs.write_chrome_trace(args.trace_path, obs.tracer, obs.metrics,
                                   meta={"mesh": f"{grid.pu}x{grid.pv}",
                                         "device": where})
            say(f"wrote trace {args.trace_path} ({len(obs.tracer.events())} spans)")
            if not args.quiet:
                say(obs.summary_table(obs.tracer, obs.metrics))
    return 0 if ok else 1


def _rank_main(ctx, args, plan_cfg, phys) -> int:
    return _run(args, ctx.grid(), plan_cfg, phys, rank=ctx.rank)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        pu, pv = (int(p) for p in args.mesh.lower().split("x"))
    except ValueError:
        return _fail(f"--mesh must look like PUxPV, got {args.mesh!r}")

    from repro_torch import dist
    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import SOLVERS

    if args.case not in SOLVERS:
        return _fail(f"unknown case {args.case!r}; have {sorted(SOLVERS)}")
    phys: dict = {}
    if args.dt is not None:
        phys["dt"] = args.dt
    if args.nu is not None:
        if args.case != "navier_stokes":
            return _fail("--nu only applies to --case navier_stokes")
        phys["nu"] = args.nu
    plan_cfg = {}
    if args.comm_engine:
        plan_cfg["comm_engine"] = args.comm_engine
    if args.backend:
        plan_cfg["backend"] = args.backend

    try:
        grid = PencilGrid.from_mesh(pu, pv)
        grid.validate((args.n,) * 3)
    except ValueError as e:
        return _fail(f"invalid problem for mesh {args.mesh}: {e}")
    if grid.p == 1:
        return _run(args, grid, plan_cfg, phys)
    try:
        rcs = dist.run_ranks(_rank_main, pu, pv, device=args.device,
                             args=(args, plan_cfg, phys))
    except RuntimeError as e:
        return _fail(f"mesh {args.mesh}: {e}")
    return max(rcs)


if __name__ == "__main__":
    raise SystemExit(main())
