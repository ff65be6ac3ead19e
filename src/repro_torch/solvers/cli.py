"""Command line of the port's solvers: run a registered case on one device.

    PYTHONPATH=src python -m repro_torch.solvers.cli --case heat --n 512 \\
        --mesh 1x1 --backend pallas
    PYTHONPATH=src python -m repro_torch.solvers.cli --case heat --n 512 \\
        --mesh 1x1 --backend mxu
    PYTHONPATH=src python -m repro_torch.solvers.cli --case poisson --n 16 \\
        --device cpu

Takes the flags of ``repro.solvers.cli`` plus ``--device`` (default
``cuda``) and ``--backend`` (the plan's 1D FFT engine: ``pallas`` is the
radix-2 CUDA kernel, ``mxu`` the four-step CUDA kernel on the FP64 tensor
cores, ``ref`` the radix-2 plain version, ``jnp`` ``torch.fft``).
Runs ``--steps`` cycles printing the observables, then the case's analytic
validation (non-zero exit on failure).  Only the ``1x1`` mesh runs in this
port so far; any other mesh, ``--autotune`` and ``--trace`` exit 1 naming
the ROADMAP item that brings them.
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
                    help="not ported yet (ROADMAP Queue 1 item 8)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress the per-step observable lines")
    ap.add_argument("--trace", dest="trace_path", default="",
                    help="not ported yet (ROADMAP Queue 1 item 6)")
    return ap


def _fail(msg: str) -> int:
    print(msg, file=sys.stderr)
    return 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.autotune:
        return _fail("--autotune: solver-step autotuning is not ported yet "
                     "(ROADMAP Queue 1 item 8)")
    if args.trace_path:
        return _fail("--trace: tracing is not ported yet "
                     "(ROADMAP Queue 1 item 6)")
    try:
        pu, pv = (int(p) for p in args.mesh.lower().split("x"))
    except ValueError:
        return _fail(f"--mesh must look like PUxPV, got {args.mesh!r}")
    if (pu, pv) != (1, 1):
        return _fail(f"mesh {args.mesh}: the port runs the 1x1 grid only; "
                     "multi-rank grids need the torch.distributed comm "
                     "engines (ROADMAP Queue 1 item 5)")

    import torch

    from repro_torch.core.decomposition import PencilGrid
    from repro_torch.solvers import SOLVERS, make_solver

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
        solver = make_solver(args.case, PencilGrid.from_mesh(pu, pv), args.n,
                             device=args.device, dtype=args.dtype,
                             plan_cfg=plan_cfg or None, **phys)
    except (ValueError, RuntimeError, NotImplementedError) as e:
        return _fail(f"invalid problem: {e}")
    dev = solver.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"case={args.case} N={args.n}^3 mesh={pu}x{pv} "
          f"dtype={solver.dtype.name} dt={solver.dt:g} "
          f"plan={solver.plan.backend}/{solver.plan.schedule}"
          f"/{solver.plan.comm_engine} [{dev}: {where}]", flush=True)

    def show(state, obs):
        if args.quiet:
            return
        vals = "  ".join(f"{k} = {v:.6e}" for k, v in sorted(obs.items())
                         if k != "t")
        print(f"step {state.n_steps:3d}  t = {obs['t']:.4f}  {vals}",
              flush=True)

    t0 = time.perf_counter()
    _, history = solver.run(args.steps, callback=show)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    ok, lines = solver.validate(history)
    for line in lines:
        print(line)
    print(f"{args.case}: {'OK' if ok else 'FAILED'}   "
          f"{wall / max(args.steps, 1) * 1e3:.1f} ms/step "
          f"(incl. the kernel build and the observables)")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
