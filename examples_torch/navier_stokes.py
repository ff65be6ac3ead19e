"""Pseudo-spectral incompressible Navier–Stokes on the port — the paper's
case study (§1.2).  A thin wrapper over ``repro_torch.solvers.cli``: every
time step is the forward 3D FFT → spectral computation → inverse 3D FFT
cycle on the pencil grid of rank processes.

    PYTHONPATH=src python examples_torch/navier_stokes.py [--n 32] [--steps 10]
    PYTHONPATH=src python examples_torch/navier_stokes.py --device cpu --n 16

Taylor–Green vortex on a 2pi^3 box; prints the kinetic energy's decay
(viscous dissipation => monotone) and checks that the field stays
divergence-free.  Equivalent to::

    python -m repro_torch.solvers.cli --case navier_stokes --mesh 2x2 ...
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--nu", type=float, default=0.1)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--autotune", action="store_true",
                    help="pick the FFT plan by autotuning the whole "
                         "Navier–Stokes step (see repro_torch.tuning.solver)")
    args = ap.parse_args(argv)

    from repro_torch.solvers.cli import main as solver_main
    forwarded = ["--case", "navier_stokes", "--mesh", args.mesh,
                 "--n", str(args.n), "--steps", str(args.steps),
                 "--nu", str(args.nu), "--dt", str(args.dt), "--device", args.device]
    if args.autotune:
        forwarded.append("--autotune")
    return solver_main(forwarded)


if __name__ == "__main__":
    raise SystemExit(main())
