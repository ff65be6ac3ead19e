"""``repro_torch.solvers`` — FFT-based simulation workloads, port of
``repro.solvers``.

Registered cases: ``poisson`` (manufactured-solution Poisson), ``heat``
(exact exponential propagator), ``navier_stokes`` (Taylor–Green, IFRK4 +
Leray projection) and ``nls`` (split-step Gross–Pitaevskii, c2c).
``python -m repro_torch.solvers.cli --case <name>`` runs one on a device.
"""

from __future__ import annotations

from repro_torch.solvers.base import (SolverState, SpectralSolver,
                                      state_from_numpy, state_to_numpy)
from repro_torch.solvers.heat import HeatSolver
from repro_torch.solvers.navier_stokes import NavierStokesSolver
from repro_torch.solvers.nls import NLSSolver
from repro_torch.solvers.poisson import PoissonSolver

SOLVERS: dict[str, type[SpectralSolver]] = {
    cls.case: cls
    for cls in (PoissonSolver, HeatSolver, NavierStokesSolver, NLSSolver)
}


def make_solver(case: str, grid, n, *, device="cuda", **kwargs) -> SpectralSolver:
    """Instantiate a registered solver case on ``device`` (``kwargs`` → its
    constructor)."""
    try:
        cls = SOLVERS[case]
    except KeyError:
        raise ValueError(f"unknown solver case {case!r}; "
                         f"have {sorted(SOLVERS)}") from None
    return cls(grid, n, device=device, **kwargs)


__all__ = ["SOLVERS", "SolverState", "SpectralSolver", "HeatSolver",
           "NavierStokesSolver", "NLSSolver", "PoissonSolver", "make_solver",
           "state_from_numpy", "state_to_numpy"]
