"""Solver-step autotuning: pick the FFT plan by timing the *whole* step —
port of ``repro.tuning.solver``.

The bare-transform objective (``tuning.autotune``) weights forward and
inverse times, but a real workload's step also contains the spectral and
local stages and runs a case-specific mix of transforms (Navier–Stokes:
three vector transforms per RK substage; Poisson: one round trip).
``autotune_solver_step`` therefore scores each candidate plan by building
the actual :class:`repro_torch.solvers.SpectralSolver` on it and timing its
step.

Winners persist in the same plan cache, fingerprinted with the solver
``case`` and its physics params, so a step-tuned plan is never confused
with a bare-transform one (or another case's).  On a grid of more than one
rank it runs in every rank process, under the rules of
:mod:`repro_torch.tuning.autotune`.
"""

from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.core import perfmodel as pm
from repro_torch.core import precision
from repro_torch.tuning.autotune import TuneResult, _estimate, _lookup, sweep
from repro_torch.tuning.cache import PlanCache, problem_fingerprint
from repro_torch.tuning.space import DEFAULT_CANDIDATE, Candidate, candidate_space
from repro_torch.tuning.timing import time_us


def _has_diagonal_kernel(cls) -> bool:
    """Whether the solver class declares a pointwise-diagonal spectral
    kernel (overrides ``SpectralSolver.spectral_kernel``) — the gate for
    sweeping the fused-roundtrip executor on its step."""
    from repro_torch.solvers.base import SpectralSolver

    return cls.spectral_kernel is not SpectralSolver.spectral_kernel


def _build_solver(grid, case, n, cand: Candidate, *, dtype, params, device):
    from repro_torch.solvers import make_solver

    solver = make_solver(case, grid, n, dtype=dtype, device=device,
                         plan_cfg=cand.config(), **(params or {}))
    return solver, solver.init_state()


def _time_step(built, iters: int) -> float:
    solver, state = built
    return time_us(lambda fields: solver.step_fields(solver.plan, fields),
                   state.fields, iters=iters)


def time_solver_step(grid, case: str, n, cand: Candidate, *,
                     dtype="float64", params: dict | None = None,
                     iters: int = 3, device="cuda") -> float:
    """Measured µs per solver step for one candidate plan on this rank (the
    first step, which builds the kernels, excluded).

    Builds the solver on the candidate's plan config, initializes state
    once, and times its step on the fields.
    """
    return _time_step(_build_solver(grid, case, n, cand, dtype=dtype,
                                    params=params, device=device), iters)


def autotune_solver_step(grid, case: str, n, *, dtype="float64",
                         params: dict | None = None,
                         cache_path: str | None = None,
                         max_candidates: int = 6, iters: int = 3,
                         force: bool = False, device="cuda",
                         verbose: bool = False) -> TuneResult:
    """Pick the fastest ``FFT3DPlan`` for one solver case's full step.

    Same discipline as the bare-transform sweep: enumerate the valid plan
    space for the case's transform shape (real/complex, μ components),
    rank analytically, time the top ``max_candidates`` plus the hardcoded
    default, persist the winner keyed by a fingerprint that includes the
    case and its physics params. ``iters`` < 1, unknown cases and a dtype
    that is not a real floating type fail fast.  Solvers decompose over
    the grid's own mesh axes.
    """
    from repro_torch.solvers import SOLVERS

    if case not in SOLVERS:
        raise ValueError(f"unknown solver case {case!r}; "
                         f"have {sorted(SOLVERS)}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    cls = SOLVERS[case]
    grid = dist.bind_grid(grid, "autotune_solver_step")
    dev = torch.device(device)
    n = (n, n, n) if isinstance(n, int) else tuple(n)
    grid.validate(n)
    params = dict(params or {})
    dtype = precision.require_dtype(dtype, who="autotune_solver_step").name
    key, problem = problem_fingerprint(
        n, grid.pu, grid.pv, real=cls.real, components=cls.components,
        dtype=dtype, u_axes=grid.u_axes, v_axes=grid.v_axes, case=case,
        solver_params=params, device=dev)
    cache = PlanCache(cache_path)
    hit = _lookup(grid, cache, key, force)
    if hit is not None:
        return hit

    diagonal = _has_diagonal_kernel(cls)
    cands = candidate_space(n, grid.pu, grid.pv, real=cls.real,
                            components=cls.components, fused=diagonal,
                            pu_axes=grid.u_sizes, pv_axes=grid.v_sizes)
    # the analytic transform model ranks candidates; the per-step transform
    # count is plan-independent, so the constant factor cancels in the order.
    # Diagonal-kernel cases rank on the roundtrip estimate instead, which
    # prices the fused executor's hidden kernel sweep (fused ≤ composed).
    if diagonal:
        cands.sort(key=lambda c: pm.estimate_roundtrip_seconds(
            n, grid.pu, grid.pv, spec=c.spec(real=cls.real),
            mu=max(cls.components, 1),
            pu_axes=grid.u_sizes, pv_axes=grid.v_sizes))
    else:
        cands.sort(key=lambda c: _estimate(c, n, grid, cls.components))
    keep = cands[:max(max_candidates, 1)]
    if DEFAULT_CANDIDATE not in keep:
        keep.append(DEFAULT_CANDIDATE)

    def build(cand):
        return _build_solver(grid, case, n, cand, dtype=dtype, params=params,
                             device=dev)

    return sweep(grid, keep, build, lambda built: {"us": _time_step(built, iters)},
                 key=key, cache=cache, problem=problem, label=f"{case}/",
                 verbose=verbose)
