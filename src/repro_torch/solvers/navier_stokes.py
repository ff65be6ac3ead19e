"""Incompressible Navier–Stokes — the paper's §1.2 case study as a solver.

Port of ``repro.solvers.navier_stokes``.  Pseudo-spectral rotational form on
the 2π³ torus,

    ∂v̂/∂t = P( \\widehat{u × ω} ) − ν k² v̂,    ∇·v = 0,

with the state in spectral space (planar ``(vr, vi)``, 3 components), the
nonlinear stage :func:`~repro_torch.core.spectral.rotational_nonlinear_term`,
integrating-factor RK4 and a Leray projection after each step.  The
Taylor–Green vortex must decay monotonically and stay divergence-free.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import spectral as sp
from repro_torch.core.fft3d import fft3d_vector_local
from repro_torch.solvers import integrators
from repro_torch.solvers.base import SpectralSolver


class NavierStokesSolver(SpectralSolver):
    case = "navier_stokes"
    real = True
    components = 3

    def __init__(self, grid, n, *, nu: float = 0.1, dt: float = 2e-3, **kw):
        self.nu = float(nu)
        super().__init__(grid, n, dt=dt, **kw)

    def params(self) -> dict:
        return {"dt": self.dt, "nu": self.nu}

    def initial_fields(self):
        """Taylor–Green vortex, transformed to spectral space and projected.

        The Leray projection every step ends with is applied to the initial
        state too (the reference leaves it out).  Taylor–Green is
        divergence-free, so this changes the state by roundoff only, but
        the forward transform's roundoff times |k| gives max|k·v̂| ≈ 1.7e-8
        at N=256 — above ``validate``'s absolute 1e-8 bound at t=0.
        """
        x, y, z = self._axes_1d()
        sx, cx = self._on_device(np.sin(x)), self._on_device(np.cos(x))
        sy, cy = self._on_device(np.sin(y), "y"), self._on_device(np.cos(y), "y")
        sz = self._on_device(np.sin(z), "z")
        # (y, z, x) layout: X varies last, Y first
        u = (cx[None, None, :] * sy[:, None, None]) * sz[None, :, None]
        v = (-sx[None, None, :] * cy[:, None, None]) * sz[None, :, None]
        u0 = torch.stack([u, v, torch.zeros_like(u)]).to(self.torch_dtype)
        vr, vi = fft3d_vector_local(self.plan, u0, None,
                                    vector_mode=self.vector_mode)
        return sp.project_divergence_free(self.plan, vr, vi)

    def step_fields(self, plan, fields):
        decay = -self.nu * sp.k_squared(plan, fields[0].dtype,
                                        device=fields[0].device)

        def nonlin(y):
            return sp.rotational_nonlinear_term(
                plan, y[0], y[1], vector_mode=self.vector_mode)

        vr, vi = integrators.ifrk4(nonlin, decay, fields, self.dt)
        return sp.project_divergence_free(plan, vr, vi)

    def observables_fields(self, plan, fields):
        vr, vi = fields
        return {"energy": sp.energy_spectrum_total(plan, vr, vi),
                "max_div": sp.max_divergence(plan, vr, vi)}

    def validate(self, history):
        energies = [h["energy"] for h in history]
        decays = all(b <= a * (1 + 1e-9) for a, b in zip(energies,
                                                         energies[1:]))
        div_tol = 1e-8 if self.dtype == np.float64 else 1e-3
        div_ok = all(h["max_div"] < div_tol for h in history)
        lines = [f"energy monotone decay: {decays}",
                 f"divergence-free (max|k.v| < {div_tol:g}): {div_ok}"]
        return decays and div_ok, lines
