"""3D heat / diffusion equation ``∂u/∂t = κ ∇²u`` on the 2π³ torus.

Port of ``repro.solvers.heat``.  Each step is one spectral roundtrip with
the exact propagator ``e^{−κk²Δt}`` as a :class:`DiagonalKernel`.  The
single-mode initial condition ``u₀ = sin(m_x x)·cos(m_y y)·cos(m_z z)``
decays as ``e^{−κ|m|²t}``, which ``validate`` checks.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import spectral as sp
from repro_torch.core.fft3d import DiagonalKernel, spectral_roundtrip_local
from repro_torch.solvers.base import SpectralSolver


class HeatSolver(SpectralSolver):
    case = "heat"
    real = True
    components = 0

    def __init__(self, grid, n, *, kappa: float = 0.1, dt: float = 1e-2,
                 mode=(2, 1, 0), **kw):
        self.kappa = float(kappa)
        self.mode = tuple(int(m) for m in mode)
        super().__init__(grid, n, dt=dt, **kw)

    def params(self) -> dict:
        return {"dt": self.dt, "kappa": self.kappa, "mode": list(self.mode)}

    def initial_fields(self):
        x, y, z = self._axes_1d()
        mx, my, mz = self.mode
        # (y, z, x) X-pencil, the reference's sin(mx X)·cos(my Y)·cos(mz Z)
        u0 = (self._on_device(np.sin(mx * x))[None, None, :]
              * self._on_device(np.cos(my * y), "y")[:, None, None]) \
            * self._on_device(np.cos(mz * z), "z")[None, :, None]
        return (u0.to(self.torch_dtype),)

    def spectral_kernel(self, plan, dtype, device):
        """Exact propagator of ``∂u = κ∇²u``: multiply by ``e^{−κk²Δt}``."""
        k2 = sp.k_squared(plan, dtype, device=device)
        return DiagonalKernel(dr=torch.exp(-self.kappa * k2 * self.dt))

    def step_fields(self, plan, fields):
        (u,) = fields
        kern = self.spectral_kernel(plan, u.dtype, u.device)
        return (spectral_roundtrip_local(plan, kern, u),)

    def observables_fields(self, plan, fields):
        (u,) = fields
        ntot = plan.n[0] * plan.n[1] * plan.n[2]
        return {"amp": sp.grid_max(plan, u.abs().max()),
                "mean": sp.grid_sum(plan, u.sum()) / ntot,
                "energy": sp.grid_sum(plan, (u * u).sum())}

    def validate(self, history):
        k2 = float(sum(m * m for m in self.mode))
        last = history[-1]
        expected = history[0]["amp"] * np.exp(-self.kappa * k2 * last["t"])
        rel = abs(last["amp"] - expected) / max(expected, 1e-300)
        tol = 1e-8 if self.dtype == np.float64 else 1e-4
        ok = rel < tol
        return ok, [f"heat decay rate: amp {last['amp']:.6e} vs analytic "
                    f"{expected:.6e} (rel err {rel:.2e} < {tol:g}): {ok}"]
