"""Split-step nonlinear Schrödinger / Gross–Pitaevskii solver.

Port of ``repro.solvers.nls``: ``i ∂ψ/∂t = −½∇²ψ + g|ψ|²ψ`` on the 2π³
torus by Strang-split split-step Fourier — a nonlinear half-kick, the
exact kinetic propagator ``e^{−i k² Δt/2}`` as a complex diagonal in
k-space (c2c transforms), and a second half-kick.  Both sub-steps are
phase rotations, so ``∫|ψ|²`` is conserved to roundoff (``validate``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import spectral as sp
from repro_torch.core.fft3d import DiagonalKernel, spectral_roundtrip_local
from repro_torch.solvers.base import SpectralSolver


class NLSSolver(SpectralSolver):
    case = "nls"
    real = False        # complex wavefunction: c2c transforms
    components = 0

    def __init__(self, grid, n, *, g: float = 1.0, dt: float = 1e-3, **kw):
        self.g = float(g)
        super().__init__(grid, n, dt=dt, **kw)

    def params(self) -> dict:
        return {"dt": self.dt, "g": self.g}

    def initial_fields(self):
        x, y, z = self._axes_1d()
        # smooth condensate with a phase ramp and a density perturbation:
        # ψ = (1 + 0.2·cos X·cos Y·cos Z)·e^{i sin Z} on the (y, z, x) pencil
        amp = 1.0 + (self._on_device(0.2 * np.cos(x))[None, None, :]
                     * self._on_device(np.cos(y), "y")[:, None, None]) \
            * self._on_device(np.cos(z), "z")[None, :, None]
        phase = np.sin(z)
        re = amp * self._on_device(np.cos(phase), "z")[None, :, None]
        im = amp * self._on_device(np.sin(phase), "z")[None, :, None]
        return (re.to(self.torch_dtype), im.to(self.torch_dtype))

    def _half_kick(self, pr, pi):
        """ψ ← ψ·e^{−i g|ψ|² Δt/2} — the local nonlinear phase rotation."""
        theta = -self.g * (pr * pr + pi * pi) * (self.dt / 2)
        c, s = torch.cos(theta), torch.sin(theta)
        return pr * c - pi * s, pr * s + pi * c

    def spectral_kernel(self, plan, dtype, device):
        """Exact kinetic propagator ``e^{−i k² Δt/2}``: multiply by
        ``cos θ + i sin θ``, θ = −k²Δt/2."""
        theta = -0.5 * sp.k_squared(plan, dtype, device=device) \
            * self.dt
        return DiagonalKernel(dr=torch.cos(theta), di=torch.sin(theta))

    def step_fields(self, plan, fields):
        pr, pi = self._half_kick(*fields)
        kern = self.spectral_kernel(plan, pr.dtype, pr.device)
        pr, pi = spectral_roundtrip_local(plan, kern, pr, pi)
        return self._half_kick(pr, pi)

    def observables_fields(self, plan, fields):
        pr, pi = fields
        ntot = plan.n[0] * plan.n[1] * plan.n[2]
        dv = (2 * np.pi) ** 3 / ntot
        density = pr * pr + pi * pi
        return {"norm": sp.grid_sum(plan, density.sum()) * dv,
                "density_max": sp.grid_max(plan, density.max())}

    def validate(self, history):
        n0, nT = history[0]["norm"], history[-1]["norm"]
        drift = abs(nT - n0) / max(abs(n0), 1e-300)
        tol = 1e-10 if self.dtype == np.float64 else 1e-5
        ok = drift < tol
        return ok, [f"nls norm conservation: drift {drift:.2e} over "
                    f"{len(history) - 1} steps (< {tol:g}): {ok}"]
