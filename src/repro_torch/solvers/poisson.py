"""Poisson benchmark solver ``∇²φ = f`` with a manufactured solution.

Port of ``repro.solvers.poisson``.  Each "step" is one forward transform,
the spectral inversion ``φ̂ = −f̂/k²`` (zero-mean gauge) and one inverse
transform.  The manufactured solution

    φ(x, y, z) = sin(x)·cos(2y)·sin(3z),   f = ∇²φ = −14·φ

is resolved exactly for N ≥ 8, so φ must come back to near machine
precision.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import spectral as sp
from repro_torch.core.fft3d import DiagonalKernel, spectral_roundtrip_local
from repro_torch.solvers.base import SpectralSolver

_K2 = 1 + 4 + 9  # |k|² of the manufactured mode


class PoissonSolver(SpectralSolver):
    case = "poisson"
    real = True
    components = 0

    def __init__(self, grid, n, *, dt: float = 1.0, **kw):
        super().__init__(grid, n, dt=dt, **kw)

    def _exact(self):
        x, y, z = self._axes_1d()
        return (self._on_device(np.sin(x))[None, None, :]
                * self._on_device(np.cos(2 * y), "y")[:, None, None]) \
            * self._on_device(np.sin(3 * z), "z")[None, :, None]

    def initial_fields(self):
        phi = self._exact().to(self.torch_dtype)
        f = (-_K2 * phi).to(self.torch_dtype)
        # fields: (source f, exact φ, current iterate φ — starts at 0)
        return (f, phi, torch.zeros_like(phi))

    def spectral_kernel(self, plan, dtype, device):
        """``φ̂ = −f̂/k²`` in the zero-mean gauge (k=0 and r2c pad zeroed)."""
        return DiagonalKernel(dr=sp.inverse_laplacian_multiplier(
            plan, dtype, device=device))

    def step_fields(self, plan, fields):
        f, phi_exact, _ = fields
        kern = self.spectral_kernel(plan, f.dtype, f.device)
        phi = spectral_roundtrip_local(plan, kern, f)
        return (f, phi_exact, phi)

    def observables_fields(self, plan, fields):
        f, phi_exact, phi = fields
        err = (phi - phi_exact).abs()
        return {"err_inf": sp.grid_max(plan, err.max()),
                "err_l2": torch.sqrt(sp.grid_sum(plan, (err * err).sum())),
                "phi_max": sp.grid_max(plan, phi.abs().max())}

    def validate(self, history):
        if len(history) < 2:
            return False, ["poisson: needs at least one step to solve"]
        err = history[-1]["err_inf"]
        tol = 1e-10 if self.dtype == np.float64 else 1e-4
        ok = err < tol
        return ok, [f"poisson manufactured solution err_inf = {err:.2e} "
                    f"(< {tol:g}): {ok}"]
