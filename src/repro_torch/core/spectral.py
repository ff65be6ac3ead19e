"""Spectral-space operators for pseudo-spectral solvers (§1.2).

Port of ``repro.core.spectral``.  Every function acts on Z-pencil spectral
fields — local shape ``(..., Kx/Pu, Ny/Pv, Nz)`` — carried as planar
``(re, im)`` tensor pairs; a vector field's component axis is −4, so that
leading axes (a serving batch's lanes) pass through.  The local
wavenumber slabs depend on this rank's ``(u, v)`` grid coordinates, which
come from ``plan.grid.coords``.
Wavenumber helpers take the ``dtype`` and ``device`` of the fields they
serve.  The grid reductions (``lax.psum``/``lax.pmax`` in the reference)
are the identity on one rank and an all-reduce over the ranks' gloo group
otherwise: they carry a few observable scalars, through the host.
"""

from __future__ import annotations

import torch

from repro_torch import dist
from repro_torch.core import precision
from repro_torch.core.fft3d import FFT3DPlan, fft3d_vector_local, ifft3d_vector_local


def _dtype(dtype):
    return precision.default_real_dtype() if dtype is None else dtype


def _fftfreq_int(n: int, dtype, device):
    k = torch.arange(n, device=device)
    return torch.where(k <= n // 2 - 1 + (n % 2), k, k - n).to(dtype)


def local_wavenumbers(plan: FFT3DPlan, dtype=None, *, device):
    """(kx, ky, kz) integer wavenumbers for this rank's Z-pencil slab.

    kx: slab of the padded spectral X axis (r2c keeps 0..N/2 then pad);
    ky: slab of fftfreq-ordered Ny; kz: full fftfreq-ordered Nz.
    """
    dtype = _dtype(dtype)
    nx, ny, nz = plan.n
    g = plan.grid
    u, v = g.coords
    if plan.real:
        kx_full = torch.arange(plan.kx, device=device).to(dtype)
    else:
        kx_full = _fftfreq_int(nx, dtype, device)
    lx = plan.kx // g.pu
    kx = kx_full[u * lx:(u + 1) * lx]
    ly = ny // g.pv
    ky = _fftfreq_int(ny, dtype, device)[v * ly:(v + 1) * ly]
    kz = _fftfreq_int(nz, dtype, device)
    return kx[:, None, None], ky[None, :, None], kz[None, None, :]


def pad_mask(plan: FFT3DPlan, dtype=None, *, device):
    """1 on significant kx bins, 0 on the r2c shard padding."""
    dtype = _dtype(dtype)
    g = plan.grid
    lx = plan.kx // g.pu
    idx = g.coords[0] * lx + torch.arange(lx, device=device)
    return (idx < plan.kx_keep).to(dtype)[:, None, None]


def dealias_mask(plan: FFT3DPlan, dtype=None, *, device):
    """2/3-rule mask for the pseudo-spectral nonlinear term."""
    dtype = _dtype(dtype)
    kx, ky, kz = local_wavenumbers(plan, dtype, device=device)
    nx, ny, nz = plan.n
    m = ((kx.abs() < nx / 3.0)
         & (ky.abs() < ny / 3.0)
         & (kz.abs() < nz / 3.0))
    out = m.to(dtype)
    if plan.real:
        out = out * pad_mask(plan, dtype, device=device)
    return out


def k_squared(plan: FFT3DPlan, dtype=None, *, device):
    kx, ky, kz = local_wavenumbers(plan, _dtype(dtype), device=device)
    return kx * kx + ky * ky + kz * kz


def inverse_laplacian_multiplier(plan: FFT3DPlan, dtype=None, *, device):
    """``−1/k²`` with the k=0 mode (and the r2c pad) set to 0."""
    k2 = k_squared(plan, dtype, device=device)
    inv = torch.where(k2 > 0, -1.0 / k2.clamp_min(1e-30), torch.zeros_like(k2))
    if plan.real:
        inv = inv * pad_mask(plan, k2.dtype, device=device)
    return inv


def invert_laplacian(plan: FFT3DPlan, fr, fi, *, mean: float = 0.0):
    """Solve ∇²φ = f in spectral space: φ̂ = −f̂ / k².

    ``mean`` fixes the gauge: the returned field's mean is set to it (the
    k=0 bin, on the rank that owns it).
    """
    inv = inverse_laplacian_multiplier(plan, fr.dtype, device=fr.device)
    pr, pi = fr * inv, fi * inv
    if mean:
        ntot = plan.n[0] * plan.n[1] * plan.n[2]  # unnormalized forward FFT
        k2 = k_squared(plan, fr.dtype, device=fr.device)
        zero_mode = k2 == 0
        if plan.real:
            zero_mode = zero_mode & (pad_mask(plan, fr.dtype, device=fr.device) > 0)
        pr = torch.where(zero_mode, torch.full_like(pr, mean * ntot), pr)
    return pr, pi


def gradient(plan: FFT3DPlan, fr, fi):
    """∂/∂(x,y,z) in spectral space: multiply by i·k (planar complex)."""
    kx, ky, kz = local_wavenumbers(plan, fr.dtype, device=fr.device)
    return [(-k * fi, k * fr) for k in (kx, ky, kz)]


def curl(plan: FFT3DPlan, vr, vi):
    """Vorticity ω̂ = i k × v̂ for a planar (..., 3, ...) spectral field
    (the component axis is −4; leading axes are lanes)."""
    kx, ky, kz = local_wavenumbers(plan, vr.dtype, device=vr.device)

    def cross_k(ar):
        a = ar.unbind(-4)
        return torch.stack([ky * a[2] - kz * a[1],
                            kz * a[0] - kx * a[2],
                            kx * a[1] - ky * a[0]], dim=-4)

    # i*(k × v): (i k) × (vr + i vi) = -(k × vi) + i (k × vr)
    return -cross_k(vi), cross_k(vr)


def project_divergence_free(plan: FFT3DPlan, vr, vi):
    """Leray projection: v̂ ← v̂ − k (k·v̂)/k² for a 3-component field
    (component axis −4)."""
    ks = local_wavenumbers(plan, vr.dtype, device=vr.device)
    k2 = k_squared(plan, vr.dtype, device=vr.device)
    vr, vi = vr.unbind(-4), vi.unbind(-4)
    dot_r = sum(ks[c] * vr[c] for c in range(3))
    dot_i = sum(ks[c] * vi[c] for c in range(3))
    inv = torch.where(k2 > 0, 1.0 / k2.clamp_min(1e-30), torch.zeros_like(k2))
    pr = torch.stack([vr[c] - ks[c] * dot_r * inv for c in range(3)], dim=-4)
    pi = torch.stack([vi[c] - ks[c] * dot_i * inv for c in range(3)], dim=-4)
    return pr, pi


def rotational_nonlinear_term(plan: FFT3DPlan, vr, vi, *,
                              vector_mode="streaming", project=True):
    """Dealiased rotational-form convection term \\widehat{u × ω}: two
    inverse and one forward vector transform, the cross product in physical
    space, the 2/3 mask and (optionally) the Leray projection."""
    u = ifft3d_vector_local(plan, vr, vi, vector_mode=vector_mode).unbind(-4)
    wr, wi = curl(plan, vr, vi)
    w = ifft3d_vector_local(plan, wr, wi, vector_mode=vector_mode).unbind(-4)
    uxw = torch.stack([u[1] * w[2] - u[2] * w[1],
                       u[2] * w[0] - u[0] * w[2],
                       u[0] * w[1] - u[1] * w[0]], dim=-4)
    nr, ni = fft3d_vector_local(plan, uxw, None, vector_mode=vector_mode)
    mask = dealias_mask(plan, nr.dtype, device=nr.device)
    nr, ni = nr * mask, ni * mask
    if project:
        nr, ni = project_divergence_free(plan, nr, ni)
    return nr, ni


def grid_sum(plan: FFT3DPlan, x):
    """Sum of local scalar ``x`` over the whole Pu×Pv processor grid."""
    return x if plan.grid.p == 1 else dist.all_reduce(x, "sum")


def grid_max(plan: FFT3DPlan, x):
    """Max of local scalar ``x`` over the whole Pu×Pv processor grid."""
    return x if plan.grid.p == 1 else dist.all_reduce(x, "max")


def energy_spectrum_total(plan: FFT3DPlan, vr, vi):
    """Total kinetic energy Σ|v̂|² over the grid."""
    return grid_sum(plan, torch.sum(vr * vr + vi * vi))


def max_divergence(plan: FFT3DPlan, vr, vi):
    """max |k·v̂| over the grid — the divergence-free diagnostic."""
    kx, ky, kz = local_wavenumbers(plan, vr.dtype, device=vr.device)
    vr, vi = vr.unbind(-4), vi.unbind(-4)
    div = (kx * vr[0] + ky * vr[1] + kz * vr[2]).abs().max() + \
        (kx * vi[0] + ky * vi[1] + kz * vi[2]).abs().max()
    return grid_max(plan, div)
