"""Port parity: the spectral operators of ``repro_torch.core.spectral``
against ``repro.core.spectral`` on a 1×1 mesh (the reference's run inside
``shard_map``, as in its solvers).  Fields come from numpy with a seed;
f64, tolerance ≤1e-12 of each output's largest entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import compat
from repro.core import spectral as jsp
from repro.core.decomposition import PencilGrid as JGrid
from repro.core.fft3d import FFT3DPlan as JPlan
from repro_torch.core import spectral as sp
from repro_torch.core.decomposition import PencilGrid
from repro_torch.core.fft3d import FFT3DPlan


@pytest.fixture(scope="module")
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"))


def in_mesh(mesh, fn, *args):
    """Run the reference's rank-local ``fn`` on the 1×1 mesh."""
    return jax.jit(compat.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                                    out_specs=P(), check_vma=False))(*args)


def close(got, want, tol=1e-12):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("n", [(8, 8, 8), (16, 8, 4)])
def test_operators_match_reference(mesh11, real, n):
    plan = FFT3DPlan(n=n, grid=PencilGrid(1, 1), real=real)
    jplan = JPlan(n=n, grid=JGrid(1, 1), real=real)
    shape = (plan.kx, n[1], n[2])
    rng = np.random.default_rng(sum(n) + real)
    fr, fi = rng.standard_normal(shape), rng.standard_normal(shape)
    vr, vi = rng.standard_normal((3,) + shape), rng.standard_normal((3,) + shape)
    t = lambda a: torch.from_numpy(a)
    dev = dict(device="cpu")

    for got, want in zip(sp.local_wavenumbers(plan, **dev),
                         in_mesh(mesh11, lambda: jsp.local_wavenumbers(jplan))):
        close(got, want)
    close(sp.k_squared(plan, **dev), in_mesh(mesh11, lambda: jsp.k_squared(jplan)))
    close(sp.dealias_mask(plan, **dev),
          in_mesh(mesh11, lambda: jsp.dealias_mask(jplan)))
    close(sp.pad_mask(plan, **dev), in_mesh(mesh11, lambda: jsp.pad_mask(jplan)))
    for mean in (0.0, 0.25):
        got = sp.invert_laplacian(plan, t(fr), t(fi), mean=mean)
        want = in_mesh(mesh11, lambda a, b: jsp.invert_laplacian(
            jplan, a, b, mean=mean), fr, fi)
        for g, w in zip(got, want):
            close(g, w)
    for (gr, gi), (wr, wi) in zip(
            sp.gradient(plan, t(fr), t(fi)),
            in_mesh(mesh11, lambda a, b: jsp.gradient(jplan, a, b), fr, fi)):
        close(gr, wr)
        close(gi, wi)
    for op in ("curl", "project_divergence_free"):
        got = getattr(sp, op)(plan, t(vr), t(vi))
        want = in_mesh(mesh11, lambda a, b: getattr(jsp, op)(jplan, a, b), vr, vi)
        for g, w in zip(got, want):
            close(g, w)
    close(sp.max_divergence(plan, t(vr), t(vi)),
          in_mesh(mesh11, lambda a, b: jsp.max_divergence(jplan, a, b), vr, vi))
    close(sp.energy_spectrum_total(plan, t(vr), t(vi)),
          in_mesh(mesh11, lambda a, b: jsp.energy_spectrum_total(jplan, a, b),
                  vr, vi))


def test_wavenumbers_follow_the_rank_coordinates():
    plan = FFT3DPlan(n=(8, 8, 8), grid=PencilGrid.from_mesh(2, 4, coords=(1, 3)))
    kx, ky, kz = sp.local_wavenumbers(plan, device="cpu")
    assert kx.flatten().tolist() == [-4.0, -3.0, -2.0, -1.0]
    assert ky.flatten().tolist() == [-2.0, -1.0]
    assert kz.numel() == 8
