"""Port parity: the single-rank 3D FFT of ``repro_torch`` against the JAX
package's ``make_fft3d`` on a 1×1 mesh, both with ``backend="pallas"`` (the
reference in Pallas interpret mode, the port on its kernel's plain
version).  Inputs come from numpy with a seed.  Tolerance: ≤1e-10 relative
to the spectrum's largest entry, the reference's own f64 bound.
"""

import numpy as np
import pytest
import torch

from repro import compat
from repro.core.engine_spec import EngineSpec as JSpec
from repro.core.fft3d import make_fft3d as jmake_fft3d
from repro_torch.core import decomposition as dec
from repro_torch.core.engine_spec import EngineSpec
from repro_torch.core.fft3d import (DiagonalKernel, make_fft3d,
                                    spectral_roundtrip_local)

GRID = dec.PencilGrid.from_mesh(1, 1)


@pytest.fixture(scope="module")
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"))


def rel_close(got, want, tol=1e-10):
    got = [g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
           for g in got]
    want = [np.asarray(w) for w in want]
    scale = max(np.abs(w).max() for w in want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * scale


CASES = [
    # (n, knobs, components)
    (8, dict(real=False), 0),
    (8, dict(real=True), 0),
    ((16, 8, 4), dict(real=True, r2c_packed=True), 0),
    (8, dict(real=True, schedule="pipelined", chunks=2), 0),
    ((8, 4, 16), dict(real=False, schedule="pipelined", chunks=3,
                      engine="overlap_ring"), 0),
    (8, dict(real=True, vector_mode="streaming"), 3),
    (8, dict(real=False, vector_mode="parallel", engine="bidi_ring"), 2),
]


@pytest.mark.parametrize("n,knobs,components", CASES)
def test_make_fft3d_matches_reference(mesh11, n, knobs, components):
    dims = (n, n, n) if isinstance(n, int) else n
    shape = ((components,) if components else ()) + (dims[1], dims[2], dims[0])
    rng = np.random.default_rng(sum(shape))
    xr, xi = rng.standard_normal(shape), rng.standard_normal(shape)
    kw = dict(knobs, backend="pallas")
    fwd, inv, plan = make_fft3d(GRID, n, spec=EngineSpec(**kw),
                                components=components, device="cpu")
    jfwd, jinv, jplan = jmake_fft3d(mesh11, n, spec=JSpec(**kw),
                                    components=components)
    assert (plan.kx, plan.kx_keep) == (jplan.kx, jplan.kx_keep)
    if plan.real:
        kr, ki = fwd(xr)
        jkr, jki = jfwd(xr)
    else:
        kr, ki = fwd(xr, xi)
        jkr, jki = jfwd(xr, xi)
    rel_close((kr, ki), (jkr, jki))
    back = inv(kr, ki)
    jback = jinv(jkr, jki)
    if plan.real:
        rel_close((back,), (jback,))
        np.testing.assert_allclose(back.numpy(), xr, atol=1e-12)
    else:
        rel_close(back, jback)
        np.testing.assert_allclose(back[0].numpy(), xr, atol=1e-12)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("chunks", [1, 2, 3])
def test_fused_roundtrip_matches_composed_and_reference(mesh11, real, chunks):
    n = 8
    rng = np.random.default_rng(10 + chunks)
    xr, xi = rng.standard_normal((n, n, n)), rng.standard_normal((n, n, n))
    kw = dict(backend="pallas", real=real, schedule="pipelined", chunks=chunks)
    jfwd, jinv, jplan = jmake_fft3d(mesh11, n, spec=JSpec(**kw))
    kx = jplan.kx
    dr, di = rng.standard_normal((kx, n, n)), rng.standard_normal((kx, n, n))
    # the reference roundtrip: forward, diagonal multiply, inverse
    jk = jfwd(xr) if real else jfwd(xr, xi)
    jk = (jk[0] * dr - jk[1] * di, jk[0] * di + jk[1] * dr)
    want = jinv(*jk)
    want = (want,) if real else want
    kern = DiagonalKernel(dr=torch.from_numpy(dr), di=torch.from_numpy(di))
    outs = []
    for fused in (False, True):
        _, _, plan = make_fft3d(GRID, n, spec=EngineSpec(
            **kw, fused_roundtrip=fused), device="cpu")
        got = spectral_roundtrip_local(
            plan, kern, torch.from_numpy(xr),
            None if real else torch.from_numpy(xi))
        got = (got,) if real else got
        rel_close(got, want)
        outs.append(got)
    rel_close(outs[1], [o.numpy() for o in outs[0]])


def test_single_rank_only(mesh11):
    # a grid of more ranks runs only in its rank processes (run_ranks)
    with pytest.raises(RuntimeError, match="run_ranks"):
        make_fft3d(dec.PencilGrid.from_mesh(2, 1), 8, device="cpu")
