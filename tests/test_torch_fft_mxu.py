"""Port parity: the four-step FFT (backend ``"mxu"``) of ``repro_torch``
against ``repro``.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs its Pallas kernel ``fft1d_mxu`` in interpret mode, as
``tests/test_fft_mxu.py`` runs it on the CPU; the port runs on the CPU,
where ``fft1d_mxu`` is its plain version ``four_step_planar``.

Tolerances, as the reference's tests state them: relative norm ≤1e-10 in
f64 and ≤2e-4 in f32; solver observables ≤1e-10 per step
(``observables_rel_err``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.kernels import ops as jops
from repro.kernels.fft_mxu import _plan
from repro.kernels.fft_mxu import fft1d_mxu as jfft1d_mxu
from repro.kernels.fft_mxu import fft_mxu_flops as jfft_mxu_flops
from repro.solvers import make_solver as jmake_solver
from repro_torch.core import decomposition as dec
from repro_torch.kernels import fft_mxu, ops, ref
from repro_torch.solvers import make_solver
from repro_torch.solvers.base import observables_rel_err

TOL = {np.float32: 2e-4, np.float64: 1e-10}
SIZES = [4, 8, 16, 64, 128, 512]           # log2 N even and odd (n1 != n2)
LEAD = {4: (2, 3), 8: (5,), 16: (3, 1, 2), 64: (4,), 128: (2, 3), 512: (3,)}


def planar(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def assert_close(got, want, dtype):
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert err <= TOL[dtype], err


@pytest.mark.parametrize("n", [1 << s for s in range(2, 14)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plan_tables_bit_for_bit(n, dtype):
    p = fft_mxu.plan_np(n, dtype)
    n1, n2, d2, tw, d1 = _plan(n, dtype)
    assert (p.n1, p.n2) == (n1, n2) and n1 * n2 == n
    for mine, theirs in ((p.d1, d1), (p.tw, tw), (p.d2, d2)):
        for a, b in zip(mine, theirs):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
    t = fft_mxu.plan(n, getattr(torch, dtype), "cpu")
    assert t.d2[1].numpy().tobytes() == d2[1].tobytes()
    assert fft_mxu.fft_mxu_flops(n) == jfft_mxu_flops(n)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_four_step_matches_pallas_interpret(n, dtype):
    xr, xi = planar(LEAD[n] + (n,), dtype, seed=n)
    calls, launches = fft_mxu.plain_calls, fft_mxu.launches
    got = fft_mxu.fft1d_mxu(torch.from_numpy(xr), torch.from_numpy(xi))
    # a CPU tensor takes the plain version, never the kernel
    assert (fft_mxu.plain_calls, fft_mxu.launches) == (calls + 1, launches)
    want = jfft1d_mxu(jnp.asarray(xr), jnp.asarray(xi), interpret=True)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("inverse", [False, True])
def test_ops_fft1d_mxu_matches_reference(n, dtype, inverse):
    xr, xi = planar((3, n, 2), dtype, seed=3 * n + inverse)
    got = ops.fft1d(torch.from_numpy(xr), torch.from_numpy(xi), axis=1,
                    backend="mxu", inverse=inverse)
    want = jops.fft1d(jnp.asarray(xr), jnp.asarray(xi), axis=1,
                      backend="mxu", inverse=inverse)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("backend", ["jnp", "mxu"])
@pytest.mark.parametrize("n", [8, 64])
def test_packed_rfft_runs_on_the_selected_backend(backend, n):
    # "pallas" and "ref" are held against JAX in test_torch_fft_ops.py
    x = np.random.default_rng(n).standard_normal((3, 5, n))
    calls = ref.calls
    got = ops.rfft1d(torch.from_numpy(x), axis=-1, backend=backend,
                     packed=True)
    assert ref.calls == calls  # no radix-2 plain version under them
    want = jops.rfft1d(jnp.asarray(x), axis=-1, backend=backend, packed=True)
    assert_close(got, want, np.float64)


def test_packed_rfft_on_mxu_needs_eight_points():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 4)))
    with pytest.raises(ValueError, match="power of two >= 4"):
        ops.rfft1d(x, backend="mxu", packed=True)
    yr, _ = ops.rfft1d(x, backend="mxu", packed=False)
    np.testing.assert_allclose(yr.numpy(), np.fft.rfft(x.numpy()).real,
                               rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def mesh11():
    return compat.make_mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("case", ["heat", "nls", "poisson", "navier_stokes"])
def test_solver_case_on_mxu_matches_reference(mesh11, case):
    cfg = {"backend": "mxu"}
    js = jmake_solver(case, mesh11, 8, plan_cfg=cfg)
    _, jhist = js.run(2)
    calls = ref.calls
    ps = make_solver(case, dec.PencilGrid.from_mesh(1, 1), 8, device="cpu",
                     plan_cfg=cfg)
    _, phist = ps.run(2)
    assert ref.calls == calls
    for a, b in zip(phist, jhist):
        assert a["t"] == b["t"]
        assert observables_rel_err(a, b) <= 1e-10, (a, b)
    for s, hist in ((ps, phist), (js, jhist)):
        ok, lines = s.validate(hist)
        assert ok, lines
