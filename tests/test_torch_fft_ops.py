"""Port parity: the 1D FFT layer of ``repro_torch`` against ``repro``.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs its Pallas kernel in interpret mode (as the reference's own
tests run it on the CPU) or its pure-jnp reference; the port runs on the
CPU, where backend ``pallas`` is the kernel's plain version.

Tolerances: f64 rtol = atol = 1e-12; f32 rtol 1e-4, atol 1e-3, as in
``tests/test_fft_kernels.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fft_radix2 import fft1d_pallas, ifft1d_pallas
from repro_torch.kernels import fft_mxu, fft_radix2, ops, ref

TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-4, atol=1e-3)}
SIZES = [2, 4, 8, 16, 32, 64]


def planar(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(dtype),
            rng.standard_normal(shape).astype(dtype))


def close(port, ref_arrays, dtype):
    for p, r in zip(port, ref_arrays):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **TOL[dtype])


def lead_for(n):
    """A few leading shapes, varied with n."""
    return {2: (5,), 4: (2, 3), 8: (1,), 16: (3, 2), 32: (4,), 64: (2, 1, 3)}[n]


@pytest.mark.parametrize("n", [2, 4, 8, 64, 512, 8192])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_twiddle_table_bit_for_bit(n, dtype):
    pr, pi = ref.twiddle_table_np(n, dtype)
    jr, ji = jref.twiddle_table_np(n, dtype)
    assert pr.dtype == jr.dtype and pr.tobytes() == jr.tobytes()
    assert pi.dtype == ji.dtype and pi.tobytes() == ji.tobytes()
    np.testing.assert_array_equal(ref.bitrev_permutation(n),
                                  jref.bitrev_permutation(n))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("inverse", [False, True])
def test_radix2_wrapper_matches_pallas_interpret(n, dtype, inverse):
    xr, xi = planar(lead_for(n) + (n,), dtype, seed=n)
    before = fft_radix2.launches
    got = fft_radix2.fft1d_radix2(torch.from_numpy(xr), torch.from_numpy(xi),
                                  inverse=inverse)
    assert fft_radix2.launches == before  # CPU tensors take the plain version
    f = ifft1d_pallas if inverse else fft1d_pallas
    close(got, f(jnp.asarray(xr), jnp.asarray(xi), interpret=True), dtype)


@functools.partial(jax.jit, static_argnames=("axis", "inverse"))
def _jax_dif(xr, xi, *, axis, inverse):
    f = jref.ifft_dif_planar if inverse else jref.fft_dif_planar
    yr, yi = f(jnp.moveaxis(xr, axis, -1), jnp.moveaxis(xi, axis, -1))
    return jnp.moveaxis(yr, -1, axis), jnp.moveaxis(yi, -1, axis)


@pytest.mark.parametrize("backend", ["pallas", "ref", "jnp"])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("axis", [0, -1])
def test_fft1d_matches_reference_dif(backend, n, inverse, axis):
    dtype = np.float64
    xr, xi = planar((n, 3, n), dtype, seed=2 * n + inverse)
    got = ops.fft1d(torch.from_numpy(xr), torch.from_numpy(xi), axis=axis,
                    backend=backend, inverse=inverse)
    yr, yi = _jax_dif(xr, xi, axis=axis, inverse=inverse)
    close(got, (yr, yi), dtype)


@pytest.mark.parametrize("backend", ["pallas", "ref", "jnp"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fft1d_matches_reference_backend(backend, dtype):
    xr, xi = planar((4, 16, 8), dtype, seed=7)
    got = ops.fft1d(torch.from_numpy(xr), torch.from_numpy(xi), axis=1,
                    backend=backend)
    want = jops.fft1d(jnp.asarray(xr), jnp.asarray(xi), axis=1, backend=backend)
    close(got, want, dtype)


@pytest.mark.parametrize("backend", ["pallas", "ref", "jnp"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", [4, 8, 64])
def test_rfft_irfft_match_reference(backend, packed, n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal((3, 5, n))
    yr, yi = ops.rfft1d(torch.from_numpy(x), axis=-1, backend=backend,
                        packed=packed)
    jr, ji = jops.rfft1d(jnp.asarray(x), axis=-1, backend=backend,
                         packed=packed)
    close((yr, yi), (jr, ji), np.float64)
    back = ops.irfft1d(yr, yi, n=n, axis=-1, backend=backend)
    jback = jops.irfft1d(jr, ji, n=n, axis=-1, backend=backend)
    close((back,), (jback,), np.float64)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-12, atol=1e-12)


def test_rfft_on_a_leading_axis():
    x = np.random.default_rng(3).standard_normal((16, 3, 4))
    got = ops.rfft1d(torch.from_numpy(x), axis=0, backend="pallas")
    want = jops.rfft1d(jnp.asarray(x), axis=0, backend="pallas")
    close(got, want, np.float64)


@pytest.mark.parametrize("backend", ["pallas", "ref", "jnp"])
def test_rfft_packed_rejects_odd_length(backend):
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 9)))
    with pytest.raises(ValueError, match="even transform length"):
        ops.rfft1d(x, backend=backend, packed=True)
    # the unpacked library path still takes odd lengths
    yr, yi = ops.rfft1d(x, backend="jnp", packed=False)
    z = np.fft.rfft(x.numpy())
    np.testing.assert_allclose(yr.numpy(), z.real, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yi.numpy(), z.imag, rtol=1e-12, atol=1e-12)


def test_backend_errors():
    x = torch.zeros(2, 8, dtype=torch.float64)
    # backend "mxu" is ported: it gives a result, the four-step plain
    # version on a CPU tensor
    calls = fft_mxu.plain_calls
    yr, yi = ops.fft1d(x + 1.0, x, backend="mxu")
    assert fft_mxu.plain_calls == calls + 1
    np.testing.assert_allclose(yr.numpy(), np.fft.fft(np.ones((2, 8))).real,
                               atol=1e-12)
    assert yi.shape == (2, 8)
    # the four-step wrapper's refusals
    with pytest.raises(ValueError, match="power of two >= 4"):
        fft_mxu.fft1d_mxu(torch.zeros(2, 2), torch.zeros(2, 2))
    with pytest.raises(ValueError, match="power of two >= 4"):
        fft_mxu.fft1d_mxu(torch.zeros(2, 12), torch.zeros(2, 12))
    with pytest.raises(ValueError, match="share shape"):
        fft_mxu.fft1d_mxu(torch.zeros(2, 8), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="share shape"):
        fft_mxu.fft1d_mxu(x, x.float())
    m = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fft_mxu.fft1d_mxu(m, m)
    with pytest.raises(ValueError, match="unknown FFT backend"):
        ops.fft1d(x, x, backend="cufft")
    with pytest.raises(ValueError, match="power of two"):
        fft_radix2.fft1d_radix2(torch.zeros(2, 12), torch.zeros(2, 12))
    with pytest.raises(ValueError, match="share shape"):
        fft_radix2.fft1d_radix2(torch.zeros(2, 8), torch.zeros(3, 8))
    # a tensor neither on the CPU nor on a card is refused, not computed
    m = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fft_radix2.fft1d_radix2(m, m)


def test_plain_version_counts_its_calls():
    x = torch.zeros(3, 8, dtype=torch.float64)
    calls, launches = ref.calls, fft_radix2.launches
    ops.fft1d(x, x, backend="pallas")
    ops.fft1d(x, x, backend="ref", inverse=True)
    ops.fft1d(x, x, backend="jnp")
    assert ref.calls == calls + 2 and fft_radix2.launches == launches
