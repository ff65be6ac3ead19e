"""Backend-dispatching 1D FFT wrappers — port of ``repro.kernels.ops``.

``fft1d(x_re, x_im, axis=..., backend=...)`` is the only entry point the rest
of the port uses; ``backend`` selects:

* ``"pallas"`` — the radix-2 CUDA kernel (:mod:`.fft_radix2`; its plain
  version for a tensor on the CPU),
* ``"ref"``    — the plain PyTorch version with the identical dataflow,
* ``"jnp"``    — ``torch.fft``, the library FFT (the reference's XLA FFT),
* ``"mxu"``    — the four-step FFT CUDA kernel, FP64 tensor cores in f64
  (:mod:`.fft_mxu`; its plain version for a tensor on the CPU).

All take/return planar complex (re, im) pairs, any float dtype.  The two
kernels read packed rows: ``slab_copies`` counts the calls whose input
had to be copied into them first (a slab narrowed out of a serving
batch's lane stack, or a strided view); nothing else adds to it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.fft_mxu import fft1d_mxu
from repro_torch.kernels.fft_radix2 import fft1d_radix2

BACKENDS = ("pallas", "ref", "jnp", "mxu")

slab_copies = 0


def check_backend(backend: str) -> None:
    """Refuse an unknown backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown FFT backend {backend!r}; have {BACKENDS}")


def fft1d(x_re, x_im, *, axis: int = -1, backend: str = "pallas",
          inverse: bool = False):
    """Complex-to-complex FFT along ``axis`` (planar in/out)."""
    global slab_copies
    check_backend(backend)
    xr, xi = x_re.movedim(axis, -1), x_im.movedim(axis, -1)
    if backend == "jnp":
        z = torch.complex(xr, xi)
        z = torch.fft.ifft(z) if inverse else torch.fft.fft(z)
        yr, yi = z.real, z.imag
    elif backend == "ref":
        f = _ref.ifft_dif_planar if inverse else _ref.fft_dif_planar
        yr, yi = f(xr, xi)
    else:
        f = fft1d_mxu if backend == "mxu" else fft1d_radix2
        if not (xr.is_contiguous() and xi.is_contiguous()):
            slab_copies += 1
        yr, yi = f(xr.contiguous(), xi.contiguous(), inverse=inverse)
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


def rfft1d(x, *, axis: int = -1, backend: str = "pallas", packed: bool = False):
    """Real-to-complex FFT keeping N/2+1 bins (paper §3.2.5).

    ``packed=True`` runs the even/odd packing (one N/2-point complex FFT,
    on the selected backend); it needs an even length and raises
    ``ValueError`` otherwise (under ``"mxu"`` also at N = 2, where the
    four-step kernel would get one point).  The
    reference packs on its plain version for every backend but
    ``"pallas"``; here only ``"ref"`` does, so that no kernel backend
    reaches the plain version on the card.
    """
    check_backend(backend)
    xr = x.movedim(axis, -1)
    n = xr.shape[-1]
    if packed and n % 2:
        raise ValueError(
            f"rfft1d(packed=True) requires an even transform length (the "
            f"even/odd packing splits n into two n/2 streams), got n={n}; "
            f"use packed=False for odd lengths")
    if packed and backend == "ref":
        yr, yi = _ref.rfft_packed_planar(xr)
    elif packed:
        zr, zi = fft1d(xr[..., 0::2], xr[..., 1::2], axis=-1, backend=backend)
        yr, yi = _ref.untangle_packed(zr, zi, n)
    else:
        zr, zi = fft1d(xr, torch.zeros_like(xr), axis=-1, backend=backend)
        yr, yi = zr[..., : n // 2 + 1], zi[..., : n // 2 + 1]
    return yr.movedim(-1, axis), yi.movedim(-1, axis)


def irfft1d(x_re, x_im, *, n: int, axis: int = -1, backend: str = "pallas"):
    """Complex-to-real inverse, reconstructing the Hermitian upper half."""
    check_backend(backend)
    xr, xi = x_re.movedim(axis, -1), x_im.movedim(axis, -1)
    k = xr.shape[-1]
    if k != n // 2 + 1:
        raise ValueError(f"irfft1d of length n={n} needs {n // 2 + 1} bins, "
                         f"got {k}")
    # rebuild bins n/2+1 .. n-1 by conjugate symmetry
    idx = torch.arange(n // 2 - 1, 0, -1, device=xr.device)
    fr = torch.cat([xr, xr[..., idx]], dim=-1)
    fi = torch.cat([xi, -xi[..., idx]], dim=-1)
    yr, _ = fft1d(fr, fi, axis=-1, backend=backend, inverse=True)
    return yr.movedim(-1, axis)
