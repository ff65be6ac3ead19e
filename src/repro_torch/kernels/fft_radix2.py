"""The paper's radix-2 FFT engine as a hand-written CUDA kernel for Hopper.

Port of ``repro.kernels.fft_radix2`` (the Pallas TPU kernel
``fft1d_pallas``/``ifft1d_pallas``).  The kernel, ``csrc/fft_radix2.cu``,
gives one thread block to each pencil row and runs all ``log2(N)``
butterfly stages in shared memory, so device memory sees one read and one
write of the data — the call is bound by memory bandwidth.  It is built
with ``nvcc`` at first use (:mod:`repro_torch.kernels._build`) and called
through ``ctypes`` on PyTorch's current stream, without synchronising.

:func:`fft1d_radix2` launches the kernel for a CUDA tensor, or raises.  For
a tensor that lies on the CPU it runs the plain version,
:func:`repro_torch.kernels.ref.fft_dif_planar` (or its inverse).

``launches`` counts kernel launches; nothing else adds to it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _launch, ref

launches = 0

#: largest dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448

_SIGNATURE = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
_LIB = _launch.Library("fft_radix2", {"fft_radix2_f32": _SIGNATURE,
                                      "fft_radix2_f64": _SIGNATURE})
_twiddles: dict = {}


def twiddles(n: int, dtype: torch.dtype, device: torch.device):
    """The ``(log2 N, N/2)`` planar twiddle ROM on ``device``, computed in
    float64 and then cast (:func:`ref.twiddle_table_np`), cached."""
    key = (n, dtype, device)
    if key not in _twiddles:
        twr, twi = ref.twiddle_table_np(n, ref._dtype_name(dtype))
        _twiddles[key] = (torch.as_tensor(twr, device=device),
                          torch.as_tensor(twi, device=device))
    return _twiddles[key]


def check_row_smem(n: int, dtype: torch.dtype) -> None:
    """Refuse a row that does not fit one block's shared memory."""
    smem = 2 * n * dtype.itemsize
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"N={n} in {dtype} needs {smem} bytes of shared "
                         f"memory per row; the limit is {MAX_SMEM_BYTES}")


def fft1d_radix2(x_re: torch.Tensor, x_im: torch.Tensor, *, inverse: bool = False):
    """Batched radix-2 FFT over the last axis (any leading shape), planar
    in and out.  ``inverse`` gives ``ifft`` by the conjugate trick."""
    global launches
    _launch.check_pair(x_re, x_im)
    n = x_re.shape[-1]
    if not (ref.is_pow2(n) and n >= 2):
        raise ValueError(f"N must be a power of two >= 2, got {n}")
    if _launch.runs_plain("fft1d_radix2", x_re):
        f = ref.ifft_dif_planar if inverse else ref.fft_dif_planar
        return f(x_re, x_im)
    fn = _LIB.fn("fft_radix2_" + _launch.dtype_suffix("fft1d_radix2", x_re.dtype))
    _launch.check_contiguous("fft1d_radix2", x_re, x_im)
    check_row_smem(n, x_re.dtype)
    rows = x_re.numel() // n
    _launch.check_rows(rows)
    y_re = torch.empty_like(x_re)
    y_im = torch.empty_like(x_im)
    if rows == 0:
        return y_re, y_im
    twr, twi = twiddles(n, x_re.dtype, x_re.device)
    _launch.launch("fft_radix2", fn, x_re.device, x_re.data_ptr(),
                   x_im.data_ptr(), twr.data_ptr(), twi.data_ptr(),
                   y_re.data_ptr(), y_im.data_ptr(), rows, n, int(inverse),
                   detail=f"rows={rows}, N={n}, {x_re.dtype}")
    launches += 1
    return y_re, y_im
