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

from repro_torch.kernels import _build, ref

launches = 0

#: largest dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448

_lib = None
_twiddles: dict = {}


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("fft_radix2")
        for fn in (lib.fft_radix2_f32, lib.fft_radix2_f64):
            fn.argtypes = [ctypes.c_void_p] * 6 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def twiddles(n: int, dtype: torch.dtype, device: torch.device):
    """The ``(log2 N, N/2)`` planar twiddle ROM on ``device``, computed in
    float64 and then cast (:func:`ref.twiddle_table_np`), cached."""
    key = (n, dtype, device)
    if key not in _twiddles:
        twr, twi = ref.twiddle_table_np(n, ref._dtype_name(dtype))
        _twiddles[key] = (torch.as_tensor(twr, device=device),
                          torch.as_tensor(twi, device=device))
    return _twiddles[key]


def fft1d_radix2(x_re: torch.Tensor, x_im: torch.Tensor, *, inverse: bool = False):
    """Batched radix-2 FFT over the last axis (any leading shape), planar
    in and out.  ``inverse`` gives ``ifft`` by the conjugate trick."""
    global launches
    if x_re.shape != x_im.shape or x_re.dtype != x_im.dtype \
            or x_re.device != x_im.device:
        raise ValueError("x_re and x_im must share shape, dtype and device: "
                         f"{tuple(x_re.shape)}/{x_re.dtype}/{x_re.device} vs "
                         f"{tuple(x_im.shape)}/{x_im.dtype}/{x_im.device}")
    n = x_re.shape[-1]
    if not (ref.is_pow2(n) and n >= 2):
        raise ValueError(f"N must be a power of two >= 2, got {n}")
    if x_re.device.type == "cpu":
        f = ref.ifft_dif_planar if inverse else ref.fft_dif_planar
        return f(x_re, x_im)
    if x_re.device.type != "cuda":
        raise ValueError(f"fft1d_radix2 runs on cuda or cpu tensors, got "
                         f"{x_re.device}")
    if x_re.dtype == torch.float32:
        fn = _library().fft_radix2_f32
    elif x_re.dtype == torch.float64:
        fn = _library().fft_radix2_f64
    else:
        raise ValueError(f"fft1d_radix2 takes float32 or float64, got {x_re.dtype}")
    if not (x_re.is_contiguous() and x_im.is_contiguous()):
        raise ValueError("fft1d_radix2 needs contiguous inputs")
    smem = 2 * n * x_re.element_size()
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"N={n} in {x_re.dtype} needs {smem} bytes of shared "
                         f"memory per row; the limit is {MAX_SMEM_BYTES}")
    rows = x_re.numel() // n
    if rows >= 2 ** 31:
        raise ValueError(f"{rows} rows exceed the grid limit of 2**31 - 1")
    y_re = torch.empty_like(x_re)
    y_im = torch.empty_like(x_im)
    if rows == 0:
        return y_re, y_im
    twr, twi = twiddles(n, x_re.dtype, x_re.device)
    with torch.cuda.device(x_re.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x_re.data_ptr(), x_im.data_ptr(), twr.data_ptr(),
                 twi.data_ptr(), y_re.data_ptr(), y_im.data_ptr(), rows, n,
                 int(inverse), stream)
    if err != 0:
        raise RuntimeError(f"fft_radix2 kernel launch failed: CUDA error {err} "
                           f"(rows={rows}, N={n}, {x_re.dtype})")
    launches += 1
    return y_re, y_im
