"""The four-step (Bailey) FFT as a hand-written CUDA kernel for Hopper.

Port of ``repro.kernels.fft_mxu`` (the Pallas TPU kernel ``fft1d_mxu``,
backend ``"mxu"``).  A row x of length N = n1·n2 is viewed as A[j1, j2]
(n = j1·n2 + j2); then

    B = d1 @ A              length-n1 DFTs over j1
    C = B ∘ tw              twiddles W_N^(k1·j2)
    D = C @ d2              length-n2 DFTs over j2
    X[k1 + n1·k2] = D[k1, k2]   (a transposed store)

The kernel, ``csrc/fft_mxu.cu``, gives one thread block to each row, keeps
A (and then C and D) in shared memory and runs the two products in f64 on
the FP64 tensor cores (``mma.sync`` m8n8k4); f32, and f64 below N = 64,
take a CUDA-core FMA loop in full precision.  It is built with ``nvcc`` at
first use (:mod:`repro_torch.kernels._build`) and called through ``ctypes``
on PyTorch's current stream, without synchronising.

:func:`fft1d_mxu` launches the kernel for a CUDA tensor, or raises.  For a
tensor that lies on the CPU it runs the plain version,
:func:`four_step_planar`.  ``launches`` counts kernel launches and
``plain_calls`` counts plain-version calls; nothing else adds to either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _launch, ref

launches = 0
plain_calls = 0

#: the kernel's range of N (shared memory bounds the top in f64); N = 2
#: is n1 = 1, n2 = 2 on the CUDA-core path
MIN_N, MAX_N = 2, 8192

_SIGNATURE = [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
_LIB = _launch.Library("fft_mxu", {"fft_mxu_f32": _SIGNATURE,
                                   "fft_mxu_f64": _SIGNATURE})
_plans: dict = {}


class Plan(NamedTuple):
    """Planar (re, im) tables of the four-step FFT of length n1·n2."""
    n1: int
    n2: int
    d1: tuple   # (n1, n1) DFT_n1
    tw: tuple   # (n1, n2) twiddles W_N^(k1·j2)
    d2: tuple   # (n2, n2) DFT_n2


def _check_n(n: int) -> None:
    if not (ref.is_pow2(n) and n >= MIN_N):
        raise ValueError(f"N must be a power of two >= {MIN_N}, got {n}")


@functools.lru_cache(maxsize=32)
def plan_np(n: int, dtype: str) -> Plan:
    """The tables as numpy arrays: computed in complex128, then cast."""
    _check_n(n)
    s = n.bit_length() - 1
    n1 = 1 << (s // 2)
    n2 = n // n1
    j2 = np.arange(n2)
    d2 = np.exp(-2j * np.pi * np.outer(j2, j2) / n2)
    j1 = np.arange(n1)
    d1 = np.exp(-2j * np.pi * np.outer(j1, j1) / n1)
    tw = np.exp(-2j * np.pi * np.outer(j1, np.arange(n2)) / n)

    def cast(a):
        return a.real.astype(dtype), a.imag.astype(dtype)
    return Plan(n1, n2, cast(d1), cast(tw), cast(d2))


def plan(n: int, dtype: torch.dtype, device) -> Plan:
    """:func:`plan_np` as tensors on ``device``, cached per (n, dtype,
    device)."""
    device = torch.device(device)
    key = (n, dtype, device)
    if key not in _plans:
        p = plan_np(n, ref._dtype_name(dtype))
        _plans[key] = Plan(p.n1, p.n2, *(
            tuple(torch.as_tensor(a, device=device) for a in pair)
            for pair in (p.d1, p.tw, p.d2)))
    return _plans[key]


def fft_mxu_flops(n: int) -> float:
    """Complex-matmul flops per row: 8·N·(n1 + n2)."""
    p = plan_np(n, "float32")
    return 8.0 * n * (p.n1 + p.n2)


def four_step_planar(x_re: torch.Tensor, x_im: torch.Tensor, *,
                     inverse: bool = False):
    """The plain PyTorch version: the four steps over the last axis, with
    four real products per complex product; ``inverse`` by the conjugate
    trick, ifft(x) = conj(fft(conj(x))) / N."""
    global plain_calls
    plain_calls += 1
    n = x_re.shape[-1]
    p = plan(n, x_re.dtype, x_re.device)
    lead = x_re.shape[:-1]
    ar = x_re.reshape(-1, p.n1, p.n2)
    ai = x_im.reshape(-1, p.n1, p.n2)
    if inverse:
        ai = -ai
    (d1r, d1i), (twr, twi), (d2r, d2i) = p.d1, p.tw, p.d2
    br = d1r @ ar - d1i @ ai
    bi = d1r @ ai + d1i @ ar
    cr = br * twr - bi * twi
    ci = br * twi + bi * twr
    dr = cr @ d2r - ci @ d2i
    di = cr @ d2i + ci @ d2r
    yr = dr.transpose(-1, -2).reshape(*lead, n)
    yi = di.transpose(-1, -2).reshape(*lead, n)
    if inverse:
        scale = torch.tensor(1.0 / n, dtype=x_re.dtype)
        return yr * scale, -yi * scale
    return yr, yi


def fft1d_mxu(x_re: torch.Tensor, x_im: torch.Tensor, *, inverse: bool = False):
    """Batched four-step FFT over the last axis (any leading shape), planar
    in and out.  ``inverse`` gives ``ifft`` by the conjugate trick."""
    global launches
    _launch.check_pair(x_re, x_im)
    n = x_re.shape[-1]
    _check_n(n)
    if _launch.runs_plain("fft1d_mxu", x_re):
        return four_step_planar(x_re, x_im, inverse=inverse)
    fn = _LIB.fn("fft_mxu_" + _launch.dtype_suffix("fft1d_mxu", x_re.dtype))
    _launch.check_contiguous("fft1d_mxu", x_re, x_im)
    if n > MAX_N:
        raise ValueError(f"fft1d_mxu runs N <= {MAX_N} (one row in a block's "
                         f"shared memory), got {n}")
    rows = x_re.numel() // n
    _launch.check_rows(rows)
    y_re = torch.empty_like(x_re)
    y_im = torch.empty_like(x_im)
    if rows == 0:
        return y_re, y_im
    p = plan(n, x_re.dtype, x_re.device)
    tables = [t.data_ptr() for pair in (p.d1, p.tw, p.d2) for t in pair]
    _launch.launch("fft_mxu", fn, x_re.device, x_re.data_ptr(),
                   x_im.data_ptr(), *tables, y_re.data_ptr(), y_im.data_ptr(),
                   rows, n, int(inverse),
                   detail=f"rows={rows}, N={n}, {x_re.dtype}")
    launches += 1
    return y_re, y_im
