"""The four-step (Bailey) FFT as a hand-written CUDA kernel for Hopper.

Port of ``repro.kernels.fft_mxu`` (the Pallas TPU kernel ``fft1d_mxu``,
backend ``"mxu"``).  A row x of length N = n1·n2 is viewed as A[j1, j2]
(n = j1·n2 + j2); then

    B = d1 @ A              length-n1 DFTs over j1
    C = B ∘ tw              twiddles W_N^(k1·j2)
    D = C @ d2              length-n2 DFTs over j2
    X[k1 + n1·k2] = D[k1, k2]   (a transposed store)

The kernel, ``csrc/fft_mxu.cu``, runs the two products in f64 on the FP64
tensor cores as ``mma.sync`` m16n8k16 (the fastest f64 shape on the H100:
:func:`mma_rates`), on a persistent grid of one 8-warp block an SM: sets of
rows arrive in a ring of shared-memory stages by bulk asynchronous copies
under mbarriers while each warp takes a 16-row tile of a row through all
four steps in registers, the tables staged once a block in fragment order;
f32, and f64 below N = 64, take a CUDA-core FMA loop in full precision.  The bulk copies need 16-byte aligned rows: the wrapper refuses
an f64 input whose base is not.  It is built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`) and called through ``ctypes`` on
PyTorch's current stream, without synchronising.

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
#: the least N of the f64 tensor-core path (below it, and in f32, the
#: CUDA-core path)
TC_MIN_N = 64

_SIGNATURE = [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p]
_LIB = _launch.Library("fft_mxu", {
    "fft_mxu_f32": _SIGNATURE, "fft_mxu_f64": _SIGNATURE,
    "fft_mxu_mma_rate": [ctypes.c_int] * 4 + [ctypes.c_longlong, ctypes.c_void_p,
                                              ctypes.c_void_p]})
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
    if x_re.dtype == torch.float64 and n >= TC_MIN_N and (
            x_re.data_ptr() % 16 or x_im.data_ptr() % 16):
        raise ValueError("fft1d_mxu stages f64 rows with bulk copies, which "
                         "need 16-byte aligned inputs; got bases at "
                         f"{x_re.data_ptr() % 16} and {x_im.data_ptr() % 16} "
                         "bytes past 16")
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


#: the f64 ``mma.sync`` shapes of sm_90, in the probe's numbering: (name,
#: M, N, K)
MMA_SHAPES = (("m8n8k4", 8, 8, 4), ("m16n8k4", 16, 8, 4),
              ("m16n8k8", 16, 8, 8), ("m16n8k16", 16, 8, 16))


def mma_rates(device="cuda", chains=(1, 4, 8), iters: int = 4096,
              warps_per_sm: int = 16) -> list[dict]:
    """TFLOP/s of each f64 ``mma.sync`` shape on the card: every SM runs
    ``warps_per_sm`` warps, each ``iters`` rounds of ``chains``
    independent products on register operands; CUDA events around the
    launch (after a warm-up launch), best of 3."""
    device = torch.device(device)
    fn = _LIB.fn("fft_mxu_mma_rate")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    threads = 256
    blocks = sms * warps_per_sm * 32 // threads
    out = torch.empty(blocks * threads, dtype=torch.float64, device=device)
    rows = []
    for shape, (name, m, n, k) in enumerate(MMA_SHAPES):
        for c in chains:
            flops = 2.0 * m * n * k * c * iters * blocks * (threads // 32)
            times = []
            for rep in range(4):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                _launch.launch("fft_mxu_mma_rate", fn, device, shape, c, blocks,
                               threads, iters, out.data_ptr(),
                               detail=f"{name} chains={c}")
                end.record()
                torch.cuda.synchronize(device)
                if rep:
                    times.append(start.elapsed_time(end))
            ms = min(times)
            rows.append({"shape": name, "chains": c, "ms": ms,
                         "tflops": flops / ms / 1e9})
    return rows
