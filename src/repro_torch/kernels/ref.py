"""Plain PyTorch versions of the radix-2 DIF FFT engine (paper §3.3, Fig. 3.7).

Port of ``repro.kernels.ref``: the same planar-complex algorithm —
``log2(N)`` decimation-in-frequency butterfly stages followed by the
bit-reversal reorder — written with PyTorch tensor operations, so it runs
on any device.  It is what the CUDA kernel of
:mod:`repro_torch.kernels.fft_radix2` is held against (same twiddles, same
operation order), and what that kernel's wrapper runs for a tensor that
lies on the CPU.

``calls`` counts :func:`fft_dif_planar` invocations (every plain transform
goes through it), so a run can show that the card path never reached the
plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

calls = 0


def is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


def bitrev_permutation(n: int) -> np.ndarray:
    """Indices p with p[k] = bit-reverse(k) for a log2(n)-bit index."""
    if not is_pow2(n):
        raise ValueError(f"bit reversal needs a power of two, got {n}")
    bits = n.bit_length() - 1
    p = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((p >> b) & 1) << (bits - 1 - b)
    return out


@functools.lru_cache(maxsize=64)
def twiddle_table_np(n: int, dtype: str = "float64") -> tuple[np.ndarray, np.ndarray]:
    """The twiddle ROM (paper Fig. 3.8): rows s = stage, N/2 entries per row.

    Row ``s`` holds the stage-s twiddles ``W_{N/2^s}^j`` (j = 0..N/2^{s+1}-1)
    tiled across the 2^s butterfly groups — the flattened ``(groups, half)``
    layout, so butterfly ``b`` of stage ``s`` uses entry ``[s, b]``.
    Computed in float64, then cast.
    """
    if not (is_pow2(n) and n >= 2):
        raise ValueError(f"N must be a power of two >= 2, got {n}")
    stages = n.bit_length() - 1
    re = np.zeros((stages, n // 2), dtype=np.float64)
    im = np.zeros((stages, n // 2), dtype=np.float64)
    for s in range(stages):
        half = n >> (s + 1)          # butterfly span at this stage
        groups = 1 << s
        j = np.arange(half)
        ang = -2.0 * np.pi * j / (2 * half)
        re[s] = np.tile(np.cos(ang), groups)
        im[s] = np.tile(np.sin(ang), groups)
    return re.astype(dtype), im.astype(dtype)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def dif_planar(x_re: torch.Tensor, x_im: torch.Tensor, tw_re: torch.Tensor,
               tw_im: torch.Tensor):
    """The DIF stages over the last axis with the ``(log2 N, N/2)`` twiddle
    tables ``tw_re``/``tw_im``, then the bit-reversal reorder: natural order
    in and out.  Not counted in ``calls`` (the ring payload's plain version
    counts its own)."""
    n = x_re.shape[-1]
    if not (is_pow2(n) and n >= 2):
        raise ValueError(f"N must be a power of two >= 2, got {n}")
    stages = n.bit_length() - 1
    lead = x_re.shape[:-1]

    xr = x_re.reshape(-1, n)
    xi = x_im.reshape(-1, n)
    for s in range(stages):
        half = n >> (s + 1)
        groups = 1 << s
        wr = tw_re[s].reshape(1, groups, half)
        wi = tw_im[s].reshape(1, groups, half)
        xr = xr.reshape(-1, groups, 2, half)
        xi = xi.reshape(-1, groups, 2, half)
        ar, br = xr[:, :, 0, :], xr[:, :, 1, :]
        ai, bi = xi[:, :, 0, :], xi[:, :, 1, :]
        # Butterfly (paper Eq. 3.8): top = a + b ; bot = (a - b) * W
        tr, ti = ar + br, ai + bi
        dr, di = ar - br, ai - bi
        ur = dr * wr - di * wi
        ui = dr * wi + di * wr
        xr = torch.stack([tr, ur], dim=2).reshape(-1, n)
        xi = torch.stack([ti, ui], dim=2).reshape(-1, n)
    # Output of the DIF tree is bit-reversed; reorder to natural order.
    perm = torch.as_tensor(bitrev_permutation(n), device=x_re.device)
    xr = xr[:, perm].reshape(*lead, n)
    xi = xi[:, perm].reshape(*lead, n)
    return xr, xi


def fft_dif_planar(x_re: torch.Tensor, x_im: torch.Tensor):
    """Radix-2 DIF FFT over the last axis; natural-order in and out."""
    global calls
    calls += 1
    n = x_re.shape[-1]
    if not (is_pow2(n) and n >= 2):
        raise ValueError(f"N must be a power of two >= 2, got {n}")
    tw_re, tw_im = twiddle_table_np(n, _dtype_name(x_re.dtype))
    return dif_planar(x_re, x_im, torch.as_tensor(tw_re, device=x_re.device),
                      torch.as_tensor(tw_im, device=x_re.device))


def ifft_dif_planar(x_re: torch.Tensor, x_im: torch.Tensor):
    """Inverse via conj trick: ifft(x) = conj(fft(conj(x))) / N (paper §3.2.4)."""
    n = x_re.shape[-1]
    yr, yi = fft_dif_planar(x_re, -x_im)
    scale = torch.tensor(1.0 / n, dtype=x_re.dtype)
    return yr * scale, -yi * scale


def rfft_packed_planar(x: torch.Tensor):
    """Beyond-paper optimization: N-point real FFT via one N/2-point complex FFT.

    Packs even/odd samples as real/imag parts, then untangles with the
    standard split.  Requires an even N.
    """
    n = x.shape[-1]
    if n % 2:
        raise ValueError(f"packed real FFT needs an even length, got {n}")
    zr, zi = fft_dif_planar(x[..., 0::2], x[..., 1::2])
    return untangle_packed(zr, zi, n)


def untangle_packed(zr: torch.Tensor, zi: torch.Tensor, n: int):
    """The N/2+1 bins of an N-point real FFT from the N/2-point complex FFT
    ``Z`` of its even (real part) and odd (imaginary part) samples."""
    h = n // 2
    # Zc[k] = conj(Z[(h-k) mod h])
    idx = torch.remainder(-torch.arange(h, device=zr.device), h)
    zcr, zci = zr[..., idx], -zi[..., idx]
    # E = (Z + Zc)/2 (DFT of evens), O = (Z - Zc)/(2i) (DFT of odds)
    er = 0.5 * (zr + zcr)
    ei = 0.5 * (zi + zci)
    o_r = 0.5 * (zi - zci)
    o_i = -0.5 * (zr - zcr)
    k = np.arange(h)
    wr = torch.as_tensor(np.cos(-2 * np.pi * k / n), dtype=zr.dtype, device=zr.device)
    wi = torch.as_tensor(np.sin(-2 * np.pi * k / n), dtype=zr.dtype, device=zr.device)
    # X[k] = E[k] + W_N^k O[k], k = 0..h-1 ; X[h] = E[0] - O[0]
    xr = er + (o_r * wr - o_i * wi)
    xi = ei + (o_r * wi + o_i * wr)
    xr = torch.cat([xr, er[..., :1] - o_r[..., :1]], dim=-1)
    xi = torch.cat([xi, ei[..., :1] - o_i[..., :1]], dim=-1)
    return xr, xi
