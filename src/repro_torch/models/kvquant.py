"""Int8 KV-cache quantization: the decode cache's memory lever.

Port of ``repro.models.kvquant``.  Per-(token, head) symmetric scales: k
and v are stored int8 with an f32 scale of shape (..., H, 1), so the
cache's bytes halve against bf16 (the scale adds 1/(2·head_dim)).  The
decode dequantizes a layer's cache on read and quantizes the new token's
entry on write (:mod:`repro_torch.models.transformer`).  The arithmetic is
the reference's, bit for bit: ``amax`` in f32 over the last dim, ``scale =
max(amax, 1e-8) / 127``, ``q = clip(round(x / scale), -127, 127)`` with
rounding half to even (``torch.round`` and ``jnp.round`` alike).

On a mesh whose model axes cut the head_dim of the cache, each rank holds
a block of an entry's last dim: its ``amax`` is then the max over the
ranks of their blocks' (:func:`amax`, all-reduced by the caller), so that
every rank holds the scale of the whole row, as GSPMD computes it.
"""

from __future__ import annotations

import torch


def amax(x: torch.Tensor) -> torch.Tensor:
    """max|x| in f32 over the last dim, kept: (..., 1)."""
    return x.float().abs().amax(-1, keepdim=True)


def quantize(x: torch.Tensor, row_amax: torch.Tensor | None = None):
    """x: (..., D) -> (int8 q, f32 scale (..., 1)).  ``row_amax`` is the
    rows' max|x| where the rows are longer than ``x``'s last dim (a block
    of them), else computed here."""
    xf = x.float()
    if row_amax is None:
        row_amax = amax(x)
    scale = torch.clamp(row_amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
