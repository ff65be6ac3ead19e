"""Mamba (S6) selective-SSM layers of the port, for the Jamba hybrid
(arXiv:2403.19887).

Port of ``repro.models.mamba``.  :class:`Mamba` holds the reference's
parameters under its names, shapes and init modes (``init_mamba``); the
functions take a dict of (cast) tensors, as the JAX functions take a
pytree.  A layer's decode state is the conv tail (B, d_conv − 1, d_inner)
in the compute dtype and the SSM state (B, d_inner, d_state) f32: O(1) in
the sequence's length.

Dtypes as the reference's: ``in_proj``, the causal depthwise conv (the sum
of ``d_conv`` shifted slices), SiLU, ``x_proj`` and the ``dt_w`` product
with its bias in the compute dtype; softplus, B, C and the recurrence in
f32; the ``D`` skip in f32; y cast back to the compute dtype, gated by
``silu(z)``, then ``out_proj``.  The recurrence, with its ``D`` skip, is
one call of :func:`repro_torch.kernels.selective_scan.selective_scan` a
layer (the kernel on the card, its plain version on the CPU, or with
``plain`` on any device), for a prompt (:func:`mamba_seq`) and for one
decode step (:func:`mamba_step`).  Under autograd :func:`mamba_seq` takes
no other path: the scan's ``torch.autograd.Function`` carries the
gradient (its backward the ``selective_scan_bwd`` kernel), and its
forward keeps the state every 16 steps, the kernel's form of the
reference's ``chunked_time_scan`` (its training's remat of the time
scan, in chunks of 256 steps).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.selective_scan import selective_scan, selective_scan_plain


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return max(1, -(-self.d_model // 16))


class Mamba(nn.Module):
    """``init_mamba`` (``mamba.py:35``): the input and output projections,
    the depthwise conv's weight and bias, ``x_proj`` (Δ's low rank, B and
    C), Δ's ``dt_w`` and bias, ``A_log`` and ``D``."""

    AXES = {"in_proj": ("embed", "mlp"), "conv_w": ("conv", "mlp"), "conv_b": ("mlp",),
            "x_proj": ("mlp", "state"), "dt_w": ("state", "mlp"), "dt_b": ("mlp",),
            "A_log": ("mlp", "state"), "D": ("mlp",), "out_proj": ("mlp", "embed")}

    def __init__(self, ini, m: MambaDims):
        super().__init__()
        di, ds, dr = m.d_inner, m.d_state, m.dt_rank
        self.in_proj = ini.param((m.d_model, 2 * di))
        self.conv_w = ini.param((m.d_conv, di), scale=0.1)
        self.conv_b = ini.param((di,), mode="zeros")
        self.x_proj = ini.param((di, dr + 2 * ds))
        self.dt_w = ini.param((dr, di))
        self.dt_b = ini.param((di,), mode="ones")
        self.A_log = ini.param((di, ds), mode="ones")
        self.D = ini.param((di,), mode="ones")
        self.out_proj = ini.param((di, m.d_model))


def _ssm_inputs(p, m: MambaDims, xc):
    """xc (..., d_inner), the post-conv activations → (Δ, B, C) f32
    (``mamba.py:73``): ``x_proj``, then Δ's ``dt_w`` product and bias in
    the compute dtype, softplus in f32."""
    proj = xc @ p["x_proj"]
    dr, ds = m.dt_rank, m.d_state
    dt = F.softplus((proj[..., :dr] @ p["dt_w"] + p["dt_b"].to(proj.dtype)).float())
    return (dt, proj[..., dr:dr + ds].float().contiguous(),
            proj[..., dr + ds:].float().contiguous())


def _scan(p, dt, xc, bmat, cmat, h0, plain: bool):
    """The recurrence and its ``D`` skip over (B, S, d_inner) inputs."""
    fn = selective_scan_plain if plain else selective_scan
    return fn(dt, xc.contiguous(), bmat, cmat, p["A_log"].float(), p["D"].float(), h0)


def mamba_seq(p, m: MambaDims, x, conv_state0, ssm_state0, *, plain: bool = False):
    """x (B, S, d_model) → (y, (conv tail, final SSM state))
    (``mamba.py:84``), from the carried conv tail (B, d_conv − 1, d_inner)
    and SSM state (B, d_inner, d_state) f32."""
    s = x.shape[1]
    di = m.d_inner
    xz = x @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    # the causal depthwise conv over the carried tail
    xpad = torch.cat([conv_state0.to(xi.dtype), xi], dim=1)
    conv = sum(xpad[:, i:i + s] * p["conv_w"][i].to(xi.dtype) for i in range(m.d_conv))
    xc = F.silu(conv + p["conv_b"].to(xi.dtype))
    del conv
    dt, bmat, cmat = _ssm_inputs(p, m, xc)
    y, h_last = _scan(p, dt, xc, bmat, cmat, ssm_state0, plain)
    y = y.to(x.dtype) * F.silu(z)
    conv_tail = xpad[:, s:] if m.d_conv > 1 else conv_state0
    return y @ p["out_proj"], (conv_tail.to(conv_state0.dtype), h_last)


def mamba_step(p, m: MambaDims, x_t, conv_state, ssm_state, *, plain: bool = False):
    """One-token decode (``mamba.py:123``): x_t (B, d_model), conv_state
    (B, d_conv − 1, d_inner), ssm_state (B, d_inner, d_state) f32 → (y,
    (the new conv state, the new SSM state)); the recurrence at S = 1."""
    di = m.d_inner
    xz = x_t @ p["in_proj"]
    xi, z = xz[..., :di], xz[..., di:]
    window = torch.cat([conv_state.to(xi.dtype), xi[:, None, :]], dim=1)
    conv = torch.einsum("bcd,cd->bd", window, p["conv_w"].to(xi.dtype))
    xc = F.silu(conv + p["conv_b"].to(xi.dtype))
    dt, bmat, cmat = _ssm_inputs(p, m, xc)
    y, h = _scan(p, dt[:, None], xc[:, None], bmat[:, None], cmat[:, None], ssm_state, plain)
    y = y[:, 0].to(x_t.dtype) * F.silu(z)
    return y @ p["out_proj"], (window[:, 1:].to(conv_state.dtype), h)
