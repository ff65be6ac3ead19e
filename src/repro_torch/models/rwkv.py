"""RWKV-6 "Finch" blocks (arXiv:2404.05892) of the port: the time mix,
whose WKV recurrence has a data-dependent decay, and the channel mix.

Port of ``repro.models.rwkv``.  :class:`RWKVTimeMix` and
:class:`RWKVChannelMix` hold the reference's parameters under its names
and shapes (``u`` and ``w0`` stay (d,), cut to (H, K) only at use); the
functions take a dict of (cast) tensors, as the JAX functions take a
pytree.  A layer's decode state is the token-shift buffers (the last
input of each mix, (B, d)) and the WKV matrix state (B, H, K, K) f32:
O(1) in the sequence's length.

Dtypes as the reference's: the token-shift lerps, ``Wr``/``Wk``/``Wv``/
``Wg`` and the channel mix in the compute dtype; the decay's LoRA in f32,
``w = exp(-exp(w0 + tanh(xw·A)·B))``; r, k, v upcast to f32 for the
recurrence, whose y is read from the old state plus the bonus ``u ⊙ k vᵀ``
before the decay updates it; the per-head group norm (eps 64e-5) in f32;
the gated output cast back to the compute dtype before ``Wo``.
:func:`time_mix_seq` takes the shift and the projections for all
positions at once (they depend on the inputs only) and the recurrence in
one call of :func:`repro_torch.kernels.wkv.wkv6` (the kernel on the card,
its plain version on the CPU, or with ``plain`` on any device).

On a mesh (:class:`RWKVTP`) each rank computes its block of the heads:
``Wr``/``Wk``/``Wv``/``Wg`` column-parallel, ``Wo`` row-parallel (summed
over the model axes).  ``w0``, ``wB``'s output, ``u``, ``ln_w`` and ``ln_b``
are labelled ``embed``, which the model axes do not cut: each rank takes
its own heads' columns of them.  Those leaves and ``wA`` (whose product
reaches only this rank's columns) are whole on every rank of the model
axes, so they go through ``copy_to`` first: under autograd each rank's
gradient of them, non-zero in its own heads' columns only (``wA``'s a
partial sum), is summed over those axes, and their replicas stay equal.
In the channel mix ``Wk`` is column-parallel and ``Wv`` row-parallel over
``mlp`` (the product summed over the model axes), while ``sigmoid(xr·Wr)``
comes out cut over ``embed_out``: it is gathered whole before the product
(``gather_from``: its gradient, whole on every rank, cut back to this
rank's block).  Both are the identity forward: serving's bits are those
of the collectives alone.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import collectives as C
from repro_torch.kernels.wkv import wkv6, wkv6_plain

#: the group norm's epsilon (``rwkv.py:50``; the layer norms' is 1e-5)
GN_EPS = 64e-5
#: the time mix's leaves whole on every rank of the model axes whose
#: product reaches this rank's heads only: their gradients summed there
SHARED = ("w0", "wA", "wB", "u", "ln_w", "ln_b")


@dataclasses.dataclass(frozen=True)
class RWKVDims:
    d_model: int
    n_heads: int          # head_size = d_model // n_heads (64 for Finch)
    d_ff: int
    decay_lora: int = 64

    @property
    def head_size(self) -> int:
        return self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class RWKVTP:
    """How the model axes cut an RWKV block on a mesh.  ``axes``: those of
    the time mix's heads (``heads_x``), ``()`` where its weights are
    whole; ``heads``: ``(first, count)`` of this rank's heads (None: all);
    ``mlp_axes``: the channel mix's ``mlp`` cut (``Wk``'s columns, ``Wv``'s
    rows); ``out_axes``: its ``embed_out`` cut (``Wr``'s columns)."""
    axes: tuple = ()
    heads: tuple | None = None
    mlp_axes: tuple = ()
    out_axes: tuple = ()


NO_TP = RWKVTP()


class RWKVTimeMix(nn.Module):
    """``init_rwkv_time_mix`` (``rwkv.py:29``): the five lerp coefficients,
    the decay's LoRA, the bonus, the four projections and ``Wo``, the group
    norm's weight and bias."""

    AXES = {"mu": ("five", "embed"), "w0": ("embed",), "wA": ("embed", "lora"),
            "wB": ("lora", "embed"), "u": ("embed",), "Wr": ("embed", "heads_x"),
            "Wk": ("embed", "heads_x"), "Wv": ("embed", "heads_x"),
            "Wg": ("embed", "heads_x"), "Wo": ("heads_x", "embed"), "ln_w": ("embed",),
            "ln_b": ("embed",)}

    def __init__(self, ini, r: RWKVDims):
        super().__init__()
        d = r.d_model
        self.mu = ini.param((5, d), scale=0.5)
        self.w0 = ini.param((d,), mode="zeros")
        self.wA = ini.param((d, r.decay_lora), scale=0.01)
        self.wB = ini.param((r.decay_lora, d), scale=0.01)
        self.u = ini.param((d,), scale=0.5)
        self.Wr = ini.param((d, d))
        self.Wk = ini.param((d, d))
        self.Wv = ini.param((d, d))
        self.Wg = ini.param((d, d))
        self.Wo = ini.param((d, d))
        self.ln_w = ini.param((d,), mode="ones")
        self.ln_b = ini.param((d,), mode="zeros")


class RWKVChannelMix(nn.Module):
    """``init_rwkv_channel_mix`` (``rwkv.py:106``): two lerp coefficients,
    the squared-ReLU MLP ``Wk``, ``Wv`` and the receptance ``Wr``."""

    AXES = {"mu": ("two", "embed"), "Wk": ("embed", "mlp"), "Wv": ("mlp", "embed"),
            "Wr": ("embed", "embed_out")}

    def __init__(self, ini, r: RWKVDims):
        super().__init__()
        d = r.d_model
        self.mu = ini.param((2, d), scale=0.5)
        self.Wk = ini.param((d, r.d_ff))
        self.Wv = ini.param((r.d_ff, d))
        self.Wr = ini.param((d, d))


def group_norm(x, w, b, n_heads: int, eps: float = GN_EPS):
    """Per-head LayerNorm of x (..., D) in f32 (RWKV's ``ln_x``,
    ``rwkv.py:50``); returns f32."""
    shape = x.shape
    x = x.reshape(shape[:-1] + (n_heads, -1)).float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return x.reshape(shape) * w.float() + b.float()


def _lerps(mu, x, x_prev, n: int) -> list:
    """The ``n`` token-shift streams ``x_prev + mu[i] (x - x_prev)`` in x's dtype."""
    mu = mu.to(x.dtype)
    return [x_prev + mu[i] * (x - x_prev) for i in range(n)]


def _shifted(x, x_prev0):
    """x (B, S, D) shifted one position later, ``x_prev0`` (B, D) first."""
    return torch.cat([x_prev0[:, None, :], x[:, :-1, :]], dim=1)


def _heads(r: RWKVDims, tp: RWKVTP) -> tuple:
    """(first, count) of the heads this rank computes."""
    return tp.heads if tp.heads is not None else (0, r.n_heads)


def row_parallel(x, w, axes):
    """``x @ w`` summed over ``axes``: the row-parallel product, each rank
    its rows of ``w`` and ``x``'s matching columns."""
    return C.reduce_from(x @ w, axes)


def decay(p, xw, cols: slice):
    """The data-dependent decay of the columns ``cols`` in f32:
    ``exp(-exp(w0 + tanh(xw·wA)·wB))`` (``rwkv.py:73–76``)."""
    ww = p["w0"][cols].float() + torch.tanh(xw.float() @ p["wA"].float()) \
        @ p["wB"][:, cols].float()
    return torch.exp(-torch.exp(ww))


def _time_mix(p, r: RWKVDims, xs: list, state, tp: RWKVTP, plain: bool):
    """The time mix of the five lerped streams ``xs`` (each (B, S, D)) from
    the WKV ``state`` (B, H_local, K, K): the projections of this rank's
    heads, the recurrence, the group norm, the gate and ``Wo`` (summed over
    ``tp.axes``).  Returns (out (B, S, D), new state)."""
    xr, xk, xv, xw, xg = (C.copy_to(x, tp.axes) for x in xs)
    if tp.axes:
        p = dict(p, **dict(zip(SHARED, C.copy_to_packed([p[n] for n in SHARED], tp.axes))))
    b, s = xr.shape[:2]
    h0, hl = _heads(r, tp)
    hs = r.head_size
    cols = slice(h0 * hs, (h0 + hl) * hs)
    rt = (xr @ p["Wr"]).reshape(b, s, hl, hs)
    kt = (xk @ p["Wk"]).reshape(b, s, hl, hs)
    vt = (xv @ p["Wv"]).reshape(b, s, hl, hs)
    gt = F.silu(xg @ p["Wg"])
    w = decay(p, xw, cols).reshape(b, s, hl, hs)
    u = p["u"][cols].float().reshape(hl, hs)
    y, state = (wkv6_plain if plain else wkv6)(rt, kt, vt, w, u, state)
    y = group_norm(y.reshape(b, s, hl * hs), p["ln_w"][cols], p["ln_b"][cols], hl)
    y = (y * gt.float()).to(xr.dtype)
    return row_parallel(y, p["Wo"], tp.axes), state


def time_mix_seq(p, r: RWKVDims, x, x_prev0, state0, *, tp: RWKVTP = NO_TP,
                 plain: bool = False):
    """The time mix over x (B, S, D) from the shift buffer ``x_prev0`` (B,
    D) and the WKV state ``state0`` (``rwkv.py:90``).  Returns (y, (x_last,
    state))."""
    xs = _lerps(p["mu"], x, _shifted(x, x_prev0), 5)
    y, state = _time_mix(p, r, xs, state0, tp, plain)
    return y, (x[:, -1], state)


def time_mix_step(p, r: RWKVDims, x_t, x_prev, state, *, tp: RWKVTP = NO_TP,
                  plain: bool = False):
    """One token x_t (B, D) (``rwkv.py:61``): the recurrence at S = 1.
    Returns (y (B, D), new state)."""
    xs = [x[:, None] for x in _lerps(p["mu"], x_t, x_prev, 5)]
    y, state = _time_mix(p, r, xs, state, tp, plain)
    return y[:, 0], state


def _channel_mix(p, xk, xr, tp: RWKVTP):
    """``sigmoid(xr·Wr) ⊙ (relu(xk·Wk)²·Wv)`` in the compute dtype; on a mesh
    the product's second factor summed over ``tp.mlp_axes`` and the first
    gathered over ``tp.out_axes``."""
    k = torch.square(F.relu(C.copy_to(xk, tp.mlp_axes) @ p["Wk"]))
    kv = row_parallel(k, p["Wv"], tp.mlp_axes)
    rr = torch.sigmoid(C.copy_to(xr, tp.out_axes) @ p["Wr"])
    return C.gather_from(rr, tp.out_axes, dim=-1) * kv


def channel_mix_seq(p, x, x_prev0, *, tp: RWKVTP = NO_TP):
    """The token-shifted squared-ReLU channel mix of x (B, S, D)
    (``rwkv.py:116``).  Returns (out, x_last)."""
    xk, xr = _lerps(p["mu"], x, _shifted(x, x_prev0), 2)
    return _channel_mix(p, xk, xr, tp), x[:, -1]


def channel_mix_step(p, x_t, x_prev, *, tp: RWKVTP = NO_TP):
    """One token x_t (B, D) (``rwkv.py:126``).  Returns (out, x_t)."""
    xk, xr = _lerps(p["mu"], x_t, x_prev, 2)
    return _channel_mix(p, xk, xr, tp), x_t
